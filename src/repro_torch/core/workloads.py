"""The ``Workload`` layer, study half (DESIGN.md §11).

The engine and the algorithms program against a small duck-typed model
surface -- ``init``/``grad``/``eval_loss`` plus the ``convex`` and
``flops_per_row`` metadata -- which the paper's study stand-ins
(:class:`repro_torch.core.mlmodels.StudyModel`) satisfy.  This module
builds ``(workload, ds_train, ds_val)`` for a study name and gives the two
analytic sizes the §5.3 cost model and spec-time validation need.

Training the architecture workloads (``smollm_360m``, ``mamba2_370m``, ...
-- the model zoo) is ROADMAP.md queue A6: their names raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ARCH_IDS, spec_name
from repro_torch.core.mlmodels import STUDY_MODELS, _mlp_sizes, make_study_model
from repro_torch.data.synthetic import make_dataset, train_val_split

#: architecture workloads train on the synthetic LM corpus, not on the
#: paper's feature datasets
TOKEN_DATASET = "tokens"

#: the architecture ids of the port's config registry, as spec-friendly
#: model names
ARCH_NAMES = tuple(spec_name(a) for a in ARCH_IDS)


def is_arch_workload(name: str) -> bool:
    return name in ARCH_NAMES


def check_study_workload(name: str) -> None:
    if is_arch_workload(name):
        raise NotImplementedError(
            f"model {name!r} is an architecture workload; the PyTorch port "
            f"trains the study models {', '.join(STUDY_MODELS)} only -- "
            f"training the model zoo is ROADMAP.md queue A6")


def update_vector_bytes(workload, params=None) -> int:
    """Bytes of the flat fp32 parameter-shaped update vector one worker
    ships per round -- the ``m`` of the analytical model (4 bytes per
    parameter; EM k-means ships ``k`` floats more)."""
    if params is None:
        params = workload.init(torch.Generator().manual_seed(0))
    return int(params.numel()) * 4


#: static (feature_dim, n_classes) per study dataset -- the spec-time size
#: estimator's view of repro_torch.data.synthetic.make_dataset
_DATASET_SHAPES = {"higgs": (28, 2), "rcv1": (47_236, 2),
                   "cifar10": (3072, 10), "yfcc100m": (4096, 2),
                   "criteo": (1_000_000, 2)}


def estimate_update_bytes(model: str, dataset: str = "higgs",
                          model_args: dict | None = None) -> int | None:
    """fp32 update-vector bytes one worker ships per metered reduce,
    WITHOUT materializing data or parameters -- what spec-time comm
    validation checks against transport per-item limits (the DynamoDB
    400 KB rule of Table 1).  ``None`` when not statically known."""
    model_args = dict(model_args or {})
    if dataset not in _DATASET_SHAPES:
        return None
    d, n_classes = _DATASET_SHAPES[dataset]
    if model in ("lr", "svm"):
        return d * 4
    if model == "kmeans":
        k = int(model_args.get("k", 10))
        # EM ships sums (k*d) + counts (k) + sse (1), see update_vector_bytes
        return (k * d + k + 1) * 4
    if model in ("mobilenet", "resnet50"):
        target_mb = 12.0 if model == "mobilenet" else 89.0
        sizes = _mlp_sizes(d, n_classes, target_mb)
        return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:])) * 4
    return None


def make_workload(name: str, *, dataset: str = "higgs", rows: int = 30_000,
                  data_seed: int = 0, val_frac: float = 0.1, **model_args):
    """Build ``(workload, ds_train, ds_val)`` for a study model name, in the
    JAX package's construction order (dataset -> split -> model-on-train),
    so the datasets are byte-identical to the reference's."""
    check_study_workload(name)
    ds = make_dataset(dataset, rows=rows, seed=data_seed)
    tr, va = train_val_split(ds, val_frac=val_frac)
    return make_study_model(name, tr, **model_args), tr, va
