"""The ``Workload`` layer: one model interface for the whole design space
(DESIGN.md §11).

The engine and the algorithms program against a small duck-typed model
surface -- ``init``/``grad``/``eval_loss`` plus the ``convex`` and
``flops_per_row`` metadata.  Two families implement it:

- a study name (``"lr"``, ``"svm"``, ``"kmeans"``, ``"mobilenet"``,
  ``"resnet50"``) gives the paper's stand-in
  (:class:`repro_torch.core.mlmodels.StudyModel`);
- an architecture name (``"smollm_360m"``, ``"mamba2_370m"``, ... -- the
  model zoo) gives an :class:`ArchWorkload`: the port's functional model
  (:func:`repro_torch.models.transformer.loss_fn`), its autograd
  gradient, and the deterministic token corpus
  (:class:`repro_torch.data.tokens.TokenStream`).

An architecture's parameters are ONE flat tensor in the config's dtype, in
the JAX package's ``ravel_pytree`` order (dict keys sorted at every level,
each stacked ``(L, ...)`` leaf raveled row-major), so the engine, the
algorithms, the comm stack and the codecs take it as they take a study
model's, and the int8 codec's 256-element blocks cover the same elements
as the reference's.  Encoder and VLM archs need non-token inputs and
raise as in the JAX package.  On the card, the gradients of attention
(MLA's dk 192 / dv 128 included) and of the SSD scan come from their CUDA
backward kernels, so the dense, moe, ssm and hybrid families all train
there.

This module also gives the two analytic sizes the §5.3 cost model and
spec-time validation need.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs import (
    ARCH_IDS, arch_key, get_arch, get_reduced, spec_name,
)
from repro_torch.core.mlmodels import STUDY_MODELS, _mlp_sizes, make_study_model
from repro_torch.data.synthetic import Dataset, make_dataset, train_val_split
from repro_torch.data.tokens import TokenStream
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (
    DTYPES, init_params, is_spec, param_count, tree_map,
)

#: architecture workloads train on the synthetic LM corpus, not on the
#: paper's feature datasets
TOKEN_DATASET = "tokens"

#: default sequence length for arch workloads -- one data "row" is one
#: training sequence of this many tokens
DEFAULT_SEQ_LEN = 64

#: rows of the validation set :meth:`ArchWorkload.eval_loss` reads
EVAL_ROWS = 512

#: the architecture ids of the port's config registry, as spec-friendly
#: model names
ARCH_NAMES = tuple(spec_name(a) for a in ARCH_IDS)


def is_arch_workload(name: str) -> bool:
    return name in ARCH_NAMES


def _lm_arch(name: str) -> bool:
    cfg = get_arch(arch_key(name)).model
    return cfg.family not in ("encoder", "vlm") and not cfg.is_encoder


def check_pairing(name: str, dataset: str) -> None:
    """Raise unless model ``name`` can train on ``dataset``: architectures
    on the LM corpus, study stand-ins on a feature dataset.  Encoder/VLM
    names raise ``ValueError`` at construction, as in the JAX package."""
    if is_arch_workload(name):
        if dataset != TOKEN_DATASET:
            raise ValueError(
                f"architecture workload {name!r} trains on the synthetic "
                f"LM corpus; set dataset={TOKEN_DATASET!r} "
                f"(got {dataset!r})")
    elif dataset == TOKEN_DATASET:
        raise ValueError(
            f"dataset={TOKEN_DATASET!r} is the architecture workloads' "
            f"corpus; model {name!r} is a study stand-in -- pick one of the "
            f"feature datasets (higgs, rcv1, ...)")


def update_vector_bytes(workload, params=None) -> int:
    """Bytes of the flat fp32 parameter-shaped update vector one worker
    ships per round -- the ``m`` of the analytical model (4 bytes per
    parameter whatever the model dtype: the wire is fp32; EM k-means ships
    ``k`` floats more)."""
    if params is None:
        params = workload.init(torch.Generator().manual_seed(0))
    return int(params.numel()) * 4


#: static (feature_dim, n_classes) per study dataset -- the spec-time size
#: estimator's view of repro_torch.data.synthetic.make_dataset
_DATASET_SHAPES = {"higgs": (28, 2), "rcv1": (47_236, 2),
                   "cifar10": (3072, 10), "yfcc100m": (4096, 2),
                   "criteo": (1_000_000, 2)}


def _arch_config(name: str, reduced: bool):
    arch_id = arch_key(name)
    return get_reduced(arch_id) if reduced else get_arch(arch_id)


def estimate_update_bytes(model: str, dataset: str = "higgs",
                          model_args: dict | None = None) -> int | None:
    """fp32 update-vector bytes one worker ships per metered reduce,
    WITHOUT materializing data or parameters -- what spec-time comm
    validation checks against transport per-item limits (the DynamoDB
    400 KB rule of Table 1).  ``None`` when not statically known."""
    model_args = dict(model_args or {})
    if is_arch_workload(model):
        arch = _arch_config(model, bool(model_args.get("reduced", True)))
        return param_count(tfm.model_spec(arch.model)) * 4
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


# ---------------------------------------------------------- arch workloads --

def ravel_layout(spec, path=()):
    """``[(path, shape), ...]`` of a spec tree in ``ravel_pytree`` order:
    dict keys sorted at every level."""
    if is_spec(spec):
        return [(path, spec[0])]
    return [leaf for k in sorted(spec) for leaf in
            ravel_layout(spec[k], path + (k,))]


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class ArchWorkload:
    """A model-zoo architecture as an engine workload.

    ``grad`` is the autograd gradient of the model's next-token loss
    (:func:`repro_torch.models.transformer.loss_fn`), so every simulated
    round runs genuine forward/backward numerics.  Batches arrive in the
    engine's ``{"x", "y"}`` convention (int32 token / label matrices, one
    row = one sequence).  ``reduced=True`` (default) uses the arch's
    CPU-sized ``reduced()`` variant; ``reduced=False`` builds the published
    config (same code path, only the shapes change).  ``flops_per_row`` is
    the ``6 * n_params * seq_len`` training-FLOPs estimate, which is what
    the platforms' FLOP/s hooks divide.  The parameters are one flat tensor
    (see the module docstring); ``grad`` views it as the parameter dict.
    """

    convex = False

    def __init__(self, name: str, *, reduced: bool = True,
                 seq_len: int = DEFAULT_SEQ_LEN):
        if not is_arch_workload(name):
            raise KeyError(f"unknown architecture workload {name!r}")
        self.name = name
        self.seq_len = int(seq_len)
        self.arch = _arch_config(name, reduced)
        cfg = self.cfg = self.arch.model
        if cfg.is_encoder or cfg.family == "vlm":
            raise ValueError(
                f"arch workload {name!r}: encoder/VLM batches need "
                "frames/images; only LM-style archs run through the engine")
        self.spec = tfm.model_spec(cfg)
        self.layout = ravel_layout(self.spec)
        self.n_params = param_count(self.spec)
        self.flops_per_row = 6.0 * self.n_params * self.seq_len
        self.dtype = DTYPES[cfg.dtype]

    # ---- the flat parameter tensor ----
    def _views(self, flat: torch.Tensor):
        """The parameter dict over ``flat`` and its leaves in ``layout``
        order (views, no copies).  -> (tree, leaves)."""
        tree: dict = {}
        leaves = []
        off = 0
        for path, shape in self.layout:
            n = math.prod(shape)
            leaf = flat[off:off + n].view(shape)
            off += n
            leaves.append(leaf)
            _put(tree, path, leaf)
        return tree, leaves

    def params(self, flat: torch.Tensor) -> dict:
        """The parameter dict the model takes, as views of ``flat``."""
        return self._views(flat)[0]

    def flatten(self, tree: dict) -> torch.Tensor:
        """A parameter dict (the port's keys and shapes) as the flat
        tensor, in ``ravel_pytree`` order and the config's dtype."""
        parts = []
        for path, shape in self.layout:
            leaf = tree
            for k in path:
                leaf = leaf[k]
            if tuple(leaf.shape) != shape:
                raise ValueError(f"{'/'.join(path)}: shape "
                                 f"{tuple(leaf.shape)}, the spec wants "
                                 f"{shape}")
            parts.append(leaf.reshape(-1).to(self.dtype))
        return torch.cat(parts)

    def init(self, gen: torch.Generator) -> torch.Tensor:
        """Seeded parameters on the CPU (the engine moves them): the model
        zoo's init rule drawn from ``gen``, flattened."""
        with torch.no_grad():
            return self.flatten(init_params(gen, self.spec, self.cfg.dtype))

    # ---- numerics ----
    def _loss(self, tree, batch) -> torch.Tensor:
        loss, _metrics = tfm.loss_fn(
            tree, {"tokens": batch["x"], "labels": batch["y"]}, self.cfg)
        return loss

    def grad(self, params: torch.Tensor, batch: dict):
        """-> (loss, flat gradient in the params' dtype), by
        :func:`repro_torch.models.transformer.value_and_grad` over views of
        the flat parameters, accumulating into views of one zeroed flat
        gradient: at its peak the call holds the parameters, one gradient
        and the activations."""
        flat = params.detach()
        g = torch.zeros_like(flat)
        loss, _ = tfm.value_and_grad(
            self.params(flat), {"tokens": batch["x"], "labels": batch["y"]},
            self.cfg, grads=self.params(g))
        return loss, g

    @torch.no_grad()
    def eval_loss(self, params: torch.Tensor, data: dict,
                  max_rows: int = EVAL_ROWS) -> float:
        n = min(int(data["x"].shape[0]), max_rows)
        return float(self._loss(self.params(params),
                                {"x": data["x"][:n], "y": data["y"][:n]}))

    def make_data(self, rows: int, seed: int = 0) -> Dataset:
        """Deterministic LM corpus: ``rows`` sequences of ``seq_len`` tokens
        (x) with next-token labels (y), from the Zipf+bigram TokenStream."""
        b = TokenStream(self.cfg.vocab_size, seed).batch(rows, self.seq_len)
        return Dataset(TOKEN_DATASET, b["tokens"], b["labels"],
                       n_classes=self.cfg.vocab_size)


def flat_from_numpy(tree: dict, workload: ArchWorkload) -> torch.Tensor:
    """The JAX package's parameter tree (nested dicts of numpy arrays, its
    keys, stacked ``(L, ...)`` leaves) as ``workload``'s flat tensor, on the
    CPU -- how parity tests give both packages one starting point."""
    return workload.flatten(tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), tree))


# ---------------------------------------------------------------- factory ---

def make_workload(name: str, *, dataset: str = "higgs", rows: int = 30_000,
                  data_seed: int = 0, val_frac: float = 0.1, **model_args):
    """Build ``(workload, ds_train, ds_val)`` for any point of the model
    axis, in the JAX package's construction order (study: dataset -> split
    -> model-on-train; architecture: model -> corpus -> split), so the
    datasets are byte-identical to the reference's.  Architecture names
    require ``dataset="tokens"`` and accept ``reduced``/``seq_len``."""
    check_pairing(name, dataset)
    if is_arch_workload(name):
        wl = ArchWorkload(name, **model_args)
        ds = wl.make_data(rows, seed=data_seed)
        tr, va = train_val_split(ds, val_frac=val_frac)
        return wl, tr, va
    ds = make_dataset(dataset, rows=rows, seed=data_seed)
    tr, va = train_val_split(ds, val_frac=val_frac)
    return make_study_model(name, tr, **model_args), tr, va


def list_workloads() -> list[str]:
    """Every valid ``ExperimentSpec.model`` value (study stand-ins + the
    LM-style architectures; encoder/VLM archs need non-token inputs and are
    excluded)."""
    archs = sorted(n for n in ARCH_NAMES if _lm_arch(n))
    return list(STUDY_MODELS) + archs
