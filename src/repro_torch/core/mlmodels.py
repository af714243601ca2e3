"""The paper's study models in PyTorch: LR, SVM, k-means, and MLP stand-ins
sized to MobileNet (12 MB) / ResNet50 (89 MB) parameter footprints.

All share one functional interface, used by every platform (paper
principle: *same algorithm both sides*).  Parameters are ONE fp32 tensor
per model -- ``(d,)`` for LR/SVM, ``(k, d)`` centroids for k-means, and the
flat vector for the MLPs -- laid out exactly as the JAX package's
``ravel_pytree`` flattens its parameter pytree: for the MLP that is
``w0.ravel(), b0, w1.ravel(), b1, ...`` with every ``w`` stored
``(in, out)`` and applied as ``x @ w + b``.  Keeping that order keeps the
256-element quantization blocks of the wire codecs over the same elements
as the reference's.

    init(generator)                -> params on the CPU (engine moves them)
    grad(params, batch)            -> (loss, grad shaped like params)
    local_stats(params, batch)     -> stats                   # k-means
    apply_stats(params, stats)     -> params
    eval_loss(params, data)        -> float

Batches and evaluation data are dicts of tensors on the engine's device
(``{"x", "y"[, "idx"]}``, see :func:`device_data`); gradients are plain
autograd.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.data.synthetic import Dataset

L2 = 1e-4


def device_data(ds: Dataset, device, lo: int = 0,
                hi: int | None = None) -> dict:
    """Rows ``[lo, hi)`` of ``ds`` as tensors on ``device`` -- done once per
    worker partition and once for the validation set, never per batch."""
    hi = ds.n if hi is None else hi
    b = {"x": torch.from_numpy(np.ascontiguousarray(ds.x[lo:hi])).to(device),
         "y": torch.from_numpy(np.ascontiguousarray(ds.y[lo:hi])).to(device)}
    if ds.sparse:
        b["idx"] = torch.from_numpy(
            ds.idx[lo:hi].astype(np.int64)).to(device)
    return b


def rows(data: dict, lo: int, hi: int) -> dict:
    """A row slice (views, no copy) of a device data dict."""
    return {k: v[lo:hi] for k, v in data.items()}


def n_rows(data: dict) -> int:
    return int(data["x"].shape[0])


def _value_and_grad(loss_fn: Callable) -> Callable:
    def grad(params, batch):
        p = params.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(p, batch)
            (g,) = torch.autograd.grad(loss, p)
        return loss.detach(), g
    return grad


class LinearScores(nn.Module):
    """``x . w`` for dense rows, or the gather form for sparse
    ``(idx, values)`` rows (how LambdaML's sparse LR works)."""

    def forward(self, w: torch.Tensor, batch: dict) -> torch.Tensor:
        if "idx" in batch:
            return torch.sum(batch["x"] * w[batch["idx"]], dim=1)
        return batch["x"] @ w


@dataclass(frozen=True)
class StudyModel:
    name: str
    init: Callable
    grad: Optional[Callable] = None
    eval_loss: Optional[Callable] = None
    local_stats: Optional[Callable] = None
    apply_stats: Optional[Callable] = None
    convex: bool = True
    flops_per_row: float = 0.0  # analytic compute model (per data row)
    param_shape: tuple = ()     # the one parameter tensor's shape


def _eval_rows(data: dict, max_rows: int) -> dict:
    return rows(data, 0, min(n_rows(data), max_rows))


# ------------------------------------------------------------------ LR -------

def make_lr(ds: Dataset) -> StudyModel:
    d = ds.d
    scores = LinearScores()

    def init(generator):
        return torch.zeros((d,), dtype=torch.float32)

    def loss_fn(w, batch):
        z = scores(w, batch) * batch["y"]
        # paper reports plain logistic loss; L2 only regularizes the grad path
        return (torch.mean(torch.logaddexp(z.new_zeros(()), -z))
                + 0.5 * L2 * torch.sum(w * w))

    @torch.no_grad()
    def eval_loss(w, data: dict, max_rows: int = 50_000):
        b = _eval_rows(data, max_rows)
        z = scores(w, b) * b["y"]
        return float(torch.mean(torch.logaddexp(z.new_zeros(()), -z)))

    nnz = ds.x.shape[1] if ds.sparse else d
    return StudyModel("lr", init, _value_and_grad(loss_fn), eval_loss,
                      convex=True, flops_per_row=4.0 * nnz, param_shape=(d,))


# ------------------------------------------------------------------ SVM ------

def make_svm(ds: Dataset) -> StudyModel:
    d = ds.d
    scores = LinearScores()

    def init(generator):
        return torch.zeros((d,), dtype=torch.float32)

    def hinge(z):
        # torch.maximum splits the gradient at ties like jnp.maximum
        return torch.maximum(z.new_zeros(()), 1.0 - z)

    def loss_fn(w, batch):
        z = scores(w, batch) * batch["y"]
        return torch.mean(hinge(z)) + 0.5 * L2 * torch.sum(w * w)

    @torch.no_grad()
    def eval_loss(w, data: dict, max_rows: int = 50_000):
        b = _eval_rows(data, max_rows)
        return float(torch.mean(hinge(scores(w, b) * b["y"])))

    nnz = ds.x.shape[1] if ds.sparse else d
    return StudyModel("svm", init, _value_and_grad(loss_fn), eval_loss,
                      convex=True, flops_per_row=4.0 * nnz, param_shape=(d,))


# --------------------------------------------------------------- k-means -----

def make_kmeans(ds: Dataset, k: int = 10) -> StudyModel:
    d = ds.d
    if ds.sparse:
        raise ValueError("kmeans study model requires dense features")

    def init(generator):
        i = torch.randperm(ds.n, generator=generator)[:k].numpy()
        return torch.from_numpy(np.ascontiguousarray(ds.x[i]))

    @torch.no_grad()
    def local_stats(centers, batch):
        x = batch["x"]
        d2 = (torch.sum(x * x, 1)[:, None] - 2 * x @ centers.T
              + torch.sum(centers * centers, 1)[None, :])
        a = torch.argmin(d2, dim=1)
        one = F.one_hot(a, k).to(torch.float32)
        return {"sums": one.T @ x, "counts": one.sum(0),
                "sse": torch.sum(torch.min(d2, dim=1).values)}

    @torch.no_grad()
    def apply_stats(centers, stats):
        c = stats["counts"][:, None]
        return torch.where(c > 0, stats["sums"] / c.clamp_min(1.0), centers)

    def eval_loss(centers, data: dict, max_rows: int = 50_000):
        b = _eval_rows(data, max_rows)
        s = local_stats(centers, b)
        return float(s["sse"] / n_rows(b))

    return StudyModel("kmeans", init, local_stats=local_stats,
                      apply_stats=apply_stats, eval_loss=eval_loss,
                      convex=False, flops_per_row=3.0 * d * k,
                      param_shape=(k, d))


# ------------------------------------------------ NN stand-ins (MN / RN) -----

def _mlp_sizes(d_in: int, n_out: int, target_mb: float):
    """Pick one hidden width so total fp32 params ~= target_mb."""
    target = target_mb * 1e6 / 4.0
    # params ~ d_in*h + h*h + h*n_out
    a, b, c = 1.0, d_in + n_out, -target
    h = int((-b + (b * b - 4 * a * c) ** 0.5) / 2)
    return (d_in, h, h, n_out)


class MLP(nn.Module):
    """ReLU MLP over a flat parameter vector in the JAX package's
    ``ravel_pytree`` order (``w0 (in, out), b0, w1, b1, ...``)."""

    def __init__(self, sizes):
        super().__init__()
        self.sizes = tuple(int(s) for s in sizes)
        self.numels = []
        for a, b in zip(self.sizes[:-1], self.sizes[1:]):
            self.numels += [a * b, b]

    @property
    def n_params(self) -> int:
        return sum(self.numels)

    def layers(self, flat: torch.Tensor):
        parts = flat.split(self.numels)
        return [(parts[2 * i].view(a, b), parts[2 * i + 1])
                for i, (a, b) in enumerate(zip(self.sizes[:-1],
                                               self.sizes[1:]))]

    def forward(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        layers = self.layers(flat)
        for i, (w, b) in enumerate(layers):
            x = x @ w + b
            if i < len(layers) - 1:
                x = torch.relu(x)
        return x


def make_mlp(ds: Dataset, target_mb: float, name: str) -> StudyModel:
    """MobileNet-12MB / ResNet50-89MB stand-ins (see DESIGN.md §3: the
    paper's CNNs are stand-ins sized by parameter bytes, which is what
    drives the communication study)."""
    net = MLP(_mlp_sizes(ds.d, ds.n_classes, target_mb))
    sizes = net.sizes

    def init(generator):
        leaves = []
        for a, b in zip(sizes[:-1], sizes[1:]):
            w = torch.randn((a, b), generator=generator) * (2.0 / a) ** 0.5
            leaves += [w.reshape(-1), torch.zeros((b,))]
        return torch.cat(leaves)

    def loss_fn(params, batch):
        logits = net(params, batch["x"])
        y = batch["y"].to(torch.int64)
        if ds.n_classes == 2:
            y = torch.div(y + 1, 2, rounding_mode="floor")  # {-1,1} -> {0,1}
            if logits.shape[-1] == 1:
                logits = torch.stack(
                    [torch.zeros_like(logits[:, 0]), logits[:, 0]], 1)
        logp = F.log_softmax(logits, dim=-1)
        return -torch.mean(logp.gather(1, y[:, None])[:, 0])

    @torch.no_grad()
    def eval_loss(params, data: dict, max_rows: int = 20_000):
        return float(loss_fn(params, _eval_rows(data, max_rows)))

    flops = 6.0 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return StudyModel(name, init, _value_and_grad(loss_fn), eval_loss,
                      convex=False, flops_per_row=flops,
                      param_shape=(net.n_params,))


def model_bytes(params: torch.Tensor) -> int:
    return params.numel() * params.element_size()


def params_from_numpy(model: StudyModel, leaves) -> torch.Tensor:
    """The JAX package's parameter leaves (numpy, in ``ravel_pytree``
    order) as this port's parameter tensor -- how the parity tests give
    both packages one starting point (their random inits cannot agree)."""
    flat = np.concatenate([np.asarray(leaf, np.float32).reshape(-1)
                           for leaf in leaves])
    want = int(np.prod(model.param_shape))
    if flat.size != want:
        raise ValueError(f"{model.name}: {flat.size} parameters given, the "
                         f"model has {want} {model.param_shape}")
    return torch.from_numpy(flat).reshape(model.param_shape)


#: the paper's study stand-ins (the "model" axis values this module serves)
STUDY_MODELS = ("lr", "svm", "kmeans", "mobilenet", "resnet50")


def make_study_model(name: str, ds: Dataset, **kw) -> StudyModel:
    if name == "lr":
        return make_lr(ds)
    if name == "svm":
        return make_svm(ds)
    if name == "kmeans":
        return make_kmeans(ds, **kw)
    if name == "mobilenet":
        return make_mlp(ds, 12.0, "mobilenet")
    if name == "resnet50":
        return make_mlp(ds, 89.0, "resnet50")
    raise KeyError(name)
