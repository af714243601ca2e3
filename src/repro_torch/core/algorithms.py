"""Distributed optimization algorithms of the study (§3.2.1, §4.2):
GA-SGD, MA-SGD, consensus ADMM (convex models), EM k-means.

Each algorithm is a pure strategy object: the SAME implementation runs under
every platform (paper principle 1), which only differ in how they time and
merge the flat update vectors.  Update vectors are flat fp32 tensors on the
engine's device, in the JAX package's ``ravel_pytree`` order (the
parameter tensor's own row-major order, see :mod:`.mlmodels`).  Each
worker's data partition moves to the device once, in :meth:`init_worker`;
rounds slice it there.  Parameters are only ever replaced, never updated in
place, so worker states may share one tensor.

Update vectors are fp32, as the JAX package ravels them (``np.float32``):
:func:`wire` casts an update to the wire.  Every assignment back to
parameters goes through :func:`unravel`, which keeps the vector's dtype as
the JAX ``unravel`` of a single-dtype tree does: a bfloat16 architecture's
parameters (the config's dtype) become fp32 at their first merge, in both
packages, and local steps before it stay bfloat16.  Both are free for fp32
study models.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.core.mlmodels import StudyModel, device_data, rows
from repro_torch.data.synthetic import Dataset


def wire(x: torch.Tensor) -> torch.Tensor:
    """A parameter-shaped tensor as a flat fp32 update vector."""
    return x.reshape(-1).to(torch.float32)


def unravel(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``flat`` as parameters of ``like``'s shape, in ``flat``'s dtype (the
    JAX ``unravel`` of a single-dtype tree splits and reshapes, and casts
    nothing); ``like`` may be a meta tensor."""
    return flat.reshape(like.shape)


def _batches(st: "WorkerState", batch_size: int):
    n = st.part.n
    for lo in range(0, n, batch_size):
        yield rows(st.data, lo, min(lo + batch_size, n))


@dataclass
class WorkerState:
    part: Dataset
    params: Any
    data: dict = field(default_factory=dict)   # the partition, on device
    extra: dict = field(default_factory=dict)

    @property
    def flat(self) -> torch.Tensor:
        return self.params.reshape(-1)


class Algorithm:
    name = "base"
    convex_only = False
    #: True when local_update returns an additive update vector (a gradient)
    #: that can be accumulated across rounds and applied to older params --
    #: the contract repro_torch.core.sync.LocalSGD builds on.  MA/ADMM/EM
    #: ship full params / statistics instead.
    additive_update = False

    def __init__(self, lr: float = 0.1, batch_size: int = 4096):
        self.lr = lr
        self.batch_size = batch_size

    def init_worker(self, model: StudyModel, params, part: Dataset) -> WorkerState:
        return WorkerState(part, params, device_data(part, params.device))

    def rounds_per_epoch(self, part: Dataset) -> int:
        raise NotImplementedError

    def rows_per_round(self, part: Dataset) -> int:
        raise NotImplementedError

    def local_update(self, model, st: WorkerState, rnd: int) -> torch.Tensor:
        raise NotImplementedError

    def apply_merged(self, model, st: WorkerState, merged: torch.Tensor,
                     w: int):
        raise NotImplementedError

    def eval_params(self, st: WorkerState):
        return st.params


class GASGD(Algorithm):
    """Gradient averaging: sync every mini-batch."""
    name = "ga_sgd"
    additive_update = True

    def rounds_per_epoch(self, part):
        return max(1, -(-part.n // self.batch_size))

    def rows_per_round(self, part):
        return min(self.batch_size, part.n)

    def local_update(self, model, st, rnd):
        n = st.part.n
        bs = min(self.batch_size, n)
        lo = (rnd * bs) % max(n - bs + 1, 1)
        _, g = model.grad(st.params, rows(st.data, lo, lo + bs))
        return wire(g)

    def apply_merged(self, model, st, merged, w):
        st.params = unravel(st.flat - self.lr * merged, st.params)


class MASGD(Algorithm):
    """Model averaging: local SGD for `local_epochs`, then average params
    every round (the merge pattern does the averaging).  The generalized
    form is the :class:`repro_torch.core.sync.LocalSGD` protocol."""
    name = "ma_sgd"

    def __init__(self, lr=0.1, batch_size=4096, local_epochs: int = 1):
        super().__init__(lr, batch_size)
        self.local_epochs = local_epochs

    def rounds_per_epoch(self, part):
        return 1  # one sync per local_epochs epochs; epoch accounting below

    def rows_per_round(self, part):
        return part.n * self.local_epochs

    def local_update(self, model, st, rnd):
        params = st.params
        for _ in range(self.local_epochs):
            for b in _batches(st, self.batch_size):
                _, g = model.grad(params, b)
                params = params - self.lr * g
        st.params = params
        return wire(params)

    def apply_merged(self, model, st, merged, w):
        st.params = unravel(merged, st.params)


class ADMM(Algorithm):
    """Consensus ADMM (Boyd et al.): x-update via `local_epochs` SGD epochs on
    the augmented Lagrangian, z-update in closed form for L2, dual ascent.
    Convex models only (the paper shows it fails for NNs, §4.2)."""
    name = "admm"
    convex_only = True

    def __init__(self, lr=0.05, batch_size=4096, rho: float = 0.01,
                 local_epochs: int = 10, l2: float = 1e-4):
        super().__init__(lr, batch_size)
        self.rho = rho
        self.local_epochs = local_epochs
        self.l2 = l2

    def rounds_per_epoch(self, part):
        return 1

    def rows_per_round(self, part):
        return part.n * self.local_epochs

    def init_worker(self, model, params, part):
        st = super().init_worker(model, params, part)
        flat = wire(st.params)
        st.extra["x"] = flat.clone()
        st.extra["u"] = torch.zeros_like(flat)
        st.extra["z"] = flat.clone()
        return st

    def local_update(self, model, st, rnd):
        x = st.extra["x"]
        zu = st.extra["z"] - st.extra["u"]
        rho = self.rho
        for _ in range(self.local_epochs):
            for b in _batches(st, self.batch_size):
                _, g = model.grad(unravel(x, st.params), b)
                g = wire(g) + rho * (x - zu)
                x = x - self.lr * g
        st.extra["x"] = x
        return st.extra["x"] + st.extra["u"]

    def apply_merged(self, model, st, merged, w):
        # merged = avg(x_i + u_i); z* = w*rho*merged / (l2 + w*rho)
        z = merged * (w * self.rho / (self.l2 + w * self.rho))
        st.extra["u"] = st.extra["u"] + st.extra["x"] - z
        st.extra["z"] = z
        st.params = unravel(z, st.params)


class EMKMeans(Algorithm):
    """One EM round per epoch: merge (sums, counts), recompute centroids."""
    name = "kmeans_em"

    def rounds_per_epoch(self, part):
        return 1

    def rows_per_round(self, part):
        return part.n

    def local_update(self, model, st, rnd):
        s = model.local_stats(st.params, st.data)
        return torch.cat([s["sums"].reshape(-1), s["counts"]])

    def apply_merged(self, model, st, merged, w):
        k, d = st.params.shape
        sums = (merged[: k * d] * w).reshape(k, d)  # undo pattern's averaging
        counts = merged[k * d:] * w
        st.params = torch.where(counts[:, None] > 0,
                                sums / counts[:, None].clamp_min(1.0),
                                st.params)


def make_algorithm(name: str, **kw) -> Algorithm:
    return {"ga_sgd": GASGD, "ma_sgd": MASGD, "admm": ADMM,
            "kmeans_em": EMKMeans}[name](**kw)
