"""Synthetic stand-ins for the paper's datasets (paper-exact dimensionality,
scaled row counts so the full study runs on CPU; row counts configurable).

| paper dataset | dims      | here (default rows) | label model            |
|---------------|-----------|---------------------|------------------------|
| Higgs         | 28        | 100k (of 11M)       | logistic teacher + noise |
| RCV1          | 47,236 sparse | 20k, nnz=64     | sparse logistic teacher  |
| Cifar10       | 3,072     | 20k                 | 10-class linear teacher  |
| YFCC100M     | 4,096     | 20k (of 4M sample)  | binary, 7.5% positive    |
| Criteo        | 1M sparse | 10k, nnz=39         | sparse logistic teacher  |

Sparse datasets are (indices, values) pairs with fixed nnz per row -- models
consume them with gather-style dot products, which is also how LambdaML's
sparse LR worked.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Dataset:
    name: str
    x: np.ndarray                     # (n, d) dense OR (n, nnz) values
    y: np.ndarray                     # (n,) float {-1,+1} or int class
    idx: Optional[np.ndarray] = None  # (n, nnz) int32 for sparse
    dim: int = 0                      # full feature dim (sparse)
    n_classes: int = 2

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def d(self) -> int:
        return self.dim or self.x.shape[1]

    @property
    def sparse(self) -> bool:
        return self.idx is not None

    @property
    def nbytes(self) -> int:
        return self.x.nbytes + self.y.nbytes + (self.idx.nbytes if self.sparse else 0)


def _teacher_labels(rng, z):
    p = 1.0 / (1.0 + np.exp(-z))
    return np.where(rng.random(z.shape) < p, 1.0, -1.0).astype(np.float32)


def make_dataset(name: str, rows: int | None = None, seed: int = 0) -> Dataset:
    rng = np.random.default_rng(seed)
    if name == "higgs":
        n = rows or 100_000
        x = rng.standard_normal((n, 28)).astype(np.float32)
        w = rng.standard_normal(28).astype(np.float32)
        return Dataset("higgs", x, _teacher_labels(rng, 1.5 * x @ w), n_classes=2)
    if name == "rcv1":
        n = rows or 20_000
        d, nnz = 47_236, 64
        idx = rng.integers(0, d, (n, nnz)).astype(np.int32)
        val = np.abs(rng.standard_normal((n, nnz))).astype(np.float32)
        val /= np.linalg.norm(val, axis=1, keepdims=True)  # TF-IDF-normalized
        w = rng.standard_normal(d).astype(np.float32)
        z = (val * w[idx]).sum(1)
        return Dataset("rcv1", val, _teacher_labels(rng, 4.0 * z), idx=idx, dim=d)
    if name == "cifar10":
        n = rows or 20_000
        x = rng.standard_normal((n, 3072)).astype(np.float32)
        w = rng.standard_normal((3072, 10)).astype(np.float32) / 50.0
        y = np.argmax(x @ w + rng.standard_normal((n, 10)), axis=1)
        return Dataset("cifar10", x, y.astype(np.int32), n_classes=10)
    if name == "yfcc100m":
        n = rows or 20_000
        x = rng.standard_normal((n, 4096)).astype(np.float32)
        w = rng.standard_normal(4096).astype(np.float32)
        z = x @ w / 64.0 - 2.5  # ~7.5% positives, like the 'animal' tag
        return Dataset("yfcc100m", x, _teacher_labels(rng, z), n_classes=2)
    if name == "criteo":
        n = rows or 10_000
        d, nnz = 1_000_000, 39
        idx = rng.integers(0, d, (n, nnz)).astype(np.int32)
        val = np.ones((n, nnz), np.float32)
        w = (rng.standard_normal(d) / 6.0).astype(np.float32)
        z = (val * w[idx]).sum(1)
        return Dataset("criteo", val, _teacher_labels(rng, z), idx=idx, dim=d)
    raise KeyError(name)


DATASETS = ("higgs", "rcv1", "cifar10", "yfcc100m", "criteo")


def partition(ds: Dataset, w: int) -> list[Dataset]:
    """Even row partition over w workers (paper: data parallelism)."""
    out = []
    bounds = np.linspace(0, ds.n, w + 1, dtype=int)
    for i in range(w):
        s = slice(bounds[i], bounds[i + 1])
        out.append(Dataset(ds.name, ds.x[s], ds.y[s],
                           None if ds.idx is None else ds.idx[s],
                           ds.dim, ds.n_classes))
    return out


def train_val_split(ds: Dataset, val_frac: float = 0.1, seed: int = 1):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(ds.n)
    nv = int(ds.n * val_frac)
    vi, ti = perm[:nv], perm[nv:]

    def take(sel):
        return Dataset(ds.name, ds.x[sel], ds.y[sel],
                       None if ds.idx is None else ds.idx[sel],
                       ds.dim, ds.n_classes)
    return take(ti), take(vi)
