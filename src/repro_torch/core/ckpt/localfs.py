"""The ``local`` backend's on-disk format: atomic npz tree checkpoints.

Flatten a tree (nested dicts, lists and tuples) of tensors or arrays to
flat npz keys (``a//b//#0``), encode bf16 leaves as uint16 views (npz has
no bfloat16), commit atomically (tmp + fsync + rename) so a preemption
mid-write never corrupts the latest checkpoint, and resume from
``load_latest``.  The files are byte-compatible with the JAX package's
``repro.core.ckpt.localfs``: the same keys, the same ``@bf16`` tag, the same
bit patterns.  The metered side of the same backend is
:data:`repro_torch.core.ckpt.LOCAL_SPEC` (EBS constants).

Leaves may be torch tensors (on any device; they are copied to the host)
or numpy arrays.  :func:`load` returns CPU torch tensors, bf16 leaves as
``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

_SEP = "//"
_BF16_TAG = "@bf16"


def _encode(leaf) -> tuple[np.ndarray, bool]:
    """A leaf as the array npz stores, and whether it is bf16 (saved as a
    uint16 view of its bit patterns)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":      # an ml_dtypes array
        return arr.view(np.uint16), True
    return arr, False


def _decode(arr: np.ndarray, is_bf16: bool) -> torch.Tensor:
    if is_bf16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}#{i}" if prefix else f"#{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
            return [fix(v) for _, v in items]
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


def save(directory: str | Path, step: int, tree: Any,
         metadata: Optional[dict] = None) -> Path:
    """Atomic checkpoint commit: write tmp, fsync, rename."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat = {}
    for k, v in _flatten(tree).items():
        enc, is_bf16 = _encode(v)
        flat[k + _BF16_TAG if is_bf16 else k] = enc
    tmp = directory / f".tmp-{step}-{os.getpid()}.npz"
    final = directory / f"step_{step:010d}.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)  # atomic on POSIX
    meta = dict(metadata or {})
    meta["step"] = step
    mtmp = directory / f".tmp-meta-{step}.json"
    mtmp.write_text(json.dumps(meta))
    os.replace(mtmp, directory / f"step_{step:010d}.json")
    return final


def list_steps(directory: str | Path) -> list[int]:
    directory = Path(directory)
    if not directory.exists():
        return []
    return sorted(int(p.stem.split("_")[1]) for p in directory.glob("step_*.npz"))


def load(directory: str | Path, step: int):
    directory = Path(directory)
    with np.load(directory / f"step_{step:010d}.npz") as z:
        flat = {}
        for k in z.files:
            if k.endswith(_BF16_TAG):
                flat[k[: -len(_BF16_TAG)]] = _decode(z[k], True)
            else:
                flat[k] = _decode(z[k], False)
    meta_p = directory / f"step_{step:010d}.json"
    meta = json.loads(meta_p.read_text()) if meta_p.exists() else {"step": step}
    return _unflatten(flat), meta


def load_latest(directory: str | Path):
    steps = list_steps(directory)
    if not steps:
        return None, None
    return load(directory, steps[-1])


def retain(directory: str | Path, keep: int = 3):
    steps = list_steps(directory)
    for s in steps[:-keep]:
        (Path(directory) / f"step_{s:010d}.npz").unlink(missing_ok=True)
        (Path(directory) / f"step_{s:010d}.json").unlink(missing_ok=True)
