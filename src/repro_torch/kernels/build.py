"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/repro_torch/`` at the repository
root, named by a hash of the source, the shared headers and the flags, so
an edited source or header rebuilds and an unchanged one is reused.  The
library is loaded with :mod:`ctypes`.  Nothing here runs at import time:
the first launch builds, and :func:`build` builds several sources at
once, one ``nvcc`` process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: no --use_fast_math: the kernels must round exactly like the plain
#: versions; --split-compile=0 compiles a source's kernels on every core
#: (the same code, built in less than half the time)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}
#: one build-and-load at a time: the threads of a sweep share the card, and
#: two threads building one source would write the same temporary file
_LOAD_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives (named by the
    source, the shared headers ``csrc/*.cuh`` and the flags)."""
    parts = [(CSRC / f"{name}.cu").read_bytes(),
             *(p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))),
             " ".join(NVCC_FLAGS).encode()]
    digest = hashlib.sha256(b"".join(parts)).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> dict[str, Path]:
    """Compile every source in ``names`` that has no up-to-date library,
    one ``nvcc`` per source started together; raise with the compiler's
    output if any fails.  Returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    procs = {}
    for n, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{n}.cu:\n{log}")
            continue
        os.replace(tmp, out[n])          # atomic: readers never see half
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures`` maps
    each C entry point to its argtypes (every entry point returns the
    ``int`` of ``cudaGetLastError()``)."""
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LOADED[name] = lib
    return lib


def check_launch(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
