"""Helpers of the port's distribution tests: multi-rank runs of the port
over gloo, and the JAX package's side on an Auto-axis mesh.

:func:`run_ranks` starts one process per rank (``python -c``), each
joining a gloo process group over a ``FileStore`` in a temporary
directory (no TCP port: the suite runs under pytest-xdist), calls
``_torch_dist.<name>(rank, world, **kwargs)`` and pickles its result;
the run has its own timeout.  The rank functions below import only the
port.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent

_RANK_MAIN = """
import pickle, sys
sys.path[:0] = [{tests!r}, {src!r}]
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world = {rank}, {world}
dist.init_process_group("gloo", store=dist.FileStore({store!r}, world),
                        rank=rank, world_size=world)
import _torch_dist
with open({args!r}, "rb") as f:
    kwargs = pickle.load(f)
out = getattr(_torch_dist, {name!r})(rank, world, **kwargs)
with open({out!r}, "wb") as f:
    pickle.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def run_ranks(fn: str, world: int, timeout: float = 240, **kwargs) -> list:
    """``fn``'s result on each of ``world`` gloo ranks, in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        args = tmp / "args.pkl"
        args.write_bytes(pickle.dumps(kwargs))
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONWARNINGS": "ignore"}
        procs = [subprocess.Popen(
            [sys.executable, "-c", _RANK_MAIN.format(
                tests=str(TESTS), src=str(ROOT / "src"), rank=r, world=world,
                store=str(tmp / "store"), args=str(args), name=fn,
                out=str(tmp / f"out{r}.pkl"))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                p.kill()
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
        return [pickle.loads((tmp / f"out{r}.pkl").read_bytes())
                for r in range(world)]


# ------------------------------------------------------------ port side -----

def numpy_tree(tree):
    """A tree of tensors as float32 (bf16 widened) / int numpy arrays."""
    import torch
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def port_arch(name: str, dtype: str | None = None, **train):
    from repro_torch.configs import get_reduced
    a = get_reduced(name)
    if dtype:
        a = a.replace(model=a.model.replace(dtype=dtype))
    return a.replace(train=dataclasses.replace(a.train, **train))


def batches(vocab: int, n: int, b: int, s: int) -> list:
    from repro_torch.data.tokens import TokenStream
    ts = TokenStream(vocab, seed=0)
    return [ts.batch(b, s) for _ in range(n)]


def _torch_batch(bt):
    import torch
    return {k: torch.from_numpy(np.asarray(v)) for k, v in bt.items()}


def train_steps(rank, world, *, name, dtype, mesh, params, steps, b, s,
                plant_clip=False, **train):
    """``steps`` train steps of the port's ``build_train_step`` on this
    rank's mesh from the full numpy ``params``; -> (per-step metrics, the
    full final parameters, the collectives counted)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import step as dstep
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import params_from_numpy
    from repro_torch.optim import make_optimizer
    arch = port_arch(name, dtype, **train)
    m = make_mesh(mesh, ("data", "model")[-len(mesh):] if len(mesh) < 3
                  else ("pod", "data", "model"), device="cpu")
    if plant_clip:       # the fault to catch: each shard clips by its own norm
        dstep._global_sq_sums = lambda comm, dims: None
    st = dstep.build_train_step(arch, m, ShapeConfig("t", s, b, "train"))
    full = params_from_numpy(params, arch, device="cpu").params
    opt_state = st.shard(make_optimizer(arch.train).init(full), 1)
    p = st.shard(full)
    dstep.COMM_LOG.clear()
    out = []
    for bt in batches(arch.model.vocab_size, steps, b, s):
        p, opt_state, met = st.fn(p, opt_state, _torch_batch(bt))
        out.append({k: float(v) for k, v in met.items()})
    comm = dict(dstep.COMM_LOG)
    return out, numpy_tree(st.gather(p)), comm, numpy_tree(
        st.gather(opt_state, 1))


def local_sgd_run(rank, world, *, name, dtype, params, inner, b, s,
                  mesh=(2, 1, 1), **train):
    """``inner`` inner steps then one outer step of the port's
    ``build_local_sgd``; -> the pods' losses, the full stacked parameters,
    the outer state, the int8 codes of the outer step (compressed), and
    the collectives each step issued."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import step as dstep
    from repro_torch.distributed.local_sgd import build_local_sgd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import params_from_numpy
    from repro_torch.optim import make_optimizer
    arch = port_arch(name, dtype, **train)
    m = make_mesh(mesh, ("pod", "data", "model"), device="cpu")
    ls = build_local_sgd(arch, m, ShapeConfig("t", s, b, "train"))
    full = params_from_numpy(params, arch, device="cpu").params
    params_st = ls.stack(full)
    opt_st = ls.stack(make_optimizer(arch.train).init(full), 1)
    outer = ls.init_outer_fn(params_st)
    losses, comm = [], {}
    dstep.COMM_LOG.clear()
    for bt in batches(arch.model.vocab_size, inner, b, s):
        params_st, opt_st, met = ls.inner_fn(params_st, opt_st,
                                             _torch_batch(bt))
        losses.append(ls.pod_losses(met).tolist())
    comm["inner"] = dict(dstep.COMM_LOG)
    codes = {}
    if arch.train.compress_cross_pod:
        # the codes the outer step puts on the wire, from its own inputs
        import repro_torch.distributed.local_sgd as lsgd
        orig = lsgd.quantize8_ef_ref

        def spy(x, axis=-1):
            out = orig(x, axis=axis)
            codes.setdefault("q", []).append(out[0].numpy().copy())
            codes.setdefault("x", []).append(x.numpy().copy())
            codes.setdefault("scale", []).append(out[1].numpy().copy())
            return out
        lsgd.quantize8_ef_ref = spy
    dstep.COMM_LOG.clear()
    try:
        params_st, outer = ls.outer_fn(params_st, outer)
    finally:
        if codes is not None and arch.train.compress_cross_pod:
            lsgd.quantize8_ef_ref = orig
    comm["outer"] = dict(dstep.COMM_LOG)
    return {"losses": losses, "params_st": numpy_tree(ls.gather(params_st)),
            "outer": numpy_tree(ls.gather_outer(outer)), "codes": codes,
            "comm": comm, "pods": ls.pods}


def placements_check(rank, world, *, specs, shape):
    """Each spec's DTensor placements on a (data, model) DeviceMesh give
    every rank the piece that ``local_shard`` cuts."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import local_shard, placements
    from repro_torch.launch.mesh import make_mesh
    m = make_mesh((world, 1), ("data", "model"), device="cpu")
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape)
    out = []
    for spec in specs:
        pl = placements(spec, m.device_mesh.mesh_dim_names)
        dt = distribute_tensor(full, m.device_mesh, list(pl))
        mine = local_shard(full, spec, m.rank_sizes, m.coords)
        out.append((str(pl), bool(torch.equal(dt.to_local(), mine)),
                    tuple(mine.shape)))
    return out


# ------------------------------------------------------------- JAX side -----

def jax_mesh(shape, names):
    """A mesh of Auto axes built directly (``jax.make_mesh`` gives Explicit
    axes under jax 0.9, which the JAX package's hints refuse)."""
    import jax
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             tuple(names))


def jax_arch(name: str, dtype: str | None = None, **train):
    from repro.configs import get_reduced
    a = get_reduced(name)
    if dtype:
        a = a.replace(model=a.model.replace(dtype=dtype))
    return a.replace(train=dataclasses.replace(a.train, **train))


def jax_init(arch, seed: int = 0):
    """The JAX model's init as a numpy tree (bf16 widened to fp32, exact)."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model
    params = build_model(arch).init(jax.random.key(seed))
    return params, jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.float32)), params)


def jax_numpy(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(lambda x: np.asarray(
        x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x), tree)


def jax_train_steps(arch, params, bts: list, b: int, s: int):
    """The JAX package's ``build_train_step`` on a 1x1 Auto-axis mesh over
    ``bts``: -> (per-step metrics, final params as numpy, final opt
    state)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig
    from repro.distributed.step import build_train_step
    from repro.optim import make_optimizer
    mesh = jax_mesh((1, 1), ("data", "model"))
    step = build_train_step(arch, mesh, ShapeConfig("t", s, b, "train"))
    opt_state = make_optimizer(arch.train).init(params)
    out = []
    with mesh:
        for bt in bts:
            params, opt_state, m = step.fn(
                params, opt_state, {k: jnp.asarray(v) for k, v in bt.items()})
            out.append({k: float(v) for k, v in m.items()})
    return out, jax_numpy(params), jax_numpy(opt_state)


def flat(tree, path=()) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k], path + (k,))]
    return [("/".join(path), np.asarray(tree))]
