"""The port's ``distributed/step.py`` against the JAX package's, on the CPU.

- Against JAX: 3 steps of reduced smollm-360m (allreduce) and reduced
  deepseek-v2-lite-16b (scatter_reduce, its own pattern), micro_batches 1
  and 2, at the launcher's default shape (b 8, s 128), from the JAX init
  carried across and the same TokenStream batches; JAX's step on a 1x1
  Auto-axis mesh.  Losses within 1e-5 relative in fp32 (dtype replaced)
  and within ``ARCH_LOSS_RTOL`` (5e-5) in the configs' bf16 (smollm; the
  MoE arch is held in fp32, as every MoE parity test of the port: in bf16
  a near-tie gate routes by its rounding, and deepseek's first loss parts
  by 1.5e-4 with its aux loss moved); the fp32
  gradient norms within 1e-5; the metric keys equal.  Parameters: the
  frameworks' gradients part by ~1e-7 relative, and AdamW's first steps
  turn a gradient near its eps into an update of either sign, so the
  parameters are held, per step, to ``PARAM_LR_SHARE`` of the largest
  step AdamW takes (lr) or, where larger, one rounding of the leaf's
  largest |p| in its dtype: a bf16 parameter moves by less than an ulp a
  step, so which way it rounds follows the update (measured in fp32: at
  most 2.1e-2 of lr over 3 steps, deepseek's expert ``w_down``; in bf16
  3 ulps over 3 steps, smollm's ``w_down``); the optimizer alone is held
  far tighter, from one gradient, in ``test_torch_optim.py``.
- Two gloo ranks: ``allreduce`` and ``scatter_reduce`` equal the one-rank
  step over the whole batch within 1e-6 relative (losses, norms,
  parameters against their leaf's largest), and a planted per-shard clip
  misses that.
- The collectives: FSDP reduce-scatters and all-gathers, DP issues
  neither (the counterpart of ``test_comm_pattern_changes_collectives``).
- The prefill and serve steps equal ``Model.forward(last_only=True)`` and
  ``Model.decode_step`` bit for bit; the TP and world-size refusals.
"""

import numpy as np
import pytest
import torch

import _torch_dist as td

ARCH_LOSS_RTOL = 5e-5
FP32_RTOL = 1e-5
PARAM_LR_SHARE = 0.1
RANKS_RTOL = 1e-6
B, S = 8, 128


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_steps(name, dtype, params, steps, b=B, s=S, **train):
    return td.train_steps(0, 1, name=name, dtype=dtype, mesh=(1, 1),
                          params=params, steps=steps, b=b, s=s, **train)


def _ulp(x: np.ndarray, dtype: str) -> float:
    m = float(np.abs(x).max())
    return m * (2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -23)


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("name,dtype", [
    ("smollm-360m", "float32"), ("smollm-360m", "bfloat16"),
    ("deepseek-v2-lite-16b", "float32")])
def test_train_step_matches_jax(name, dtype, micro):
    jarch = td.jax_arch(name, dtype, micro_batches=micro)
    jparams, params = td.jax_init(jarch)
    steps = 3
    bts = td.batches(jarch.model.vocab_size, steps, B, S)
    jm, jp, _ = td.jax_train_steps(jarch, jparams, bts, B, S)
    tm, tp, _comm, _ = _port_steps(name, dtype, params, steps,
                                   micro_batches=micro)
    rtol = FP32_RTOL if dtype == "float32" else ARCH_LOSS_RTOL
    for i, (a, b) in enumerate(zip(jm, tm)):
        assert sorted(a) == sorted(b), (a, b)
        assert abs(a["loss"] - b["loss"]) <= rtol * abs(a["loss"]), (i, a, b)
        if dtype == "float32":
            assert abs(a["grad_norm"] - b["grad_norm"]) <= \
                FP32_RTOL * a["grad_norm"], (i, a, b)
    lr = jarch.train.learning_rate
    for (path, a), (_, b) in zip(td.flat(jp), td.flat(tp)):
        gap = float(np.abs(a - b).max())
        assert gap <= steps * max(PARAM_LR_SHARE * lr, _ulp(a, dtype)), \
            (path, gap, gap / lr)


def _ranks(world, pattern, plant_clip=False, steps=2, **train):
    jarch = td.jax_arch("smollm-360m", "float32")
    _j, params = td.jax_init(jarch)
    return td.run_ranks("train_steps", world, name="smollm-360m",
                        dtype="float32", mesh=(world, 1), params=params,
                        steps=steps, b=B, s=64, plant_clip=plant_clip,
                        comm_pattern=pattern, **train)


def _close(one, many, rtol):
    (m1, p1, _c, _o) = one
    (mw, pw, _cw, _ow) = many
    for a, b in zip(m1, mw):
        for k in a:
            assert abs(a[k] - b[k]) <= rtol * abs(a[k]) + 1e-12, (k, a, b)
    worst = 0.0
    for (path, a), (_, b) in zip(td.flat(p1), td.flat(pw)):
        worst = max(worst, float(np.abs(a - b).max() / np.abs(a).max()))
    return worst


@pytest.mark.parametrize("pattern", ["allreduce", "scatter_reduce"])
def test_two_ranks_equal_one_rank_over_the_whole_batch(pattern):
    one = _ranks(1, pattern)[0]
    two = _ranks(2, pattern)
    # both ranks end with the same full parameters
    for (path, a), (_, b) in zip(td.flat(two[0][1]), td.flat(two[1][1])):
        assert np.array_equal(a, b), path
    assert _close(one, two[0], RANKS_RTOL) <= RANKS_RTOL
    counts = two[0][2]
    if pattern == "scatter_reduce":
        assert counts.get(("train", "reduce_scatter"), 0) + \
            counts.get(("train", "all_gather"), 0) > 0, counts
    else:
        assert counts.get(("train", "reduce_scatter"), 0) == 0 and \
            counts.get(("train", "all_gather"), 0) == 0, counts
        assert counts.get(("train", "all_reduce"), 0) > 0, counts


def test_fsdp_clip_sums_the_shards_and_a_per_shard_clip_misses():
    """With the clip biting (grad_clip 0.05), FSDP's global norm must add
    each shard's squares over the ranks: the proper step matches one rank,
    a planted per-shard norm does not."""
    one = _ranks(1, "scatter_reduce", grad_clip=0.05)[0]
    good = _ranks(2, "scatter_reduce", grad_clip=0.05)[0]
    bad = _ranks(2, "scatter_reduce", plant_clip=True, grad_clip=0.05)[0]
    assert one[0][0]["grad_norm"] > 0.05          # the clip bites
    assert _close(one, good, RANKS_RTOL) <= RANKS_RTOL
    with pytest.raises(AssertionError):
        _close(one, bad, RANKS_RTOL)


def test_fsdp_cuts_what_param_pspec_names():
    """Under scatter_reduce on 2 ranks each leaf is cut along the dim whose
    spec entry holds "data" (FSDP's fill-in of the largest divisible dim),
    and its AdamW moments alike."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.step import build_train_step
    from repro_torch.launch.mesh import Mesh
    arch = td.port_arch("smollm-360m", "float32",
                        comm_pattern="scatter_reduce")
    mesh = Mesh(("data", "model"), {"data": 2, "model": 1}, rank=1, world=2,
                device=torch.device("cpu"))
    st = build_train_step(arch, mesh, ShapeConfig("t", 64, 8, "train"))
    layout, state = st.layouts
    flat_specs = _flat_specs(layout.specs)
    flat_dims = _flat_specs(layout.dims)
    assert any(d is not None for d in flat_dims.values())
    for path, spec in flat_specs.items():
        d = flat_dims[path]
        want = [i for i, m in enumerate(spec)
                if m == "data" or (isinstance(m, tuple) and "data" in m)]
        assert (d is None and not want) or [d] == want, (path, spec, d)
    state_dims = _flat_specs(state.dims)
    for path, d in flat_dims.items():
        assert state_dims[("m",) + path] == state_dims[("v",) + path] == d
    assert state_dims[("step",)] is None


def _flat_specs(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_specs(tree[k], path + (k,)))
        return out
    return {path: tree}


def test_prefill_and_serve_steps_equal_the_model():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.step import (
        build_prefill_step, build_serve_step, build_step)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    arch = td.port_arch("smollm-360m", "float32")
    model = build_model(arch, device="cpu")
    mesh = make_local_mesh("cpu")
    bt = td._torch_batch(td.batches(256, 1, 4, 16)[0])
    pre = build_prefill_step(arch, mesh, ShapeConfig("p", 16, 4, "prefill"))
    got = pre.fn(model.params, {"tokens": bt["tokens"]})
    want, _ = model.forward({"tokens": bt["tokens"]}, last_only=True)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    serve = build_serve_step(arch, mesh, ShapeConfig("d", 16, 4, "decode"))
    assert build_step(arch, mesh, ShapeConfig("d", 16, 4, "decode")).kind \
        == "decode"
    c1, c2 = model.init_cache(4, 16), model.init_cache(4, 16)
    for pos in range(3):
        tok = bt["tokens"][:, pos]
        a, c1 = serve.fn(model.params, c1, tok, pos)
        b, c2 = model.decode_step(c2, tok, pos)
        assert torch.equal(a, b)
    for k in c1:
        assert torch.equal(c1[k], c2[k])


def test_tensor_parallel_and_oversized_meshes_raise():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.step import build_train_step
    from repro_torch.launch.mesh import Mesh, make_mesh
    with pytest.raises(ValueError, match="larger than the world"):
        make_mesh((2, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="larger than the world"):
        make_mesh((1, 2), ("data", "model"), device="cpu")
    tp = td.port_arch("phi3-medium-14b", "float32")
    mesh = Mesh(("data", "model"), {"data": 1, "model": 2}, rank=0, world=2,
                device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="queue A10"):
        build_train_step(tp, mesh, ShapeConfig("t", 16, 8, "train"))
    # dp_over_model takes the batch over the model axis: not TP
    dp = td.port_arch("smollm-360m", "float32")
    build_train_step(dp, mesh, ShapeConfig("t", 16, 8, "train"))


def test_ssd_bf16_fence_raises_where_the_chunks_differ():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.step import build_train_step
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh("cpu")
    for name in ("mamba2-370m", "zamba2-2.7b"):
        bf = td.port_arch(name, "bfloat16")
        with pytest.raises(NotImplementedError, match="queue C 3"):
            build_train_step(bf, mesh, ShapeConfig("t", 128, 8, "train"))
        build_train_step(bf, mesh, ShapeConfig("t", 64, 8, "train"))
        build_train_step(td.port_arch(name, "float32"), mesh,
                         ShapeConfig("t", 128, 8, "train"))
    build_train_step(td.port_arch("smollm-360m", "bfloat16"), mesh,
                     ShapeConfig("t", 128, 8, "train"))
