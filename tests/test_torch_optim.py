"""The port's optimizers (``repro_torch.optim``) against the JAX package's
``repro.optim`` under ``jax.jit`` (how its training step runs them), on
the CPU, from the same numpy draws.

Tolerances, and why:

- ``quantize_blockwise`` / ``dequantize_blockwise``: bit for bit (codes,
  scales, values; the scale is max|x| x fp32(1/127), as XLA compiles
  ``/ 127.0``).
- ``clip_by_global_norm``: the norm within 1e-6 relative (each leaf's sum
  of squares runs in another order in each framework), the clipped
  gradients within one rounding of their dtype.
- SGD: bit for bit over two updates, fp32 and bf16 parameters, where the
  clip does not bite (scale exactly 1).
- AdamW, AdamW8bit: two updates.  bf16 parameters bit for bit.  fp32
  parameters within ``ADAM_FP32_ULPS`` ulps of their leaf's largest |p|
  (the update's error, lr x an ulp of |u| ~ 1, lands on parameters of
  any size, some near 0): XLA
  folds the update ``m / c1 / (sqrt(v / c2) + eps)`` into one division,
  which the port does not copy.  The moments bit for bit; the 8-bit codes
  equal, and the scales within one fp32 ulp (XLA takes a block's max from
  its own fusion of the moment, contracted apart from the one that makes
  the codes).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.optim import (
    clip_by_global_norm as jclip, dequantize_blockwise as jdequant,
    make_optimizer as jmake, quantize_blockwise as jquant,
)
from repro_torch.configs.base import TrainConfig
from repro_torch.optim import (
    BLOCK, clip_by_global_norm, dequantize_blockwise, make_optimizer,
    quantize_blockwise,
)

#: the leaves: keys out of order (JAX flattens them sorted), a nested
#: dict, last dims that 256 divides and that it does not
SHAPES = {"b": {"w": (3, 512), "z": (7,)}, "a": (5, 256), "c": (2, 3, 9)}
ADAM_FP32_ULPS = 2            # measured: 1


def _draw(shapes, seed, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _draw(v, seed + i, scale)
                for i, (k, v) in enumerate(shapes.items())}
    return (np.random.default_rng(seed).standard_normal(shapes)
            * scale).astype(np.float32)


def _torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(tree).to(getattr(torch, dtype))


def _jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _pairs(jtree, ttree, path=()):
    """[(path, jax leaf as numpy, torch leaf as numpy)] over JAX's tree."""
    if isinstance(jtree, dict):
        return [x for k in jtree for x in _pairs(jtree[k], ttree[k],
                                                path + (k,))]
    a = np.asarray(jnp.asarray(jtree).astype(jnp.float32)
                   if jnp.asarray(jtree).dtype == jnp.bfloat16 else jtree)
    b = ttree.float().numpy() if ttree.dtype == torch.bfloat16 \
        else ttree.numpy()
    return [(path, a, b)]


def _bits_equal(jtree, ttree):
    for path, a, b in _pairs(jtree, ttree):
        assert a.dtype == b.dtype or a.dtype.kind == b.dtype.kind == "f", path
        assert np.array_equal(a, b), (path, np.argwhere(a != b)[:5])


# ------------------------------------------------------------ quantizer ----

@pytest.mark.parametrize("shape", [(256,), (3, 512), (5, 7), (2, 3, 256),
                                   (4, 3 * BLOCK)])
@pytest.mark.parametrize("scale", [1e-7, 1.0, 300.0])
def test_quantize_blockwise_equals_jax_bit_for_bit(shape, scale):
    x = _draw(shape, 1, scale)
    x.flat[0] = 0.0
    jq, js = jax.jit(jquant)(jnp.asarray(x))
    q, s = quantize_blockwise(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == x.shape and s.shape == js.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dequantize_blockwise(q, s).numpy(),
        np.asarray(jax.jit(jdequant)(jq, js)))


def test_quantize_scale_is_the_compiled_multiply():
    """max|x| x fp32(1/127), not max|x| / 127: the two part on some
    blocks, and the port takes JAX's jitted side."""
    x = _draw((4096, 256), 2)
    amax = np.abs(x).max(-1)
    mul = amax * np.float32(1.0 / 127.0)
    div = amax / np.float32(127.0)
    assert (mul != div).any()
    _q, s = quantize_blockwise(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy()[:, 0], mul)


# ----------------------------------------------------------------- clip ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 1e9])
def test_clip_by_global_norm_matches_jax(dtype, max_norm):
    g = _draw(SHAPES, 3, 2.0)
    jg, jn = jax.jit(jclip, static_argnums=1)(_jax(g, dtype), max_norm)
    tg, tn = clip_by_global_norm(_torch(g, dtype), max_norm)
    assert tn.dtype == torch.float32
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    ulp = 2.0 ** (-7 if dtype == "bfloat16" else -23)
    for path, a, b in _pairs(jg, tg):
        assert str(tg["a"].dtype) == f"torch.{dtype}"
        np.testing.assert_allclose(b, a, rtol=ulp, atol=0, err_msg=str(path))
    if max_norm > 1e8:                       # scale exactly 1: untouched
        _bits_equal(_jax(g, dtype), tg)


# ----------------------------------------------------------- optimizers ----

def _two_updates(name, dtype, clip=1e9, lr=0.05, grad_scale=1.0):
    """Both packages' optimizers over two updates from the same draws ->
    [(JAX params, JAX state, port params, port state, JAX stats, port
    stats)] after each."""
    jopt = jmake(JTrainConfig(optimizer=name, grad_clip=clip,
                              learning_rate=lr))
    opt = make_optimizer(TrainConfig(optimizer=name, grad_clip=clip,
                                     learning_rate=lr))
    p = _draw(SHAPES, 0)
    jp, tp = _jax(p, dtype), _torch(p, dtype)
    js, ts = jopt.init(jp), opt.init(tp)
    update = jax.jit(jopt.update)
    out = []
    for step in range(2):
        g = _draw(SHAPES, 10 + 5 * step, grad_scale)
        jp, js, jst = update(_jax(g, dtype), js, jp)
        tp, ts, tst = opt.update(_torch(g, dtype), ts, tp)
        out.append((jp, js, tp, ts, jst, tst))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_equals_jax_bit_for_bit(dtype):
    for jp, js, tp, ts, jst, tst in _two_updates("sgd", dtype):
        _bits_equal(jp, tp)
        assert int(ts["step"]) == int(js["step"])
        np.testing.assert_allclose(float(tst["grad_norm"]),
                                   float(jst["grad_norm"]), rtol=1e-6)
        for path, a, b in _pairs(jp, tp):
            assert str(b.dtype) == "float32"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_with_the_clip_biting_matches_jax(dtype):
    """The clip scales by min(1, 1 / norm): the norm's last bits may part,
    so the parameters are held within one rounding of their dtype."""
    ulp = 2.0 ** (-7 if dtype == "bfloat16" else -22)
    for jp, _js, tp, _ts, jst, tst in _two_updates("sgd", dtype, clip=1.0):
        assert float(jst["grad_norm"]) > 1.0
        for path, a, b in _pairs(jp, tp):
            np.testing.assert_allclose(b, a, rtol=ulp, atol=0,
                                       err_msg=str(path))


def _adam_params_close(jp, tp, dtype):
    if dtype == "bfloat16":
        _bits_equal(jp, tp)
        return
    for path, a, b in _pairs(jp, tp):
        ulps = np.abs(a - b) / np.spacing(np.abs(a).max())
        assert float(ulps.max()) <= ADAM_FP32_ULPS, (path, float(ulps.max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1e9, 1.0])
def test_adamw_matches_jax(dtype, clip):
    for jp, js, tp, ts, _jst, _tst in _two_updates(
            "adamw", dtype, clip=clip, grad_scale=0.01 if clip < 2 else 1.0):
        _adam_params_close(jp, tp, dtype)
        if clip > 1e8:
            _bits_equal(js["m"], ts["m"])
            _bits_equal(js["v"], ts["v"])
        assert int(ts["step"]) == int(js["step"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw8bit_matches_jax_with_codes_equal(dtype):
    for jp, js, tp, ts, _jst, _tst in _two_updates("adamw8bit", dtype):
        _adam_params_close(jp, tp, dtype)
        for moment in ("m", "v"):
            for path, a, b in _pairs(js[moment], ts[moment]):
                if path[-1] == "q":
                    assert b.dtype == np.int8
                    np.testing.assert_array_equal(b, a, err_msg=str(path))
                else:
                    np.testing.assert_allclose(b, a, rtol=2.0 ** -23,
                                               atol=0, err_msg=str(path))


def test_adamw8bit_tracks_fp32_adamw():
    """The JAX package's own fidelity check, on the port: 50 steps of
    8-bit moments stay within 1.5e-2 of exact AdamW."""
    cfg32 = TrainConfig(optimizer="adamw", learning_rate=0.01,
                        weight_decay=0.0)
    o32 = make_optimizer(cfg32)
    o8 = make_optimizer(dataclasses.replace(cfg32, optimizer="adamw8bit"))
    p32 = p8 = {"w": torch.linspace(-1, 1, 512)}
    s32, s8 = o32.init(p32), o8.init(p8)
    rng = np.random.default_rng(0)
    for _ in range(50):
        g = {"w": torch.from_numpy(
            (rng.standard_normal(512) * 0.1).astype(np.float32))}
        p32, s32, _ = o32.update(g, s32, p32)
        p8, s8, _ = o8.update(g, s8, p8)
    assert float((p32["w"] - p8["w"]).abs().max()) < 1.5e-2


@pytest.mark.parametrize("name", ["sgd", "adamw", "adamw8bit"])
def test_state_axes_and_init_match_jax(name):
    jopt = jmake(JTrainConfig(optimizer=name))
    opt = make_optimizer(TrainConfig(optimizer=name))
    paxes = {"b": {"w": ("embed", "ff"), "z": ("ff",)}, "a": ("x", None)}
    assert opt.state_axes(paxes) == jax.tree.map(
        lambda a: a, jopt.state_axes(paxes),
        is_leaf=lambda x: isinstance(x, tuple))
    p = _draw(SHAPES, 0)
    js, ts = jopt.init(_jax(p, "bfloat16")), opt.init(_torch(p, "bfloat16"))
    assert int(ts["step"]) == 0 and ts["step"].dtype == torch.int32
    if name != "sgd":
        _bits_equal({k: js[k] for k in ("m", "v")},
                    {k: ts[k] for k in ("m", "v")})


@pytest.mark.parametrize("name", ["sgd", "adamw", "adamw8bit"])
def test_optimizers_minimize_a_quadratic(name):
    opt = make_optimizer(TrainConfig(optimizer=name, learning_rate=0.05,
                                     weight_decay=0.0, grad_clip=1e9))
    params = {"w": torch.tensor([3.0, -2.0, 5.0]),
              "b": torch.tensor([[1.0, -1.0]])}
    state = opt.init(params)
    for _ in range(300):
        grads = {k: 2 * v for k, v in params.items()}
        params, state, _ = opt.update(grads, state, params)
    assert sum(float(v.square().sum()) for v in params.values()) < 1e-2


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="lion"):
        make_optimizer(TrainConfig(optimizer="lion"))


def test_cpu_tensors_take_the_float64_route():
    """Off the card the fused multiply-add and the square root go through
    float64 (the CPU's fp32 ``a + b * c`` rounds twice and its ``sqrt`` is
    not correctly rounded): the same values as the float64 helpers, and
    correctly rounded roots where PyTorch's fp32 root is not."""
    from repro_torch import optim
    gen = torch.Generator().manual_seed(7)
    a = 0.9
    b = torch.randn(100_000, generator=gen)
    c = torch.randn(100_000, generator=gen)
    assert torch.equal(optim._fma(a, b, c), optim._fma64(a, b, c))
    x = torch.rand(100_000, generator=gen) * 10
    root = optim._sqrt(x)
    assert torch.equal(root, optim._sqrt64(x))
    exact = torch.sqrt(x.double())
    # correctly rounded: no fp32 value lies nearer the exact root
    up = torch.nextafter(root, torch.tensor(float("inf")))
    down = torch.nextafter(root, torch.tensor(float("-inf")))
    err = (root.double() - exact).abs()
    assert bool((err <= (up.double() - exact).abs()).all())
    assert bool((err <= (down.double() - exact).abs()).all())
