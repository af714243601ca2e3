"""The port's quant8 and top-k EF kernels' plain versions against the JAX
package (its ``ref`` backend and its Pallas kernels in interpret mode, as
tests/test_kernels.py runs them), on the CPU.

Tolerances: codes, scales, dequantized values, kept values and top-k
residuals are compared bitwise.  The int8 residual is bitwise equal to the
port's own ``x - deq`` and within one ulp of x of JAX's, because XLA may
contract ``x - q * scale`` into one FMA under jit (see the JAX package's
``kernels/quant8/ref.py``): the fused and unfused results differ by the
rounding of ``q * scale``, at most one ulp of x.  The CUDA kernels are
held against these plain versions bitwise on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant8 import ops as jq8
from repro.kernels.topk_ef import ops as jtk
from repro_torch.kernels.quant8 import kernel as q8_kernel
from repro_torch.kernels.quant8 import ops as q8
from repro_torch.kernels.topk_ef import kernel as tk_kernel
from repro_torch.kernels.topk_ef.ops import topk_ef

SHAPES = [(1000,), (33, 70), (4, 256), (7, 13, 11), (3_000_007,)]


def _x(shape, seed=0, scale=3.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x * np.float32(scale)


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32) if np.asarray(a).dtype == np.float32 \
        else np.asarray(a)


def _eq(port, ref, zero_sign: bool = True) -> None:
    """Bitwise equality of a torch and a JAX array; ``zero_sign=False``
    lets -0.0 equal +0.0 and nothing else."""
    p, r = port.numpy(), np.asarray(ref)
    assert p.shape == r.shape and p.dtype == r.dtype
    if zero_sign:
        np.testing.assert_array_equal(_bits(p), _bits(r))
    else:
        np.testing.assert_array_equal(p, r)
        np.testing.assert_array_equal(_bits(p)[p != 0], _bits(r)[r != 0])


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_int8_roundtrip_matches_jax(shape, backend):
    x = _x(shape)
    q, s, deq, res = q8.int8_roundtrip(torch.from_numpy(x))
    jq, js, jd, je = jq8.int8_roundtrip(jnp.asarray(x), interpret=True,
                                        backend=backend)
    _eq(q, jq)
    _eq(s, js)
    # the Pallas kernel dequantizes the float code, so a code rounded to
    # -0.0 gives deq -0.0; JAX's ref and the port use float(int8) = +0.0
    _eq(deq, jd, zero_sign=backend == "ref")
    assert res.shape == deq.shape == x.shape
    # residual: bitwise x - deq in the port, within one ulp of x of JAX
    np.testing.assert_array_equal(_bits(res.numpy()),
                                  _bits(x - deq.numpy()))
    assert np.all(np.abs(res.numpy() - np.asarray(je))
                  <= np.spacing(np.abs(x)))


def test_scale_is_the_reciprocal_multiply_jax_computes():
    """JAX writes ``max|x| / 127`` but XLA compiles it as a multiply by
    fp32(1/127); a true IEEE division would differ from JAX's scales in
    some blocks, so the port multiplies by the reciprocal too."""
    x = _x((3_000_007,))
    _, js = jq8.quantize8(jnp.asarray(x), backend="ref")
    amax = q8.pad_blocks(torch.from_numpy(x)).abs().amax(1, keepdim=True)
    divided = amax / torch.tensor(127.0)
    _eq(amax * torch.tensor(1 / 127, dtype=torch.float32), js)
    assert not torch.equal(divided, torch.tensor(np.asarray(js)))


@pytest.mark.parametrize("shape", SHAPES[:4], ids=str)
def test_quantize_dequantize_match_jax(shape):
    x = _x(shape, seed=1)
    q, s = q8.quantize8(torch.from_numpy(x))
    jq, js = jq8.quantize8(jnp.asarray(x), interpret=True)
    _eq(q, jq)
    _eq(s, js)
    xd = q8.dequantize8(q, s, shape)
    _eq(xd, jq8.dequantize8(jq, js, shape, interpret=True))
    assert float((xd - torch.from_numpy(x)).abs().max()) <= \
        float(s.max()) * 0.51


def test_quant8_zero_and_ragged_blocks():
    """All-zero blocks keep scale 1e-12/127 and zero codes; -0.0 inputs
    dequantize to +0.0 (float of an int8 code), as in JAX's ref."""
    x = np.zeros(600, np.float32)
    x[300] = -0.0
    x[513:] = _x((87,), seed=2)
    q, s, deq, res = q8.int8_roundtrip(torch.from_numpy(x))
    jq, js, jd, je = jq8.int8_roundtrip(jnp.asarray(x), backend="ref")
    _eq(q, jq)
    _eq(s, js)
    _eq(deq, jd)
    assert q.shape == (3, 256) and s.shape == (3, 1)


def test_quant_block_is_the_codec_wire_constant():
    from repro.core.comm.codecs import int8_wire_floats as jwire
    from repro_torch.core.comm.codecs import QUANT_BLOCK, int8_wire_floats
    assert QUANT_BLOCK == q8_kernel.BLOCK == 256
    for n in (1, 255, 256, 257, 3_000_007):
        assert int8_wire_floats(n) == jwire(n)


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("shape,k", [
    ((1000,), 50), ((33, 70), 100), ((4, 256), 1), ((512,), 512),
    ((7, 13, 11), 13), ((3_000_007,), 30_000),
], ids=str)
def test_topk_ef_matches_jax(shape, k, backend):
    x = _x(shape, seed=3, scale=2.0)
    out, res = topk_ef(torch.from_numpy(x), k)
    jo, jr = jtk.topk_ef(jnp.asarray(x), k, interpret=True, backend=backend)
    _eq(out, jo)
    _eq(res, jr)
    np.testing.assert_array_equal(_bits((out + res).numpy()), _bits(x))


def test_topk_ef_ties_all_kept():
    """Magnitude ties at tau are all kept, in both packages."""
    x = np.random.default_rng(4).integers(-3, 4, 700).astype(np.float32)
    out, res = topk_ef(torch.from_numpy(x), 10)
    jo, jr = jtk.topk_ef(jnp.asarray(x), 10, backend="ref")
    _eq(out, jo)
    _eq(res, jr)
    assert int((out != 0).sum()) == int((np.abs(x) == 3).sum()) > 10


def test_topk_ef_residual_carry_three_rounds():
    rng = np.random.default_rng(5)
    g = rng.standard_normal(640).astype(np.float32)
    res, jres = torch.zeros(640), jnp.zeros(640, jnp.float32)
    for _ in range(3):
        out, res = topk_ef(torch.from_numpy(g) + res, 64)
        jout, jres = jtk.topk_ef(jnp.asarray(g) + jres, 64, interpret=True)
        _eq(out, jout)
        _eq(res, jres)


def test_cpu_tensors_take_the_plain_version_and_kernels_refuse_them():
    """The device decides: a CPU tensor runs the plain version (no launch
    counted) and the CUDA wrappers raise on it -- no fallback either way."""
    q8_kernel.reset_launches()
    tk_kernel.reset_launches()
    x = torch.from_numpy(_x((1000,)))
    q8.int8_roundtrip(x)
    topk_ef(x, 10)
    assert set(q8_kernel.launches.values()) == {0}
    assert tk_kernel.launches["topk_ef"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        q8_kernel.quantize8_ef_kernel(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        q8_kernel.quantize8_kernel(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        q8_kernel.dequantize8_kernel(torch.zeros((4, 256), dtype=torch.int8),
                                     torch.ones((4, 1)), 1000)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk_kernel.topk_ef_kernel(x, x.abs().max())
