"""The port's Mamba2 SSD scan and Mamba2 block against the JAX package, on
the CPU: the recurrence ``ref.py`` against JAX's ``ssd_scan_ref``, the
chunked plain version against the JAX model's ``ssd_scan``, ``ops`` on
CPU tensors against JAX's ``ssd_scan_fused`` with its Pallas kernel in
interpret mode (as tests/test_kernels.py runs it), the causal conv and
the whole block, full and single-step.

Tolerances: the port's functions against the same JAX function in fp32 at
``rtol=atol=1e-5`` (the same products summed in other orders); against the
Pallas interpreter at tests/test_kernels.py's 1e-3.  The CUDA kernel is
held against these plain versions on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.ssd_scan.ops import ssd_scan_fused as jssd_fused
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jssd_ref
from repro.models import build_model as jbuild
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import segsum, ssd_scan_ref
from repro_torch.models import params_from_numpy
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tfm

TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=1e-3, atol=1e-3)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _pair(*shapes_scales, seed=0):
    """Seeded numpy arrays as (jax, torch) pairs holding the same values.
    Each entry is (shape, scale, kind): kind "abs" for dt-like, "neg" for
    A-like, "" for plain normals."""
    rng = np.random.default_rng(seed)
    out = []
    for shape, scale, kind in shapes_scales:
        a = rng.standard_normal(shape).astype(np.float32) * np.float32(scale)
        if kind == "abs":
            a = np.abs(a)
        elif kind == "neg":
            a = -np.abs(a) - np.float32(0.5)
        out.append((jnp.asarray(a), torch.from_numpy(a.copy())))
    return out


def _model_inputs(b, s, h, p, n, seed=0):
    """x (b,s,h,p), dt (b,s,h) >= 0, a_log (h,), B/C (b,s,n)."""
    return _pair(((b, s, h, p), 1.0, ""), ((b, s, h), 0.2, "abs"),
                 ((h,), 0.3, ""), ((b, s, n), 1.0, ""), ((b, s, n), 1.0, ""),
                 seed=seed)


# ---------------------------------------------------------- recurrence ----

@pytest.mark.parametrize("bh,s,p,n", [
    (4, 256, 64, 32), (2, 128, 32, 16), (3, 96, 16, 8), (1, 64, 128, 64),
], ids=str)
def test_recurrence_matches_jax_ssd_scan_ref(bh, s, p, n):
    (jx, x), (jdt, dt), (ja, a), (jB, B), (jC, C) = _pair(
        ((bh, s, p), 1.0, ""), ((bh, s), 0.2, "abs"), ((bh,), 1.0, "neg"),
        ((bh, s, n), 1.0, ""), ((bh, s, n), 1.0, ""), seed=bh + s)
    y, st = ssd_scan_ref(x, dt, a, B, C)
    jy, jst = jssd_ref(jx, jdt, ja, jB, jC)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    _close(y, jy)
    _close(st, jst)


def test_recurrence_init_state_continues_the_scan():
    """Two halves, the second from the first's final state, give the whole
    scan: the property the kernel's ``init_state`` is held to."""
    (_, x), (_, dt), (_, a), (_, B), (_, C) = _pair(
        ((3, 40, 8), 1.0, ""), ((3, 40), 0.2, "abs"), ((3,), 1.0, "neg"),
        ((3, 40, 4), 1.0, ""), ((3, 40, 4), 1.0, ""), seed=5)
    y, st = ssd_scan_ref(x, dt, a, B, C)
    y1, st1 = ssd_scan_ref(x[:, :17], dt[:, :17], a, B[:, :17], C[:, :17])
    y2, st2 = ssd_scan_ref(x[:, 17:], dt[:, 17:], a, B[:, 17:], C[:, 17:],
                           init_state=st1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **TOL)
    torch.testing.assert_close(st2, st, **TOL)


# ------------------------------------------------------------- chunked ----

@pytest.mark.parametrize("s,chunk", [(64, 16), (64, 64), (50, 16)],
                         ids=["chunk16", "chunk64", "fallback"])
@pytest.mark.parametrize("with_init", [False, True], ids=["zeros", "init"])
def test_chunked_scan_matches_jax_ssd_scan(s, chunk, with_init):
    b, h, p, n = 2, 3, 8, 4
    (jx, x), (jdt, dt), (jal, a_log), (jB, B), (jC, C) = _model_inputs(
        b, s, h, p, n, seed=s + chunk)
    ji, init = (_pair(((b, h, p, n), 1.0, ""), seed=9)[0] if with_init
                else (None, None))
    y, st = tssm.ssd_scan(x, dt, a_log, B, C, chunk, init_state=init)
    jy, jst = jssm.ssd_scan(jx, jdt, jal, jB, jC, chunk, init_state=ji)
    assert y.shape == (b, s, h, p) and y.dtype == torch.float32
    assert st.shape == (b, h, p, n) and st.dtype == torch.float32
    _close(y, jy)
    _close(st, jst)


def test_chunked_scan_and_recurrence_agree():
    """Both plain versions compute one function: the chunked scan (chunks
    of 16) against the recurrence behind the JAX wrapper's plumbing."""
    (_, x), (_, dt), (_, a_log), (_, B), (_, C) = _model_inputs(
        2, 64, 3, 8, 4, seed=3)
    init = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 3, 8, 4)).astype(np.float32))
    y, st = tssm.ssd_scan(x, dt, a_log, B, C, 16, init_state=init)
    yr, sr = ssd_ops.ssd_scan_recurrence(x, dt, a_log, B, C, init)
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, sr, rtol=1e-4, atol=1e-4)


def test_segsum_matches_jax():
    (ja, a), = _pair(((2, 3, 7), 0.5, ""), seed=6)
    got, want = segsum(a), np.asarray(jssm._segsum(ja))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = ~np.isinf(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], **TOL)


# ----------------------------------------------------------------- ops ----

def test_fused_ops_on_cpu_matches_jax_pallas_interpret():
    """tests/test_kernels.py::test_ssd_fused_matches_model_path's shape."""
    b, s, h, p, n = 2, 128, 4, 32, 16
    (jx, x), (jdt, dt), (jal, a_log), (jB, B), (jC, C) = _model_inputs(
        b, s, h, p, n, seed=7)
    jy, jst = jssd_fused(jx, jdt, jal, jB, jC, chunk=32, interpret=True)
    y, st = ssd_ops.ssd_scan_fused(x, dt, a_log, B, C, chunk=32)
    _close(y, jy, KERNEL_TOL)
    _close(st, jst, KERNEL_TOL)
    yr, sr = ssd_ops.ssd_scan_recurrence(x, dt, a_log, B, C)
    _close(yr, jy, KERNEL_TOL)
    _close(sr, jst, KERNEL_TOL)


def test_fold_heads_is_the_jax_wrappers_layout():
    """B/C broadcast over the heads and x/dt transposed, as the JAX wrapper
    builds its kernel's inputs (the CUDA kernel indexes instead)."""
    (_, x), (_, dt), (_, a_log), (_, B), (_, C) = _model_inputs(
        2, 5, 3, 4, 6, seed=8)
    xf, dtf, af, Bf, Cf = ssd_ops.fold_heads(
        x, dt, ssd_ops.decay_rates(a_log), B, C)
    for bh in range(6):
        bi, hi = divmod(bh, 3)
        assert torch.equal(xf[bh], x[bi, :, hi])
        assert torch.equal(dtf[bh], dt[bi, :, hi])
        assert torch.equal(Bf[bh], B[bi]) and torch.equal(Cf[bh], C[bi])
        assert float(af[bh]) == -float(torch.exp(a_log[hi]))


def test_kernel_wrapper_takes_cuda_tensors_only():
    """The wrapper launches on the card or raises: a CPU tensor never
    reaches it by accident, and no launch is counted."""
    (_, x), (_, dt), (_, a_log), (_, B), (_, C) = _model_inputs(
        1, 8, 2, 4, 4)
    before = dict(ssd_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan_kernel(x, dt, ssd_ops.decay_rates(a_log), B, C)
    ssd_ops.ssd_scan_fused(x, dt, a_log, B, C, chunk=4)
    assert ssd_kernel.launches == before


# ------------------------------------------------------------ conv, block ----

def test_conv1d_causal_whole_and_streaming_match_jax():
    (jx, x), (jw, w), (jb, b) = _pair(((2, 10, 6), 1.0, ""),
                                      ((4, 6), 0.2, ""), ((6,), 0.1, ""),
                                      seed=11)
    out, cache = tssm._conv1d_causal(x, w, b)
    jout, jcache = jssm._conv1d_causal(jx, jw, jb)
    _close(out, jout)
    _close(cache, jcache)
    c, jc = None, None
    for t in range(10):
        o, c = tssm._conv1d_causal(x[:, t:t + 1], w, b, c)
        jo, jc = jssm._conv1d_causal(jx[:, t:t + 1], jw, jb, jc)
        _close(o, jo)
        _close(o, out[:, t:t + 1])
        _close(c, jc)


@pytest.fixture(scope="module")
def mixer():
    """Reduced mamba2-370m in fp32 with 4-position chunks: the config, the
    JAX layer-0 mixer params and the port's, holding the same values."""
    jarch = jconfigs.get_reduced("mamba2-370m")
    jarch = jarch.replace(model=jarch.model.replace(dtype="float32",
                                                    ssm_chunk=4))
    arch = tconfigs.get_reduced("mamba2-370m")
    arch = arch.replace(model=arch.model.replace(dtype="float32",
                                                 ssm_chunk=4))
    params = jbuild(jarch).init(jax.random.key(3))
    model = params_from_numpy(jax.tree.map(np.asarray, params), arch,
                              device="cpu")
    jp = jax.tree.map(lambda a: a[0], params["blocks"])["mixer"]
    return arch.model, jp, tfm.layer(model.params, 0)["mixer"]


def test_mamba2_block_full_matches_jax(mixer):
    cfg, jp, tp = mixer
    (jx, x), = _pair(((2, 11, cfg.d_model), 1.0, ""), seed=12)
    _close(tssm.mamba2_block(x, tp, cfg), jssm.mamba2_block(jx, jp, cfg))


def test_mamba2_block_with_cache_matches_jax_leaf_by_leaf(mixer):
    """A chunked pass over a prompt from an empty cache, then single steps:
    output and every cache leaf equal JAX's after each call."""
    cfg, jp, tp = mixer
    (jx, x), = _pair(((2, 13, cfg.d_model), 1.0, ""), seed=13)
    cache = tssm.init_ssm_cache(cfg, 2, "float32")
    jcache = jssm.init_ssm_cache(cfg, 2, jnp.float32)
    assert cache.keys() == jcache.keys() == set(tssm.CACHE_LEAVES)
    out, cache = tssm.mamba2_block(x[:, :9], tp, cfg, cache=cache)
    jout, jcache = jssm.mamba2_block(jx[:, :9], jp, cfg, cache=jcache)
    _close(out, jout)
    for t in range(9, 13):
        out, cache = tssm.mamba2_block(x[:, t:t + 1], tp, cfg, cache=cache,
                                       single_step=True)
        jout, jcache = jssm.mamba2_block(jx[:, t:t + 1], jp, cfg,
                                         cache=jcache, single_step=True)
        _close(out, jout)
        for k in tssm.CACHE_LEAVES:
            assert cache[k].dtype == (torch.float32)
            _close(cache[k], jcache[k])
    # the single steps continue the chunked pass: the whole block agrees
    _close(out, tssm.mamba2_block(x, tp, cfg)[:, -1:])


# ------------------------------------------- the kernel's chunk plumbing ----

def _three_pass(x, dt, A, B, C, init):
    """The CUDA kernel's algebra in plain torch on the model's layout, in
    its own 64-position chunks with the tail padded by dt = 0, x = 0:
    (1) G = C B^T per (b, chunk), shared by the heads; (2) per (b, chunk,
    head) y_diag = (G o L)(x dt) and the chunk's own state S_c; (3) per
    (b, head) the chunks in order, y += exp(cum) C S_prev^T and S_prev <-
    exp(cum_end) S_prev + S_c."""
    b, s, h, p = x.shape
    n, L = B.shape[-1], ssd_kernel.CHUNK
    nc = ssd_kernel.n_chunks(s)
    pad = nc * L - s
    xp, dtp, Bp, Cp = (torch.nn.functional.pad(t, (0,) * (2 * (t.dim() - 2))
                                               + (0, pad))
                       for t in (x, dt, B, C))
    xc = xp.reshape(b, nc, L, h, p)
    dtc = dtp.reshape(b, nc, L, h)
    Bc, Cc = Bp.reshape(b, nc, L, n), Cp.reshape(b, nc, L, n)
    cum = torch.cumsum(dtc * A, dim=2)                       # (b,nc,L,h)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)              # once per chunk
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b,nc,i,j,h)
    lower = torch.tril(torch.ones(L, L, dtype=torch.bool))[None, None, :, :,
                                                          None]
    Lmat = torch.where(lower, torch.exp(torch.where(lower, diff, 0.0)), 0.0)
    xdt = xc * dtc[..., None]
    y = torch.einsum("bcij,bcijh,bcjhp->bcihp", G, Lmat, xdt)
    w = torch.exp(cum[:, :, -1:, :] - cum)                   # (b,nc,L,h)
    Sc = torch.einsum("bclh,bclhp,bcln->bchpn", w, xdt, Bc)
    S = init.clone()
    for c in range(nc):
        y[:, c] += torch.exp(cum[:, c])[..., None] * torch.einsum(
            "bln,bhpn->blhp", Cc[:, c], S)
        S = torch.exp(cum[:, c, -1])[..., None, None] * S + Sc[:, c]
    return y.reshape(b, nc * L, h, p)[:, :s], S


@pytest.mark.parametrize("s", [1, 47, 64, 65, 130])
def test_kernel_three_pass_algebra_matches_recurrence(s):
    """The kernel's decomposition -- ragged tail, shared C B^T, chunk
    states, serial state pass from an initial state -- is the recurrence
    (float64, so only the algebra is held)."""
    b, h, p, n = 2, 3, 4, 5
    (_, x), (_, dt), (_, a_log), (_, B), (_, C) = _model_inputs(
        b, s, h, p, n, seed=s)
    x, dt, a_log, B, C = (t.double() for t in (x, dt, a_log, B, C))
    init = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (b, h, p, n)))
    y, st = _three_pass(x, dt, ssd_ops.decay_rates(a_log), B, C, init)
    yr, sr = ssd_ops.ssd_scan_recurrence(x, dt, a_log, B, C, init)
    torch.testing.assert_close(y, yr, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(st, sr, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("s,want", [(0, 0), (1, 1), (64, 1), (65, 2),
                                    (512, 8), (575, 9), (2048, 32)])
def test_kernel_chunk_count(s, want):
    assert ssd_kernel.n_chunks(s) == want


def test_kernel_scratch_size():
    """Each (b, h, chunk)'s state with p and n padded to multiples of 32
    (the accumulators' order), C B^T per (b, chunk), a decay per (b, h,
    chunk)."""
    assert ssd_kernel.scratch_floats(8, 512, 32, 64, 128) == (
        8 * 32 * 8 * 64 * 128 + 8 * 8 * 64 * 64 + 8 * 32 * 8)
    assert ssd_kernel.scratch_floats(3, 96, 1, 16, 8) == (
        3 * 1 * 2 * 32 * 32 + 3 * 2 * 64 * 64 + 3 * 1 * 2)
    assert ssd_kernel.scratch_floats(2, 0, 4, 64, 64) == 0


@pytest.mark.parametrize("b,s,h,want", [
    (2, 575, 32, 576), (8, 512, 32, 2048), (4, 47, 32, 128),
    (2, 575, 80, 1440), (4, 47, 80, 320),
])
def test_kernel_chunk_blocks(b, s, h, want):
    """The chunk and output kernels take a block per (b, chunk, head): at
    b 2, s 575 with mamba2 heads 576, over two per SM of an H100, where
    the kernel they replaced took one per (b, head), 64."""
    assert b * ssd_kernel.n_chunks(s) * h == want
    if (b, s, h) == (2, 575, 32):
        assert want >= 2 * 132 > b * h


def test_kernel_aligned16_reads_the_layout():
    """16-byte copies only where the row, every stride and the address
    are multiples of 16 bytes."""
    x = torch.zeros(2, 10, 3, 64)
    assert ssd_kernel.aligned16(x)
    assert ssd_kernel.aligned16(torch.zeros(2, 10, 8, dtype=torch.bfloat16))
    assert not ssd_kernel.aligned16(torch.zeros(2, 10, 6))
    assert not ssd_kernel.aligned16(torch.zeros(2, 10, 9)[:, :, 1:])
    assert ssd_kernel.aligned16(torch.zeros(2, 10, 8)[:, 4:])
