"""The SSD scan's gradient in the port, on the CPU.

- ``ref.ssd_scan_chunked_bwd``, the closed form the backward kernel of
  ``csrc/ssd_scan_bwd.cu`` computes, against autograd of
  ``ssd_scan_chunked`` (the plain gradient): in fp32 each gradient within
  ``CLOSED_TOL`` of its largest |g| on test-sized inputs, beyond the plain
  gradient's own error against the float64 recurrence's (the two take the
  decays in float64 and fp32: measured at most 4.6e-7 of the largest |g|
  from float64 for the closed form, and 1.4e-6 for autograd, on da_log, a
  sum whose terms cancel); in bf16, where both round the cotangents at the
  same five points, within ``CLOSED_BF16_TOL`` (measured over nine seeded
  cases: dx equal bit for bit, dB and dC equal or one bf16 rounding apart,
  up to 3.9e-5, ddt 5.4e-6, da_log 5.6e-5, dinit 1.3e-7).  At the model's decay
  rates and long chunks the fp32 cumsum of the plain gradient errs, and
  the closed form must be no further from the float64 recurrence's
  gradient than twice the plain gradient is (the backward kernel's gate on
  the card; measured at most 1.5x, on dinit, and up to 100x nearer on
  da_log).
- Autograd of the port's ``ssd_scan_chunked`` against ``jax.vjp`` of the
  JAX model's ``ssd_scan``: in fp32 within ``VJP_TOL`` of each gradient's
  largest |g| (the same operations summed in other orders) beyond the JAX
  gradient's own error against float64 (at s = 575 da_log reads 1.4e-5,
  the one-chunk fallback's fp32 cumsum: ROADMAP queue C), in bf16
  within ``VJP_BF16_TOL`` (the frameworks round to bf16 from fp32 values
  that differ in their last bits), with and without an initial state, one
  chunk and several, and s = 575 (one chunk of 575 in both packages).
- The plumbing of the CUDA backward that the CPU reaches: each chunk's
  entering state read from the forward's scratch in the accumulators'
  order, and the shared memory its per-chunk launch needs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd_scan_recurrence
from repro_torch.kernels.ssd_scan.ref import (
    ssd_scan_chunked, ssd_scan_chunked_bwd,
)

NAMES = ("dx", "ddt", "da_log", "dB", "dC", "dinit")
CLOSED_TOL = 1e-6
CLOSED_BF16_TOL = 1e-4
VJP_TOL = 1e-5
VJP_BF16_TOL = 2e-2


def _inputs(b, s, h, p, n, *, seed, model_like=False, init=False,
            dtype=torch.float32):
    """x, dt, a_log, B, C, init, dy, dstate as seeded numpy arrays in
    float32 (x, B and C to be cast to ``dtype``): the model's ranges at
    init (``model_like``: dt a softplus of a normal, a_log = 1) or
    tests/test_kernels.py's (|0.2 N|, a_log 0.3 N)."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    x, B, C = f(b, s, h, p), f(b, s, n), f(b, s, n)
    if model_like:
        dt, a_log = np.log1p(np.exp(f(b, s, h))), np.ones(h, np.float32)
    else:
        dt, a_log = np.abs(f(b, s, h) * np.float32(0.2)), f(h) * 0.3
    i = f(b, h, p, n) if init else None
    return dict(x=x, dt=dt.astype(np.float32), a_log=a_log.astype(np.float32),
                B=B, C=C, init=i, dy=f(b, s, h, p), dstate=f(b, h, p, n),
                dtype=dtype)


def _torch(a, dtype):
    t = torch.from_numpy(a.copy())
    return t.to(dtype)


def _port_args(d):
    dt = d["dtype"]
    return (_torch(d["x"], dt), _torch(d["dt"], torch.float32),
            _torch(d["a_log"], torch.float32), _torch(d["B"], dt),
            _torch(d["C"], dt),
            None if d["init"] is None else _torch(d["init"], torch.float32))


def _autograd(d, chunk):
    """Autograd of the port's ``ssd_scan_chunked`` -> gradients by name."""
    x, dt, a_log, B, C, init = _port_args(d)
    leaves = [t.requires_grad_(True) for t in (x, dt, a_log, B, C)]
    wrt = leaves + ([] if init is None else [init.requires_grad_(True)])
    y, st = ssd_scan_chunked(*leaves, chunk, init)
    g = torch.autograd.grad([y, st], wrt, [torch.from_numpy(d["dy"]),
                                          torch.from_numpy(d["dstate"])])
    return dict(zip(NAMES, g))


def _closed(d, chunk):
    x, dt, a_log, B, C, init = _port_args(d)
    g = ssd_scan_chunked_bwd(x, dt, a_log, B, C, chunk, init,
                             torch.from_numpy(d["dy"]),
                             torch.from_numpy(d["dstate"]))
    return {k: v for k, v in zip(NAMES, g) if v is not None}


def _exact(d):
    """The float64 recurrence's gradient at the same inputs."""
    x, dt, a_log, B, C, init = _port_args(d)
    leaves = [t.double().requires_grad_(True) for t in (x, dt, a_log, B, C)]
    il = None if init is None else init.double().requires_grad_(True)
    y, st = ssd_scan_recurrence(*leaves, il)
    g = torch.autograd.grad(
        [y, st], leaves + ([] if il is None else [il]),
        [torch.from_numpy(d["dy"]).double(),
         torch.from_numpy(d["dstate"]).double()])
    return dict(zip(NAMES, g))


def _rel(a, b) -> float:
    b = b.double()
    scale = float(b.abs().max())
    return float((a.double() - b).abs().max()) / (scale or 1.0)


@pytest.mark.parametrize("s,chunk,init", [
    (64, 64, False), (64, 64, True), (64, 16, True), (50, 16, True),
    (47, 47, False)], ids=["one", "one-init", "four-init", "fallback-init",
                           "ragged"])
def test_closed_form_matches_autograd_fp32(s, chunk, init):
    d = _inputs(2, s, 3, 8, 4, seed=s + chunk, init=init)
    got, want, exact = _closed(d, chunk), _autograd(d, chunk), _exact(d)
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].dtype == want[name].dtype
        assert got[name].shape == want[name].shape
        own = _rel(want[name], exact[name])      # the plain gradient's error
        assert _rel(got[name], want[name]) <= CLOSED_TOL + own, name


@pytest.mark.parametrize("s,chunk", [(64, 64), (64, 16), (48, 48)],
                         ids=["one", "four", "ragged"])
def test_closed_form_rounds_bf16_where_autograd_does(s, chunk):
    d = _inputs(2, s, 3, 8, 4, seed=7 + s, init=True, model_like=True,
                dtype=torch.bfloat16)
    got, want = _closed(d, chunk), _autograd(d, chunk)
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        assert _rel(got[name], want[name]) <= CLOSED_BF16_TOL, name


@pytest.mark.parametrize("s,chunk", [(64, 64), (200, 64), (575, 256)],
                         ids=["one", "several", "s575"])
def test_closed_form_is_as_near_float64_as_autograd(s, chunk):
    """Model-like decays (A = -e) over long chunks: the plain gradient's
    fp32 cumsum errs, the closed form's float64 decays do not."""
    d = _inputs(1, s, 2, 16, 8, seed=s, init=True, model_like=True)
    got, auto, exact = _closed(d, chunk), _autograd(d, chunk), _exact(d)
    for name, x in exact.items():
        e_closed = float((got[name].double() - x).abs().max())
        e_auto = float((auto[name].double() - x).abs().max())
        assert e_closed <= 2 * e_auto, (name, e_closed, e_auto)


def _jax_vjp(d, chunk):
    """``jax.vjp`` of the JAX model's ``ssd_scan`` -> gradients by name."""
    jdt = jnp.bfloat16 if d["dtype"] == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(d["x"]).astype(jdt), jnp.asarray(d["dt"]),
            jnp.asarray(d["a_log"]), jnp.asarray(d["B"]).astype(jdt),
            jnp.asarray(d["C"]).astype(jdt)]
    if d["init"] is not None:
        args.append(jnp.asarray(d["init"]))

    def f(*a):
        return jssm.ssd_scan(*a[:5], chunk, a[5] if len(a) > 5 else None)
    _, vjp = jax.vjp(f, *args)
    g = vjp((jnp.asarray(d["dy"]), jnp.asarray(d["dstate"])))
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in zip(NAMES, g)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,chunk,init", [
    (64, 64, False), (64, 64, True), (64, 16, False), (64, 16, True),
    (575, 256, True)], ids=["one", "one-init", "four", "four-init", "s575"])
def test_chunked_autograd_matches_jax_vjp(s, chunk, init, dtype):
    d = _inputs(2, s, 3, 8, 4, seed=3 * s + chunk, init=init, dtype=dtype)
    got, want = _autograd(d, chunk), _jax_vjp(d, chunk)
    assert got.keys() == want.keys()
    exact = _exact(d) if dtype == torch.float32 else None
    for name in got:
        jax_g = torch.from_numpy(want[name].copy())
        # fp32: beyond the JAX gradient's own error against float64 (a
        # chunk of 575 sums its fp32 cumsum to about -90: queue C)
        tol = (VJP_TOL + _rel(jax_g, exact[name]) if exact is not None
               else VJP_BF16_TOL)
        assert _rel(got[name].float(), jax_g) <= tol, name


def _frag_rc(u: int, nn: int):
    """ssd_scan.cu's frag_rc: row and column of float4 u's first value."""
    n8, tile, lane = nn // 8, u >> 5, u & 31
    return 16 * (tile // n8) + (lane >> 2), 8 * (tile % n8) + 2 * (lane & 3)


@pytest.mark.parametrize("b,s,h,p,n", [(2, 130, 3, 40, 20), (1, 64, 1, 64, 128)],
                         ids=["padded", "mamba2-like"])
def test_entering_states_read_the_accumulator_order(b, s, h, p, n):
    nc = ssd_kernel.n_chunks(s)
    pp, nn = -(-p // 32) * 32, -(-n // 32) * 32
    scratch = torch.arange(ssd_kernel.scratch_floats(b, s, h, p, n),
                           dtype=torch.float64)
    got = ssd_kernel.entering_states(scratch, b, s, h, p, n)
    assert got.shape == (b, h, nc, p, n)
    want = torch.full((b, h, nc, pp, nn), -1.0, dtype=torch.float64)
    for u in range(pp * nn // 4):
        r, j = _frag_rc(u, nn)
        for q, (dr, dj) in enumerate(((0, 0), (0, 1), (8, 0), (8, 1))):
            want[:, :, :, r + dr, j + dj] = (
                torch.arange(b * h * nc, dtype=torch.float64).reshape(
                    b, h, nc) * pp * nn + 4 * u + q)
    assert torch.equal(got, want[..., :p, :n])


def test_backward_shared_memory_fits_the_zoo():
    """Every (p, n) up to 128 fits one block of an H100 (232,448 bytes),
    p and n both 128 included; mamba2-370m (p 64, n 128) and zamba2-2.7b
    (64, 64) leave two blocks per SM (228 KB, 1 KB reserved a block): the
    local launch's largest, 91.5 KB at the zoo's p 64."""
    for p, n in ((64, 128), (64, 64), (128, 64), (128, 96), (96, 128),
                 (128, 128), (1, 1), (20, 4)):
        assert ssd_kernel.bwd_smem_bytes(p, n) <= ssd_kernel.MAX_SMEM
    for p, n in ((64, 128), (64, 64)):
        assert 2 * (ssd_kernel.bwd_smem_bytes(p, n) + 1024) <= 228 * 1024
    assert ssd_kernel.bwd_smem_bytes(64, 128) == (
        8 * 6 * 64 + 4 * (3 * 64 * 72 + 2 * 64 * 68 + 2 * 64))


# ------------------------------------- the backward kernel's decomposition ----
#
# csrc/ssd_scan_bwd.cu computes C B^T once per (b, chunk) (its gram
# launch), writes each head's dM o L (its local launch, one block a head),
# adds the heads' in head order in float64 and takes (dM o L)^T C and (dM
# o L) B once per (b, chunk) (its dbc launch, with the terms launch's
# per-head W xc G and e Z), and takes the segment sums of dda as a scan
# over the row and column sums of the strictly lower triangle of Q = dM C
# B^T o L.
# Every product runs as mma.sync m16n8k8 over 64-row tiles, 16 rows a
# warp.

def _rectangle_scan(Q: torch.Tensor) -> torch.Tensor:
    """The kernel's segment sums of Q (..., l, l): R_0 = 0, R_{t+1} = R_t -
    row_t + col_t, row_t the sum of Q[t, :t], col_t that of Q[t+1:, t]."""
    l = Q.shape[-1]
    strict = Q.tril(-1)
    d = strict.sum(-2) - strict.sum(-1)          # col_t - row_t
    return torch.cumsum(d, -1) - d               # exclusive


def _kernel_decomposition(d):
    """(dx, ddt, da_log, dB, dC) computed as the kernel's launches compose
    them, at its 64-position chunks, from the closed form's per-chunk
    pieces; fp32 products, float64 decays and segment sums."""
    x, dt, a_log, B, C, init = _port_args(d)
    b, s, h, p = x.shape
    n = B.shape[-1]
    cdt = x.dtype
    rnd = lambda t: t.to(cdt).float()  # noqa: E731
    dy = torch.from_numpy(d["dy"])
    A = -torch.exp(a_log.float())
    dtf = dt.float()
    out = {k: [] for k in ("dx", "ddt", "dda", "dB", "dC")}
    # the terms of S_prev and G come from the closed form's state pass
    # (launches 1-3), here by running it on each chunk's inputs
    for c0 in range(0, s, 64):
        sl = slice(c0, min(c0 + 64, s))
        l = sl.stop - c0
        cum = torch.cumsum((dtf[:, sl].double() * A.double()), 1)  # (b,l,h)
        lower = torch.ones(l, l, dtype=torch.bool).tril()
        ct = cum.permute(0, 2, 1)                               # (b,h,l)
        Lm = torch.exp((ct[..., :, None] - ct[..., None, :]).masked_fill(
            ~lower, float("-inf"))).float()                     # (b,h,l,m)
        xc = rnd(x[:, sl].float() * dtf[:, sl, :, None])
        Bc, Cc, dyc = rnd(B[:, sl]), rnd(C[:, sl]), dy[:, sl]
        gram = Cc @ Bc.transpose(1, 2)                          # once
        total = torch.zeros(b, l, l, dtype=torch.float64)
        dx, ddt, dda = (torch.empty(b, l, h, p), torch.empty(b, l, h),
                        torch.empty(b, l, h))
        for hh in range(h):                                     # head order
            dM = rnd(dyc[:, :, hh] @ xc[:, :, hh].transpose(1, 2)) * lower
            M = rnd(gram * Lm[:, hh])
            total = total + (dM * Lm[:, hh]).double()
            Q = (dM * gram * Lm[:, hh]).double()
            dda[:, :, hh] = _rectangle_scan(Q).float()
            dxc = rnd(M.transpose(1, 2) @ dyc[:, :, hh])
            dx[:, :, hh] = (dxc * dtf[:, sl, hh, None]).to(cdt).float()
            dd = (dxc * x[:, sl, hh].float()).sum(-1)
            ddt[:, :, hh] = dda[:, :, hh] * A[hh] + dd
        total = total.float()                                   # rounded once
        dB, dC = total.transpose(1, 2) @ Cc, total @ Bc         # once
        for k, v in (("dx", dx), ("ddt", ddt), ("dda", dda),
                     ("dB", rnd(dB)), ("dC", rnd(dC))):
            out[k].append(v)
    cat = {k: torch.cat(v, 1) for k, v in out.items()}
    da_log = (cat["dda"] * dtf).sum((0, 1)) * A
    return {"dx": cat["dx"].to(cdt), "ddt": cat["ddt"], "da_log": da_log,
            "dB": cat["dB"].to(cdt), "dC": cat["dC"].to(cdt)}


def test_rectangle_scan_is_the_closed_forms_segment_sums():
    """R_t = sum_{r >= t} sum_{m < t} Q[r, m], as the closed form takes it
    (a reverse cumsum of exclusive row cumsums), to float64 rounding."""
    rng = np.random.default_rng(4)
    Q = torch.from_numpy(rng.standard_normal((3, 64, 64))).tril()
    want = torch.diagonal(torch.flip(torch.cumsum(torch.flip(
        torch.cumsum(Q, -1) - Q, (-2,)), -2), (-2,)), dim1=-2, dim2=-1)
    torch.testing.assert_close(_rectangle_scan(Q), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,n,seed", [
    (2, 64, 4, 16, 8, 133), (2, 64, 4, 16, 8, 134), (1, 47, 6, 8, 12, 56),
    (2, 64, 8, 8, 16, 144)], ids=["heads", "heads-again", "ragged", "eight"])
def test_kernel_decomposition_holds_the_closed_form(b, s, h, p, n, seed,
                                                    dtype):
    """C B^T once per (b, chunk), each head's dM o L added in head order
    in float64, rounded once and multiplied by C and B once per (b,
    chunk), the segment sums as the rectangle scan: the closed
    form's gradient (no state terms: one chunk, no initial state, the
    final state unused), within CLOSED_TOL of each largest |g| in fp32 and
    CLOSED_BF16_TOL in bf16 (the same rounding points)."""
    d = _inputs(b, s, h, p, n, seed=seed, model_like=True, dtype=dtype)
    _hold_decomposition(d, CLOSED_TOL if dtype == torch.float32
                        else CLOSED_BF16_TOL)


def _hold_decomposition(d, tol: float) -> None:
    d["dstate"] = np.zeros_like(d["dstate"])
    got = _kernel_decomposition(d)
    x, dt, a_log, B, C, _ = _port_args(d)
    want = dict(zip(NAMES, ssd_scan_chunked_bwd(
        x, dt, a_log, B, C, 64, None, torch.from_numpy(d["dy"]), None)))
    for name, g in got.items():
        assert g.dtype == want[name].dtype, name
        assert _rel(g.float(), want[name].float()) <= tol, name


@pytest.mark.parametrize("h", [32, 80], ids=["mamba2-heads", "zamba2-heads"])
def test_head_order_sum_holds_at_the_zoos_heads(h):
    """The dB/dC launch adds one dM o L tile a head, 32 (mamba2-370m) or
    80 (zamba2-2.7b) of them, in float64 and rounds once: the closed
    form's fp32 gradient within CLOSED_TOL at those head counts (narrow p
    and n keep it quick)."""
    d = _inputs(1, 64, h, 4, 8, seed=h, model_like=True,
                dtype=torch.float32)
    _hold_decomposition(d, CLOSED_TOL)


def _mma_c_map(r0: int, c0: int, nt: int):
    """(row, column) of acc[j][e] of every lane of a warp_mm strip."""
    return [(r0 + g + 8 * (e >> 1), c0 + 8 * j + 2 * t + (e & 1))
            for lane in range(32) for g, t in [(lane >> 2, lane & 3)]
            for j in range(nt) for e in range(4)]


@pytest.mark.parametrize("warp", range(4))
def test_fragment_maps_cover_the_causal_tiles(warp):
    """warp_mm's C fragment covers the warp's 16 rows x 8 nt columns once;
    the tiles j < 2 warp + 2 of dM (and C B^T) hold every m <= t of its
    rows; M^T dy from k = 16 warp reads every t >= m of its rows m, and (dM
    o L) B up to k = 16 warp + 16 every m <= t."""
    r0 = 16 * warp
    cells = _mma_c_map(r0, 0, 8)
    assert sorted(cells) == [(r, c) for r in range(r0, r0 + 16)
                             for c in range(64)]
    kept = set(_mma_c_map(r0, 0, 2 * warp + 2))
    assert {(r, m) for r in range(r0, r0 + 16) for m in range(r + 1)} <= kept
    assert all(t >= r0 for m in range(r0, r0 + 16) for t in range(m, 64))
    assert all(m < r0 + 16 for t in range(r0, r0 + 16) for m in range(t + 1))
