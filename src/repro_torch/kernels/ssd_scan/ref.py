"""Plain PyTorch versions of the Mamba-2 SSD scan: the one statement of the
scan's math in the port.

``ssd_scan_ref`` is the exact sequential state recurrence on the folded
layout (the JAX package's ``kernels/ssd_scan/ref.py``):

    S_t = exp(dt_t * A) * S_{t-1} + dt_t * x_t B_t^T
    y_t = S_t C_t

``ssd_scan_chunked`` is the chunked dual form on the model's layout (the
JAX model's ``models/ssm.ssd_scan``, with its precision policy and its
one-chunk fallback).  ``ops`` runs the chunked version for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernel of ``csrc/ssd_scan.cu`` against
both on the card.  Autograd of ``ssd_scan_chunked`` is the plain gradient.

``ssd_scan_chunked_bwd`` states the same gradient in closed form, as the
backward kernel of ``csrc/ssd_scan_bwd.cu`` computes it: the decay math in
float64, the cotangents rounded to the input dtype at the five places
where autograd of the forward's ``.to(cdt).float()`` pairs rounds them.
"""
from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, a, B, C, init_state=None):
    """x (bh, s, p); dt (bh, s); a (bh,) negative; B/C (bh, s, n);
    init_state (bh, p, n) or None (zeros) -> (y (bh, s, p) in x's dtype,
    final state (bh, p, n) fp32).  Float64 inputs run in float64 (a
    reference for the rounding of the fp32 versions)."""
    bh, s, p = x.shape
    ct = torch.promote_types(x.dtype, torch.float32)
    xf, dtf, af = x.to(ct), dt.to(ct), a.to(ct)
    st = (torch.zeros((bh, p, B.shape[-1]), dtype=ct, device=x.device)
          if init_state is None else init_state.to(ct).clone())
    ys = []
    for t in range(s):
        dec = torch.exp(dtf[:, t] * af)[:, None, None]
        upd = torch.einsum("bp,bn->bpn", xf[:, t] * dtf[:, t, None],
                           B[:, t].to(ct))
        st = st * dec + upd
        ys.append(torch.einsum("bpn,bn->bp", st, C[:, t].to(ct)))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((bh, 0, p), dtype=ct, device=x.device))
    return y.to(x.dtype), st


def segsum(a):
    """(..., l) -> (..., l, l) lower-triangular segment sums; -inf above
    the diagonal."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return ss.masked_fill(~mask, float("-inf"))


def ssd_scan_chunked(x, dt, a_log, B, C, chunk: int, init_state=None):
    """Chunked SSD.  x (b, s, h, p); dt (b, s, h) >= 0 (post-softplus);
    a_log (h,), A = -exp(a_log); B/C (b, s, n) -> (y (b, s, h, p) fp32,
    final state (b, h, p, n) fp32).

    The JAX model's precision policy: decay math and the state stay fp32;
    the big (b, s, ...) tensors carried between products keep the input
    dtype, and the products accumulate in fp32 (bf16 operands are widened
    to fp32 exactly, which is XLA's ``preferred_element_type=f32``).  A
    length that ``chunk`` does not divide runs as one chunk of length s.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk != 0:
        chunk = s
    nc = s // chunk
    cdt = x.dtype
    A = -torch.exp(a_log.float())                          # (h,)
    da = dt.float() * A                                    # (b,s,h)
    xb = (x.float() * dt.float()[..., None]).to(cdt)
    xc = xb.reshape(b, nc, chunk, h, p).float()
    dac = da.reshape(b, nc, chunk, h)
    Bc = B.to(cdt).reshape(b, nc, chunk, n).float()
    Cc = C.to(cdt).reshape(b, nc, chunk, n).float()
    cum = torch.cumsum(dac, dim=2)                         # (b,nc,l,h)

    # 1) intra-chunk: y_diag[l] = sum_{m<=l} (C_l.B_m) L[l,m] x_m
    L = torch.exp(segsum(dac.permute(0, 1, 3, 2)))         # (b,nc,h,l,m)
    scores = torch.einsum("bcln,bcmn->bclm", Cc, Bc)
    y_diag = torch.einsum("bchlm,bcmhp->bclhp",
                          (scores[:, :, None] * L).to(cdt).float(), xc)

    # 2) chunk-final states: S_c = sum_m exp(sum_{j>m} da_j) B_m x_m^T
    dec_end = torch.exp(cum[:, :, -1:, :] - cum).to(cdt).float()
    states = torch.einsum("bclh,bcln,bclhp->bchpn", dec_end, Bc, xc)

    # 3) inter-chunk recurrence (fp32 (b,h,p,n) state)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (b,nc,h)
    prev, carry = _entering_states(states, chunk_decay, init_state)

    # 4) carry-in contribution: y_off[l] = C_l . (exp(cum[l]) S_prev)
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, prev, torch.exp(cum))
    return (y_diag + y_off).reshape(b, s, h, p), carry


def _entering_states(states, chunk_decay, init_state):
    """The inter-chunk recurrence: states (b, nc, h, p, n), chunk_decay
    (b, nc, h) -> (each chunk's entering state (b, nc, h, p, n), the final
    state (b, h, p, n)), fp32 from ``init_state`` (None: zeros)."""
    b, nc, h, p, n = states.shape
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32,
                         device=states.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)                                 # entering state
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    return torch.stack(prev, dim=1), carry


def _exclusive_cumsum(t, dim):
    return torch.cumsum(t, dim) - t


def _reverse_cumsum(t, dim):
    return torch.flip(torch.cumsum(torch.flip(t, (dim,)), dim), (dim,))


def ssd_scan_chunked_bwd(x, dt, a_log, B, C, chunk: int, init_state, dy,
                         dstate):
    """The gradient of :func:`ssd_scan_chunked` in closed form: the
    cotangents dy (b, s, h, p) of y and dstate (b, h, p, n) of the final
    state (either None: zeros) -> (dx in x's dtype, ddt fp32, da_log fp32,
    dB and dC in B's dtype, d init_state fp32 or None).

    Per chunk (cum the inclusive cumsum of da = dt A, l the chunk's last
    position; M = round(C B^T o L), W = exp(cum_l - cum), e = exp(cum)):
    the state gradient runs backwards over the chunks, G_c = dstate and
    G_{c-1} = exp(cum_l) G_c + sum_t e_t dy_t C_t^T, and within a chunk

        d xc  = M^T dy + W (B G^T)           d M = dy xc^T      (m <= l)
        d B   = W xc G + (dM o L)^T C        d W = sum_p xc (B G^T)
        d C   = e (dy S_prev) + (dM o L) B   d e = sum_n C (dy S_prev)

    d da_t sums the segments that contain t: sum_{l >= t > m} dM C B^T o
    L, sum_{l < t} dW W, sum_{l >= t} de e and d exp(cum_l) exp(cum_l),
    each in float64 from fp32 products, with no cancelling reverse
    cumsum.  cum, L, W and e are float64 until rounded to fp32.  In bf16
    the cotangents of x dt, B, C, the masked scores and W round to bf16 as
    autograd of the forward rounds them (``rnd``); in fp32 ``rnd`` is the
    identity.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk != 0:
        chunk = s
    nc, l = s // chunk, chunk
    cdt = x.dtype

    def rnd(t):                                  # a rounding point
        return t.to(cdt).float()

    A = -torch.exp(a_log.float())
    dtf = dt.float()
    xc = rnd(x.float() * dtf[..., None]).reshape(b, nc, l, h, p)
    Bc = rnd(B).reshape(b, nc, l, n)
    Cc = rnd(C).reshape(b, nc, l, n)
    dyc = (torch.zeros((b, s, h, p), dtype=torch.float32, device=x.device)
           if dy is None else dy.float()).reshape(b, nc, l, h, p)
    # the decay math in float64
    cum = torch.cumsum((dtf.double() * A.double()).reshape(b, nc, l, h), 2)
    e = torch.exp(cum).float()                             # (b,nc,l,h)
    W = torch.exp(cum[:, :, -1:] - cum).float()
    Wr = rnd(W)
    cd = torch.exp(cum[:, :, -1]).float()                  # (b,nc,h)
    lower = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    ct = cum.permute(0, 1, 3, 2)                           # (b,nc,h,l)
    Lm = torch.exp((ct[..., :, None] - ct[..., None, :]).masked_fill(
        ~lower, float("-inf"))).float()                    # (b,nc,h,l,m)

    # the chunks' entering states, as the forward computes them
    cum32 = torch.cumsum((dtf * A).reshape(b, nc, l, h), dim=2)
    dec_end = rnd(torch.exp(cum32[:, :, -1:, :] - cum32))
    states = torch.einsum("bclh,bcln,bclhp->bchpn", dec_end, Bc, xc)
    prev, _ = _entering_states(states, torch.exp(cum32[:, :, -1, :]),
                               init_state)

    # the state gradient, backwards over the chunks
    dSl = torch.einsum("bclhp,bclh,bcln->bchpn", dyc, e, Cc)
    G = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if dstate is None else dstate.float())
    Gs = [None] * nc
    for c in reversed(range(nc)):
        Gs[c] = G
        G = G * cd[:, c, :, None, None] + dSl[:, c]
    Gs = torch.stack(Gs, dim=1)                            # (b,nc,h,p,n)
    dinit = None if init_state is None else G

    # y_off = e (C S_prev^T)
    Z = torch.einsum("bclhp,bchpn->bclhn", dyc, prev)
    dE = torch.einsum("bclhn,bcln->bclh", Z, Cc)
    dCc = torch.einsum("bclhn,bclh->bcln", Z, e)
    dcd = (Gs * prev).sum((-2, -1))                        # (b,nc,h)
    # S_c = (W xc)^T B
    BG = torch.einsum("bcln,bchpn->bclhp", Bc, Gs)
    dWr = rnd((BG * xc).sum(-1))                           # (b,nc,l,h)
    dxc = BG * Wr[..., None]
    dBc = torch.einsum("bclh,bclhp,bchpn->bcln", Wr, xc, Gs)
    # y_diag = M xc, M = round(C B^T o L)
    scores = torch.einsum("bcln,bcmn->bclm", Cc, Bc)
    M = rnd(scores[:, :, None] * Lm)                       # (b,nc,h,l,m)
    dM = rnd(torch.einsum("bclhp,bcmhp->bchlm", dyc, xc)) * lower
    dxc = dxc + torch.einsum("bchlm,bclhp->bcmhp", M, dyc)
    dsc = dM * Lm
    Q = dM * scores[:, :, None] * Lm
    dBc = dBc + torch.einsum("bchlm,bcln->bcmn", dsc, Cc)
    dCc = dCc + torch.einsum("bchlm,bcmn->bcln", dsc, Bc)

    # d da_t in float64: the segments that contain t
    P = _exclusive_cumsum(Q.double(), -1)                  # sum_{m < t}
    S1 = torch.diagonal(_reverse_cumsum(P, -2), dim1=-2, dim2=-1)
    S1 = S1.permute(0, 1, 3, 2)                            # (b,nc,l,h)
    S2 = _exclusive_cumsum((dWr * W).double(), 2)
    S4 = _reverse_cumsum((dE * e).double(), 2)
    S3 = (dcd * cd).double()[:, :, None, :]
    dda = (S1 + S2 + S3 + S4).float().reshape(b, s, h)

    dxb = rnd(dxc).reshape(b, s, h, p)
    dx = (dxb * dtf[..., None]).to(x.dtype)
    ddt = dda * A + (dxb * x.float()).sum(-1)
    da_log = (dda * dtf).sum((0, 1)) * A
    dB = rnd(dBc).reshape(b, s, n).to(B.dtype)
    dC = rnd(dCc).reshape(b, s, n).to(C.dtype)
    return dx, ddt, da_log, dB, dC, dinit
