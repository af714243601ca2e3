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
both on the card.
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
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)                                 # entering state
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                        # (b,nc,h,p,n)

    # 4) carry-in contribution: y_off[l] = C_l . (exp(cum[l]) S_prev)
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, prev, torch.exp(cum))
    return (y_diag + y_off).reshape(b, s, h, p), carry
