"""Mamba2 SSD (state-space duality) block: chunked scan + one-step decode.

The JAX package's ``models/ssm.py`` (Dao & Gu, arXiv:2405.21060): within a
chunk the output is a masked "attention" (C B^T o L) X; across chunks a
small recurrence carries the (heads, head_dim, state) SSM state.
``ssd_scan`` goes through the kernel package, whose ``ops`` picks by the
tensor's device: on the card the CUDA kernel of ``csrc/ssd_scan.cu``, on
the CPU the chunked plain version.  (The JAX model computes the scan in
jnp and never calls its Pallas kernel; the port's model calls its kernel
on CUDA -- the same function, held against the JAX model on the CPU.)
The single-step decode is plain torch on every device, as it is jnp in
the JAX package.

The fused in_proj of the reference CUDA implementation is split into
per-component projections (z/x/B/C/dt), and the depthwise conv likewise,
with the JAX package's parameter keys.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan_fused
from repro_torch.models.common import DTYPES, rms_norm, spec

#: the per-layer decode cache leaves
CACHE_LEAVES = ("conv_x", "conv_B", "conv_C", "state")


def ssm_spec(cfg: ModelConfig):
    d, di, n, hh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.conv_width
    sc = d ** -0.5
    return {
        "in_z": spec((d, di), ("embed", "ff"), sc),
        "in_x": spec((d, di), ("embed", "ff"), sc),
        "in_B": spec((d, n), ("embed", "state"), sc),
        "in_C": spec((d, n), ("embed", "state"), sc),
        "in_dt": spec((d, hh), ("embed", "heads"), sc),
        "conv_x": spec((w, di), ("conv", "ff"), 0.2),
        "conv_x_b": spec((di,), ("ff",), 0.0),
        "conv_B": spec((w, n), ("conv", "state"), 0.2),
        "conv_B_b": spec((n,), ("state",), 0.0),
        "conv_C": spec((w, n), ("conv", "state"), 0.2),
        "conv_C_b": spec((n,), ("state",), 0.0),
        "a_log": spec((hh,), ("heads",), 1.0),   # A = -exp(a_log) ~ -e
        "d_skip": spec((hh,), ("heads",), 1.0),
        "dt_bias": spec((hh,), ("heads",), 0.0),
        "norm": spec((di,), ("ff",), 1.0),
        "out_proj": spec((di, d), ("ff", "embed"),
                         di ** -0.5 / (2 * max(cfg.num_layers, 1)) ** 0.5),
    }


def ssd_scan(x, dt, a_log, B, C, chunk: int, init_state=None):
    """Chunked SSD.  x (b,s,h,p); dt (b,s,h) >= 0 (post-softplus); a_log
    (h,), A = -exp(a_log); B,C (b,s,n).  Returns y (b,s,h,p) fp32 and the
    final state (b,h,p,n) fp32.  On the CPU: the JAX model's precision
    policy and its one-chunk fallback when ``chunk`` does not divide s."""
    return ssd_scan_fused(x, dt, a_log, B, C, chunk=chunk,
                          init_state=init_state)


def _conv1d_causal(x, w, b, cache=None):
    """Depthwise causal conv. x (b,s,c); w (wd,c); cache (b,wd-1,c) or None
    -> (out (b,s,c), new cache: the last wd-1 inputs)."""
    wd = w.shape[0]
    pad = (torch.zeros((x.shape[0], wd - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if cache is None else cache.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    new_cache = xp[:, x.shape[1]:, :]
    s = x.shape[1]
    out = sum(xp[:, i: i + s, :] * w[i][None, None, :] for i in range(wd))
    return out + b[None, None, :], new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: str, device=None):
    """Per-layer decode cache leaves (stacked by the model over layers);
    the conv inputs in ``dtype`` (a config dtype name), the state fp32."""
    w = cfg.conv_width
    dt = DTYPES[dtype]
    return {
        "conv_x": torch.zeros((batch, w - 1, cfg.d_inner), dtype=dt,
                              device=device),
        "conv_B": torch.zeros((batch, w - 1, cfg.ssm_state), dtype=dt,
                              device=device),
        "conv_C": torch.zeros((batch, w - 1, cfg.ssm_state), dtype=dt,
                              device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
    }


def mamba2_block(xin, p, cfg: ModelConfig, cache=None,
                 single_step: bool = False):
    """Mamba2 mixer. xin (b,s,d) -> out (b,s,d) [, new cache if a cache is
    given]."""
    b, s, _d = xin.shape
    di, hh, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z = xin @ p["in_z"]
    xs = xin @ p["in_x"]
    Braw = xin @ p["in_B"]
    Craw = xin @ p["in_C"]
    dt_raw = xin @ p["in_dt"]
    cc = cache or {}
    xs, ncx = _conv1d_causal(xs, p["conv_x"], p["conv_x_b"], cc.get("conv_x"))
    B, ncB = _conv1d_causal(Braw, p["conv_B"], p["conv_B_b"], cc.get("conv_B"))
    C, ncC = _conv1d_causal(Craw, p["conv_C"], p["conv_C_b"], cc.get("conv_C"))
    xs, B, C = F.silu(xs), F.silu(B), F.silu(C)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    xh = xs.reshape(b, s, hh, hp)

    if single_step:
        A = -torch.exp(p["a_log"].float())
        dec = torch.exp(dt[:, 0, :] * A)                      # (b,h)
        st = (cache["state"].float() * dec[:, :, None, None]
              + torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], B[:, 0].float(),
                             xh[:, 0].float()))
        y = torch.einsum("bn,bhpn->bhp", C[:, 0].float(), st)[:, None]
        new_state = st
    else:
        y, new_state = ssd_scan(xh, dt, p["a_log"], B, C, cfg.ssm_chunk,
                                init_state=cc.get("state"))
    y = y + xh.float() * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, s, di).to(xin.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if cache:
        return out, {"conv_x": ncx, "conv_B": ncB, "conv_C": ncC,
                     "state": new_state}
    return out
