"""Capacity-based top-k Mixture-of-Experts with scatter dispatch: the JAX
package's ``models/moe.py`` on one card (no mesh: one group of tokens).

Each token's router gates (an fp32 softmax over the experts) pick its top
K experts -- on equal gates the lower expert index, as ``jax.lax.top_k``
does -- renormalised over the K.  Each expert takes at most C assignments
(``_capacity``), queued token-major; an assignment past C goes to an
overflow slot and contributes nothing.  The experts are SwiGLUs over the
(E, C, d) dispatch buffer, batched products as in the JAX package (which
computes them outside any Pallas kernel); every kept assignment has a slot
of its own in the scatter and the gather, so the results do not depend on
the order of the writes.
Shared experts add a SwiGLU on every token.  The load-balance aux loss
(Switch) counts every assignment, dropped or not.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import spec


def moe_spec(cfg: ModelConfig):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    s = {
        "router": spec((d, e), ("embed", "experts"), d ** -0.5),
        "w_gate": spec((e, d, f), ("experts", "embed", "ff"), d ** -0.5),
        "w_up": spec((e, d, f), ("experts", "embed", "ff"), d ** -0.5),
        "w_down": spec((e, f, d), ("experts", "ff", "embed"),
                       f ** -0.5 / (2 * cfg.num_layers) ** 0.5),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        s["shared"] = {
            "w_gate": spec((d, fs), ("embed", "ff"), d ** -0.5),
            "w_up": spec((d, fs), ("embed", "ff"), d ** -0.5),
            "w_down": spec((fs, d), ("ff", "embed"),
                           fs ** -0.5 / (2 * cfg.num_layers) ** 0.5),
        }
    return s


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    """Assignments an expert takes: int() of the Python float product, at
    least K (the JAX package's arithmetic, on the host)."""
    c = int(tokens_per_group * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    return max(c, cfg.experts_per_token)


def route(gates: torch.Tensor, k: int):
    """gates (T, E) -> (gate_k, idx_k), each (T, k): the k largest gates
    of each row, largest first, by a stable descending sort, so equal
    gates keep the lower expert index first (``jax.lax.top_k``'s rule;
    ``torch.topk`` promises no order among ties)."""
    idx = torch.sort(gates, dim=-1, descending=True, stable=True).indices
    idx = idx[:, :k]
    return gates.gather(-1, idx), idx


def moe_block(x: torch.Tensor, p, cfg: ModelConfig):
    """x (b,s,d) -> (y (b,s,d), aux_loss fp32 scalar); one group of the
    b*s tokens."""
    b, s, d = x.shape
    T = b * s
    E, K = cfg.num_experts, cfg.experts_per_token
    C = _capacity(T, cfg)

    xt = x.reshape(T, d)
    logits = (xt @ p["router"]).float()
    gates = torch.softmax(logits, dim=-1)                         # (T, E)
    gate_k, idx_k = route(gates, K)                               # (T, K)
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): E * sum_e frac_tokens_e * mean_gate_e
    me = gates.mean(dim=0)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device)
    counts.index_add_(0, idx_k.reshape(-1),
                      torch.ones(T * K, dtype=torch.float32, device=x.device))
    aux = E * torch.sum(me * (counts / T / K))

    # queue position of each assignment within its expert (token-major)
    idx_flat = idx_k.reshape(T * K)                               # (A,)
    onehot = F.one_hot(idx_flat, E)                               # (A, E)
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(
        -1, idx_flat[:, None])[:, 0]                              # exclusive
    valid = pos < C
    slot = torch.where(valid, idx_flat * C + pos,
                       torch.full_like(idx_flat, E * C))          # overflow

    # dispatch: scatter-add into (E*C+1, d) zeros; a kept assignment is
    # the only one at its slot (its value exactly), the dropped ones share
    # the overflow row, which is cut off
    upd = xt.repeat_interleave(K, dim=0)                          # (A, d)
    buf = torch.zeros(E * C + 1, d, dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, upd)
    buf = buf[:E * C].reshape(E, C, d)

    # expert compute (SwiGLU)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    out = torch.einsum("ecf,efd->ecd", h, p["w_down"])

    # combine: gather back to tokens, weight by the renormalised gates
    out_flat = torch.cat([out.reshape(E * C, d),
                          torch.zeros(1, d, dtype=out.dtype,
                                      device=out.device)])
    y = out_flat[slot]                                            # (A, d)
    w = (gate_k.reshape(T * K) * valid).to(y.dtype)
    y = (y * w[:, None]).reshape(T, K, d).sum(dim=1)

    if cfg.num_shared_experts:
        sh = p["shared"]
        hs = F.silu(xt @ sh["w_gate"]) * (xt @ sh["w_up"])
        y = y + hs @ sh["w_down"]
    return y.reshape(b, s, d), aux
