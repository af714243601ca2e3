"""Analytic per-step serving latency from zoo arch dims + platform constants.

The port's copy of the JAX package's ``serving/latency.py`` (pure Python).
One ``LatencyModel`` prices the decode steps the real ``Generator`` counts
(``Generator.simulated_latency_s``); the discrete-event serving simulator
that shares it in the JAX package is ROADMAP.md queue A5.

The model is the standard decode roofline: a step over a batch of B
requests costs

    step_s(B) = max( B * 2 * n_params / flops,        # compute-bound
                     model_bytes / mem_bandwidth )    # weight-streaming floor

and a request of (prompt_len, new_tokens) runs ``prompt_len + new_tokens``
decode steps — exactly the loop ``Generator._prefill_loop`` + ``generate``
executes, which is what the parity test pins.

KV-cache footprint (the continuous-batching packing constraint) comes from
the config dims: per-token K+V bytes for attention families, the MLA latent
for DeepSeek, and a constant per-request SSM state for mamba-style archs.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["LatencyModel"]

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass(frozen=True)
class LatencyModel:
    arch: str                 # spec-friendly name, e.g. "smollm_360m"
    n_params: int
    flops: float              # replica FLOP/s (platform serving hook)
    mem_bandwidth: float      # replica bytes/s   (platform serving hook)
    kv_bytes_token: int       # per token, across all layers
    kv_bytes_const: int = 0   # per request (SSM/conv state)
    param_bytes: int = 2      # serving dtype width

    # ------------------------------------------------------------- sizing --
    @property
    def model_bytes(self) -> int:
        return self.n_params * self.param_bytes

    def kv_bytes(self, tokens: int) -> int:
        """Cache bytes one request holds after ``tokens`` positions."""
        return self.kv_bytes_const + self.kv_bytes_token * tokens

    # ------------------------------------------------------------- timing --
    def step_s(self, batch: int = 1) -> float:
        """One decode step over a batch: compute vs weight-streaming roofline."""
        if batch < 1:
            raise ValueError("batch must be >= 1")
        compute = batch * 2.0 * self.n_params / self.flops
        streaming = self.model_bytes / self.mem_bandwidth
        return max(compute, streaming)

    def request_steps(self, prompt_len: int, new_tokens: int) -> int:
        """Decode-step count for one request — mirrors Generator's loop
        (token-by-token prefill + new_tokens decode steps)."""
        return prompt_len + new_tokens

    def service_s(self, prompt_len: int, new_tokens: int,
                  batch: int = 1) -> float:
        return self.request_steps(prompt_len, new_tokens) * self.step_s(batch)

    # -------------------------------------------------------- construction --
    @classmethod
    def from_arch(cls, name: str, *, flops: float, mem_bandwidth: float,
                  reduced: bool = False) -> "LatencyModel":
        """Build from a zoo arch (accepts ``smollm_360m`` or ``smollm-360m``).
        The parameter count comes from the port's model spec, so the
        families the port builds (dense, ssm, hybrid) are the ones it can
        size; the others raise ``NotImplementedError``."""
        from repro_torch.configs import arch_key, get_arch, get_reduced
        from repro_torch.models.common import param_count
        from repro_torch.models.transformer import model_spec

        arch_id = arch_key(name) or name
        arch = get_reduced(arch_id) if reduced else get_arch(arch_id)
        m = arch.model
        if not m.supports_decode:
            raise ValueError(f"{name!r} is encoder-only; it cannot serve decode")
        dtype_b = _DTYPE_BYTES.get(m.dtype, 2)

        per_token, const = 0, 0
        if m.family == "ssm":
            const = m.num_layers * (m.d_inner * (m.ssm_state + m.conv_width)) * dtype_b
        else:
            attn_layers = m.num_layers
            if m.family == "hybrid" and m.attn_every:
                attn_layers = m.num_layers // m.attn_every
                const = m.num_layers * (m.d_inner * (m.ssm_state + m.conv_width)) * dtype_b
            if m.use_mla:
                per_layer = m.kv_lora_rank + m.qk_rope_head_dim
            else:
                per_layer = 2 * m.kv_heads * m.hdim
            per_token = attn_layers * per_layer * dtype_b

        return cls(arch=name.replace("-", "_").replace(".", "_"),
                   n_params=param_count(model_spec(m)),
                   flops=float(flops), mem_bandwidth=float(mem_bandwidth),
                   kv_bytes_token=per_token, kv_bytes_const=const,
                   param_bytes=dtype_b)
