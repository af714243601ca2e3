"""Config dataclasses for the model zoo, input shapes and distribution.

Every assigned architecture is a `ModelConfig`; every assigned input shape is
a `ShapeConfig`.  `ArchConfig = ModelConfig + ShardingRules + training knobs`
is what the launcher consumes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: int = 0          # 0 -> = num_heads (MHA)
    head_dim: int = 0              # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0           # routed experts; 0 -> dense
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0              # per-expert ff width (0 -> d_ff)
    first_k_dense: int = 0         # leading dense layers (deepseek)
    dense_d_ff: int = 0            # ff width of those dense layers
    capacity_factor: float = 1.25  # lint: ignore[C001] -- MoE capacity, not a price
    # --- MLA (DeepSeek latent attention) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # --- SSM (Mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- hybrid (Zamba2) ---
    attn_every: int = 0            # shared attention block every k SSM layers
    # --- VLM ---
    cross_attn_every: int = 0      # cross-attn layer every k self-attn layers
    num_image_tokens: int = 1024
    # --- encoder-only ---
    is_encoder: bool = False
    # --- misc ---
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    act: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def hdim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    @property
    def subquadratic(self) -> bool:
        """True if the arch can run 500k-token contexts (SSM state or hybrid)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


# The four assigned LM shape cells.
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ShardingRules:
    """Logical-axis -> mesh-axis map. None = replicate.

    `fsdp_axis` additionally shards the largest parameter dim over the data
    axis (classic FSDP-via-GSPMD) when divisible.
    """
    heads: Optional[str] = "model"       # attention head axis
    ff: Optional[str] = "model"          # mlp hidden axis
    vocab: Optional[str] = "model"       # embedding/unembedding vocab axis
    experts: Optional[str] = None        # MoE expert axis (EP)
    embed: Optional[str] = None          # d_model axis of activations
    seq: Optional[str] = None            # activation seq axis (Megatron-style
                                         # sequence parallelism when = "model")
    fsdp_axis: object = "data"           # parameter FSDP axis (str or tuple)
    kv_seq: Optional[str] = None         # decode KV-cache sequence axis
    dp_over_model: bool = False          # small archs: batch over "model" too
                                         # (pure DP; TP mappings ignored)


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop knobs (distribution + optimization)."""
    optimizer: str = "adamw"             # adamw | adamw8bit | sgd
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    micro_batches: int = 1               # grad accumulation
    remat: str = "dots"                  # none | dots | full
    comm_pattern: str = "allreduce"      # allreduce | scatter_reduce
    # paper technique (MA-SGD -> local-SGD / DiLoCo across pods):
    algorithm: str = "ga_sgd"            # ga_sgd | ma_sgd (local sgd) | diloco
    sync_period: int = 1                 # H: inner steps between cross-pod syncs
    outer_lr: float = 0.7                # DiLoCo outer Nesterov lr
    outer_momentum: float = 0.9
    compress_cross_pod: bool = False     # 8-bit gradient/delta compression
    scan_layers: bool = True
    logits_fp32: bool = True


@dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    sharding: ShardingRules = field(default_factory=ShardingRules)
    train: TrainConfig = field(default_factory=TrainConfig)

    @property
    def name(self) -> str:
        return self.model.name

    def shapes(self) -> list[str]:
        """Runnable shape cells for this arch (documented skips applied)."""
        out = ["train_4k", "prefill_32k"]
        if self.model.supports_decode:
            out.append("decode_32k")
            if self.model.subquadratic:
                out.append("long_500k")
        return out

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
