"""zamba2-2.7b [hybrid] — 54 Mamba2 layers d_model=2560 + shared attention
block (32H MHA, d_ff=10240) applied every 6 layers; ssm_state=64; vocab=32000.
[arXiv:2411.15242; hf]

The attention block's weights are SHARED across all 9 applications (Zamba2's
defining trick); we scan over 9 groups of (6 mamba layers + 1 shared-attn
application).  Hybrid -> runs long_500k.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingRules, TrainConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        attn_every=6,
        rope_theta=10_000.0,
    ),
    sharding=ShardingRules(heads="model", ff="model", vocab="model",
                           fsdp_axis="data", kv_seq=None,
                           dp_over_model=True),
    train=TrainConfig(remat="full"),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(model=CONFIG.model.replace(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16, attn_every=2))
