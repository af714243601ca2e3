"""mamba2-370m [ssm] — 48L d_model=1024, attention-free, ssm_state=128,
vocab=50280. SSD (state-space duality) chunked scan. [arXiv:2405.21060]

d_inner = 2*1024 = 2048, 32 SSD heads of dim 64.  Attention-free -> runs all
four shapes including long_500k.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingRules, TrainConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
    ),
    sharding=ShardingRules(heads="model", ff="model", vocab="model",
                           fsdp_axis="data", dp_over_model=True),
    train=TrainConfig(remat="full"),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(model=CONFIG.model.replace(
        num_layers=2, d_model=64, vocab_size=256, ssm_state=16, ssm_head_dim=16))
