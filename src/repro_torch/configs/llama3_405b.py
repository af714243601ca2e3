"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. [arXiv:2407.21783; unverified]
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingRules, TrainConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="llama3-405b",
        family="dense",
        num_layers=126,
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab_size=128256,
        rope_theta=500_000.0,
    ),
    sharding=ShardingRules(heads="model", ff="model", vocab="model",
                           seq="model", fsdp_axis="data", kv_seq="model"),
    train=TrainConfig(optimizer="adamw8bit", remat="full",
                      comm_pattern="scatter_reduce", micro_batches=4),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(model=CONFIG.model.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256))
