"""stablelm-3b [dense] — 32L d_model=2560 32H (MHA, kv=32) d_ff=6912
vocab=50304. [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingRules, TrainConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="stablelm-3b",
        family="dense",
        num_layers=32,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        vocab_size=50304,
        rope_theta=10_000.0,
    ),
    sharding=ShardingRules(heads="model", ff="model", vocab="model",
                           fsdp_axis="data", kv_seq=None,
                           dp_over_model=True),
    train=TrainConfig(remat="full"),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(model=CONFIG.model.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256))
