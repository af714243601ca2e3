"""phi3-medium-14b [dense] — 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352. RoPE + SwiGLU + GQA. [arXiv:2404.14219; unverified]"""
from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingRules, TrainConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        vocab_size=100352,
        rope_theta=10_000.0,
    ),
    sharding=ShardingRules(heads="model", ff="model", vocab="model",
                           seq="model", fsdp_axis="data", kv_seq="model"),
    train=TrainConfig(remat="full", comm_pattern="scatter_reduce"),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(model=CONFIG.model.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256))
