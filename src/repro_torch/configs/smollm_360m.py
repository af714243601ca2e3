"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]

15 heads do not divide model=16: heads replicated, ff/vocab TP-sharded
(2560/16=160, 49152/16=3072).
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingRules, TrainConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49152,
        rope_theta=10_000.0,
    ),
    sharding=ShardingRules(heads=None, ff="model", vocab="model",
                           fsdp_axis="data", kv_seq="model",
                           dp_over_model=True),
    train=TrainConfig(remat="full"),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(model=CONFIG.model.replace(
        num_layers=2, d_model=60, num_heads=3, num_kv_heads=1, head_dim=20,
        d_ff=128, vocab_size=256))
