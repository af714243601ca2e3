"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]

8 experts do not divide the model=16 mesh axis, so experts are replicated and
each expert's d_ff is tensor-parallel sharded (32768/16 = 2048/shard).
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingRules, TrainConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        moe_d_ff=32768,
        vocab_size=131072,
        num_experts=8,
        experts_per_token=2,
        rope_theta=10_000.0,
    ),
    sharding=ShardingRules(heads="model", ff="model", vocab="model",
                           experts=None, seq="model", fsdp_axis="data",
                           kv_seq="model"),
    train=TrainConfig(optimizer="adamw8bit", remat="full",
                      comm_pattern="scatter_reduce", micro_batches=4),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(model=CONFIG.model.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, moe_d_ff=128, vocab_size=256, num_experts=4, experts_per_token=2))
