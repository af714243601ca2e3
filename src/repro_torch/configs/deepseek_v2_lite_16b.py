"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408 vocab=102400,
MoE 64 routed experts top-6 + 2 shared, MLA kv_lora=512, first layer dense.
[arXiv:2405.04434; hf]

64 experts divide model=16 -> expert-parallel (4 experts/shard).
MLA: KV compressed to a 512-dim latent + 64-dim decoupled RoPE key; the decode
cache stores the latent (per token), not per-head K/V.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingRules, TrainConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,          # nope part; v_head_dim below
        d_ff=1408,
        moe_d_ff=1408,
        dense_d_ff=10944,
        first_k_dense=1,
        vocab_size=102400,
        num_experts=64,
        experts_per_token=6,
        num_shared_experts=2,
        use_mla=True,
        kv_lora_rank=512,
        qk_rope_head_dim=64,
        qk_nope_head_dim=128,
        v_head_dim=128,
        capacity_factor=1.0,
        rope_theta=10_000.0,
    ),
    sharding=ShardingRules(heads="model", ff="model", vocab="model",
                           experts="model", seq="model",
                           fsdp_axis=("data", "model"), kv_seq="model",
                           dp_over_model=True),
    train=TrainConfig(remat="full", comm_pattern="scatter_reduce"),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(model=CONFIG.model.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=64, moe_d_ff=64, dense_d_ff=128, vocab_size=256,
        num_experts=8, experts_per_token=2, num_shared_experts=1,
        kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16))
