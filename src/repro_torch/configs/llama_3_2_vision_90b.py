"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attention image layers. [hf:meta-llama/Llama-3.2-11B-Vision]

100 layers = 20 groups of (4 self-attn + 1 cross-attn).  The vision frontend
is a STUB: ``input_specs()`` provides precomputed patch embeddings of shape
(batch, num_image_tokens=1024, d_model) that the cross-attn layers attend to.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingRules, TrainConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        cross_attn_every=5,
        num_image_tokens=1024,
        rope_theta=500_000.0,
    ),
    sharding=ShardingRules(heads="model", ff="model", vocab="model",
                           seq="model", fsdp_axis="data", kv_seq="model"),
    train=TrainConfig(remat="full", comm_pattern="scatter_reduce",
                      micro_batches=4),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(model=CONFIG.model.replace(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, cross_attn_every=2, num_image_tokens=16))
