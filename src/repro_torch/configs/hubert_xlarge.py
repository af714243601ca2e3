"""hubert-xlarge [audio] — 48L d_model=1280 16H d_ff=5120 vocab=504.
Encoder-only (bidirectional); same backbone as wav2vec2. [arXiv:2106.07447]

Modality frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings of shape (batch, seq, d_model); training objective is 504-class
masked-frame prediction (HuBERT cluster targets). No decode shapes.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingRules, TrainConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="hubert-xlarge",
        family="encoder",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        is_encoder=True,
        act="gelu",
        rope_theta=10_000.0,
    ),
    sharding=ShardingRules(heads="model", ff="model", vocab=None,
                           fsdp_axis="data", dp_over_model=True),
    train=TrainConfig(remat="full"),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(model=CONFIG.model.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=32))
