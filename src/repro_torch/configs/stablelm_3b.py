"""stablelm-3b — dense decoder (MHA: kv == q heads), head_dim 80.

[hf:stabilityai/stablelm-2-1_6b; unverified]  32L d_model=2560 32H
(GQA kv=32) d_ff=6912 vocab=50304.
"""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6_912,
    vocab_size=50_304,
    source="[hf:stabilityai/stablelm-2-1_6b; unverified]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=160, vocab_size=256,
    )
