"""phi3-medium-14b — dense decoder, RoPE + SwiGLU + GQA.

[arXiv:2404.14219; unverified]  40L d_model=5120 40H (GQA kv=10)
d_ff=17920 vocab=100352.

40 query heads over 10 KV heads: 4 queries per KV head, and a head
count that is not a power of two.
"""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17_920,
    vocab_size=100_352,
    source="[arXiv:2404.14219; unverified]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=80, num_heads=5, num_kv_heads=5, head_dim=16,
        d_ff=160, vocab_size=256,
    )
