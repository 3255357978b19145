"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone.

[arXiv:2308.11596; hf]  24L d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206.

Only the transformer backbone is modeled, as in the reference: the
speech frontend is a stub, the encoder takes precomputed frame
embeddings ``enc_embeds`` (batch, enc_len, d_model), and the decoder
reads token ids and cross-attends to the encoder's states.
"""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,       # decoder layers
    enc_layers=24,       # encoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8_192,
    vocab_size=256_206,
    source="[arXiv:2308.11596; hf]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, enc_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256,
    )
