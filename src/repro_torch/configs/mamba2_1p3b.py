"""mamba2-1.3b — attention-free SSD (state-space duality) stack.

[arXiv:2405.21060; unverified]  48L d_model=2048 d_ff=0 vocab=50280,
ssm_state=128.
"""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=64, vocab_size=256, ssm_state=16,
        ssm_headdim=16, ssm_chunk=16,
    )
