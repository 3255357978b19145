"""zamba2-1.2b — Mamba2 backbone + shared attention blocks (hybrid).

[arXiv:2411.15242; hf]  38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64.  The single shared attention+MLP block is applied
every ``attn_every`` Mamba2 layers with *shared weights* (Zamba2's signature
design); d_ff belongs to that shared block's MLP.
"""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32_000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    attn_every=6,
    tie_embeddings=True,
    source="[arXiv:2411.15242; hf]",
)


def reduced() -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    return CONFIG.replace(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, ssm_state=16, ssm_headdim=16, attn_every=2,
        ssm_chunk=16,
    )
