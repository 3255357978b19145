"""deepseek-67b — llama-architecture dense decoder (deep: 95 layers).

[arXiv:2401.02954; hf]  95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400.
"""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab_size=102_400,
    source="[arXiv:2401.02954; hf]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=256,
    )
