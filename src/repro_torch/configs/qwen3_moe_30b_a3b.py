"""qwen3-moe-30b-a3b — MoE decoder, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B; hf]  48L d_model=2048 32H (GQA kv=4) d_ff=768
(per expert) vocab=151936, MoE 128e top-8.  Qwen3 uses explicit
head_dim=128 (32×128 ≠ d_model — the attention output projection maps back).
"""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151_936,
    num_experts=128,
    moe_top_k=8,
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256, num_experts=8, moe_top_k=2,
    )
