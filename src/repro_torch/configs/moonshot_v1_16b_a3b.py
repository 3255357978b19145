"""moonshot-v1-16b-a3b — MoE decoder (kimi/moonlight), 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (GQA kv=16)
d_ff=1408 (per expert) vocab=163840, MoE 64e top-6.
"""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1_408,
    vocab_size=163_840,
    num_experts=64,
    moe_top_k=6,
    source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=32, vocab_size=256, num_experts=8, moe_top_k=2,
    )
