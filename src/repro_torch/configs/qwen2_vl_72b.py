"""qwen2-vl-72b — VLM decoder backbone with M-RoPE.

[arXiv:2409.12191; hf]  80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064.

Only the LM backbone is modeled, as in the reference: the vision
frontend is a stub, and a batch carries token ids plus the 3-stream
M-RoPE position ids ``(batch, 3, seq)`` that the patchifier would emit.
"""
from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    vocab_size=152_064,
    use_mrope=True,
    source="[arXiv:2409.12191; hf]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=256,
    )
