"""Attention layers, as ``repro.models.attention``: chunked (flash-style)
attention in plain torch and the GQA projections of the dense family.

``chunked_attention`` is the reference's online softmax over KV blocks
of 1024 with fp32 scores, query positions end-aligned to the keys and
the zero padding of a ragged last block masked.  Each block's body runs
under ``torch.utils.checkpoint`` (the reference wraps it in
``jax.checkpoint``), so backward recomputes a block's (B, Hq, Sq, blk)
scores instead of keeping all of them: the O(S²) matrix never lives in
memory at once.  The reference runs this plain version on every path of
its models (its Pallas ``flash_attention`` has no model caller), and so
does the port.

Prefill/decode attention against a KV cache (``decode_attention``,
``attention_decode``) belongs to dense serving and is not ported yet.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.models import layers as L

NEG_INF = -1e30


def _block(m, l, acc, qf, kblk, vblk, qpos, start: int, blk: int,
           skv: int, rep: int, causal: bool):
    """One KV block of the online softmax: new (m, ℓ, acc)."""
    kr = torch.repeat_interleave(kblk, rep, dim=1).to(torch.float32)
    vr = torch.repeat_interleave(vblk, rep, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kr)
    kpos = start + torch.arange(blk, device=qf.device)
    valid = (kpos < skv)[None, :]                 # mask the zero padding
    if causal:
        valid = valid & (kpos[None, :] <= qpos[:, None])
    s = torch.where(valid[None, None], s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * alpha + torch.sum(p, dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vr)
    return m_new, l_new, acc_new


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, block: int = 1024, scale=None
                      ) -> torch.Tensor:
    """Flash-style attention.  q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D)
    → (B, Hq, Sq, D) in q's dtype."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    blk = min(block, Skv)
    nblk = -(-Skv // blk)
    pad = nblk * blk - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))

    qf = q.to(torch.float32) * scale
    qpos = (Skv - Sq) + torch.arange(Sq, device=q.device)  # end-aligned
    m = torch.full((B, Hq, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hq, Sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, Sq, D), dtype=torch.float32, device=q.device)
    grad = torch.is_grad_enabled()
    for ib in range(nblk):
        kblk = k[:, :, ib * blk:(ib + 1) * blk]
        vblk = v[:, :, ib * blk:(ib + 1) * blk]
        args = (m, l, acc, qf, kblk, vblk, qpos, ib * blk, blk, Skv, rep,
                causal)
        if grad:
            m, l, acc = checkpoint(_block, *args, use_reentrant=False)
        else:
            m, l, acc = _block(*args)
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


# ------------------------------------------------------------------ #
# Full GQA attention layer (projections + rope + attention + output) #
# ------------------------------------------------------------------ #
class AttnParams(torch.nn.Module):
    """``init_attn_params``' tree: ``wq`` (d, Hq·dh), ``wk`` and ``wv``
    (d, Hkv·dh), ``wo`` (Hq·dh, d), fp32, in the reference's (in, out)
    layout."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d, hq, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim)

        def param(*shape):
            return torch.nn.Parameter(torch.zeros(
                shape, dtype=torch.float32, device=device))
        self.wq = param(d, hq * dh)
        self.wk = param(d, hkv * dh)
        self.wv = param(d, hkv * dh)
        self.wo = param(hq * dh, d)


@torch.no_grad()
def init_attn_params(attn: AttnParams, *, generator: torch.Generator
                     ) -> AttnParams:
    """Fill ``attn`` with ``init_dense`` draws (N(0, fan_in⁻¹)) from
    ``generator``, in the reference's order wq, wk, wv, wo."""
    for name in ("wq", "wk", "wv", "wo"):
        w = getattr(attn, name)
        w.copy_(L.init_dense(tuple(w.shape), generator=generator,
                             device=w.device))
    return attn


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int
                 ) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def attention_layer(p: AttnParams, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, *, causal: bool = True,
                    block: int = 1024):
    """Training attention over x: (B, S, d_model) → (out, (k, v)).

    Weights are cast to x's dtype through autograd (:func:`L.cast`)."""
    dt = x.dtype
    q = _split_heads(x @ L.cast(p.wq, dt), cfg.num_heads, cfg.head_dim)
    k = _split_heads(x @ L.cast(p.wk, dt), cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(x @ L.cast(p.wv, dt), cfg.num_kv_heads, cfg.head_dim)
    if cfg.use_mrope:
        raise NotImplementedError("M-RoPE (the vlm family) is not yet "
                                  "ported: ROADMAP Queue 1 step 5b")
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    out = chunked_attention(q, k, v, causal=causal, block=block)
    return _merge_heads(out) @ L.cast(p.wo, dt), (k, v)
