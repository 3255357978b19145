"""Attention layers, as ``repro.models.attention``: chunked (flash-style)
attention in plain torch, single-token decode attention against a KV
cache, and the GQA projections of the dense family.

* ``chunked_attention`` is the reference's online softmax over KV blocks
  of 1024 with fp32 scores, query positions end-aligned to the keys and
  the zero padding of a ragged last block masked.  Each block's body
  runs under ``torch.utils.checkpoint`` (the reference wraps it in
  ``jax.checkpoint``), so backward recomputes a block's (B, Hq, Sq, blk)
  scores instead of keeping all of them.  Training (``attention_layer``)
  and the full ``forward`` run it: they need a gradient, and the
  flash-attention kernel has none.
* ``attention_prefill`` is the reference's ``attention_layer`` with
  ``collect_kv`` for the prefill.  Its attention goes through
  ``kernels.ops.flash_attention``: the CUDA kernel on the card, its plain
  version on the CPU.  The reference's module docstring names
  ``chunked_attention`` the path for training and prefill and the Pallas
  kernel its per-block body on the TPU; both compute the same function
  (fp32 scores, fp32 online softmax, end-aligned causal mask), and its
  tests hold both against one oracle.
* ``decode_attention`` / ``attention_decode``: one query token against
  the cache, with the reference's numerics (below).
* The encdec family's cross-attention: ``encoder_kv`` projects the
  encoder's output to k and v (no rope), ``cross_attention_layer`` is
  the reference's function of that name for ``forward``
  (``chunked_attention``), and ``cross_attention`` serves the prefill
  and each decode step, through ``kops.flash_attention`` (non-causal):
  the reference computes decode's cross-attention with
  ``chunked_attention`` too, not with ``decode_attention``.
* M-RoPE (``cfg.use_mrope``, the vlm family): positions are (B, 3, S)
  streams, and decode broadcasts its one position to all three.

Serving (``attention_prefill``, ``attention_decode``) casts the fp32
weights through the cached :func:`L.cast_param`; training casts with
:func:`L.cast` at every use, which autograd sees.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops as kops
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


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len, *, scale=None) -> torch.Tensor:
    """One-step attention: q (B, Hq, 1, D) against the cache k, v
    (B, Hkv, S, D), of which the first ``cache_len`` positions are valid.

    The reference's numerics: the scaled q rounded back to q's dtype,
    scores of the storage-dtype operands with fp32 products and sums
    (``preferred_element_type=float32``), an fp32 softmax, p rounded to
    the cache's dtype for P·V, fp32 sums again, output in q's dtype.
    torch's bf16 ``matmul`` would round its output to bf16, so both
    products run in fp32 on the operands upcast (exact products, fp32
    sums).  Only the ``cache_len`` valid positions are read and upcast:
    the reference's masked positions contribute exp(−1e30 − m) = 0.  GQA
    is a grouped product (q reshaped to (B, Hkv, rep, D)); the cache is
    never repeated.
    """
    B, Hq, _, D = q.shape
    Hkv = k.shape[1]
    rep = Hq // Hkv
    n = int(cache_len)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    f32 = torch.float32
    qg = (q.to(f32) * scale).to(q.dtype).to(f32).reshape(B, Hkv, rep, D)
    kf = k[:, :, :n].to(f32)
    s = torch.matmul(qg, kf.transpose(-1, -2))        # (B, Hkv, rep, n)
    p = torch.softmax(s, dim=-1).to(k.dtype).to(f32)
    out = torch.matmul(p, v[:, :, :n].to(f32))        # (B, Hkv, rep, D)
    return out.reshape(B, Hq, 1, D).to(q.dtype)


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


def _kv(weight, x: torch.Tensor, cfg: ModelConfig):
    """k and v (B, Hkv, S, dh) of x (B, S, d), not roped; ``weight(name)``
    gives the projection ``name`` in x's dtype."""
    return (_split_heads(x @ weight("wk"), cfg.num_kv_heads, cfg.head_dim),
            _split_heads(x @ weight("wv"), cfg.num_kv_heads, cfg.head_dim))


def _qkv(weight, x: torch.Tensor, positions: torch.Tensor,
         cfg: ModelConfig):
    """Roped q (B, Hq, S, dh), k and v (B, Hkv, S, dh) of x (B, S, d);
    positions (B, S), or (B, 3, S) under M-RoPE."""
    q = _split_heads(x @ weight("wq"), cfg.num_heads, cfg.head_dim)
    k, v = _kv(weight, x, cfg)
    if cfg.use_mrope:
        return (L.apply_mrope(q, positions, cfg.rope_theta),
                L.apply_mrope(k, positions, cfg.rope_theta), v)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _served(p: AttnParams, dtype):
    """Serving's weights: cached casts (:func:`L.cast_param`)."""
    return lambda name: L.cast_param(p, name, dtype)


def attention_layer(p: AttnParams, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, *, causal: bool = True,
                    block: int = 1024):
    """Training attention over x: (B, S, d_model) → (out, (k, v)).

    Weights are cast to x's dtype through autograd (:func:`L.cast`)."""
    def weight(name):
        return L.cast(getattr(p, name), x.dtype)
    q, k, v = _qkv(weight, x, positions, cfg)
    out = chunked_attention(q, k, v, causal=causal, block=block)
    return _merge_heads(out) @ weight("wo"), (k, v)


def attention_prefill(p: AttnParams, x: torch.Tensor,
                      positions: torch.Tensor, cfg: ModelConfig, *,
                      causal: bool = True):
    """Prefill attention over x (B, S, d_model) → (out, (k, v)), k and v
    (B, Hkv, S, dh) for the decode cache.  The attention itself is
    ``kops.flash_attention``: the CUDA kernel for a tensor on the card,
    once per layer (non-causal for the encdec encoder)."""
    weight = _served(p, x.dtype)
    q, k, v = _qkv(weight, x, positions, cfg)
    out = kops.flash_attention(q, k, v, causal=causal)
    return _merge_heads(out) @ weight("wo"), (k, v)


def encoder_kv(p: AttnParams, enc_out: torch.Tensor, cfg: ModelConfig):
    """A decoder layer's cross-attention k and v (B, Hkv, Se, dh) of the
    encoder's output (B, Se, d), with no rope (served weights)."""
    return _kv(_served(p, enc_out.dtype), enc_out, cfg)


def cross_attention_layer(p: AttnParams, x: torch.Tensor,
                          enc_out: torch.Tensor, cfg: ModelConfig
                          ) -> torch.Tensor:
    """``forward``'s cross-attention of x (B, S, d) to the encoder's
    output: q from x, k and v from ``enc_out``, no rope on either side,
    ``chunked_attention`` (non-causal), weights cast as in training."""
    def weight(name):
        return L.cast(getattr(p, name), x.dtype)
    q = _split_heads(x @ weight("wq"), cfg.num_heads, cfg.head_dim)
    k, v = _kv(weight, enc_out, cfg)
    out = chunked_attention(q, k, v, causal=False)
    return _merge_heads(out) @ weight("wo")


def cross_attention(p: AttnParams, x: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Served cross-attention of x (B, Sq, d) to k, v (B, Hkv, Skv, dh):
    the prefill's (Sq the prompt, k and v from :func:`encoder_kv`) and each
    decode step's (Sq = 1, k and v the layer's read-only slice of the
    cross cache, every one of its positions read, as the reference's
    ``chunked_attention`` reads them).  One ``kops.flash_attention``
    (non-causal) per call."""
    weight = _served(p, x.dtype)
    q = _split_heads(x @ weight("wq"), cfg.num_heads, cfg.head_dim)
    out = kops.flash_attention(q, k, v, causal=False)
    return _merge_heads(out) @ weight("wo")


def attention_decode(p: AttnParams, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, cfg: ModelConfig):
    """Single-token attention step.

    x (B, 1, d); cache_k, cache_v (B, Hkv, S, dh) with ``pos`` valid
    entries.  Writes the new token's k and v at index ``pos`` **in
    place** and attends to [0, pos].  Returns out (B, 1, d) alone: the
    reference returns updated copies of the cache beside it, which here
    would be the caller's own tensors.
    """
    B, pos = x.shape[0], int(pos)
    posn = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    if cfg.use_mrope:
        posn = posn[:, None, :].expand(B, 3, 1)
    weight = _served(p, x.dtype)
    q, k, v = _qkv(weight, x, posn, cfg)
    cache_k[:, :, pos] = k[:, :, 0].to(cache_k.dtype)
    cache_v[:, :, pos] = v[:, :, 0].to(cache_v.dtype)
    out = decode_attention(q, cache_k, cache_v, pos + 1)
    return _merge_heads(out) @ weight("wo")
