"""Shared LM building blocks, as ``repro.models.layers``.

Conventions, as in the reference: parameters are fp32 "master" tensors
and compute casts them to the activation dtype; functions are
shape-polymorphic over batch and sequence.  Serving casts through
:func:`cast_param` (a cached copy, outside autograd); training casts
with :func:`cast` at every use, which autograd sees.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMS norm computed in fp32, returned in x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP:  (silu(x·w1) ⊙ (x·w3)) · w2, weights cast to x's dtype."""
    dt = x.dtype
    h = F.silu(x @ cast(w1, dt)) * (x @ cast(w3, dt))
    return h @ cast(w2, dt)


# ------------------------------------------------------------------ #
# Rotary position embeddings (standard + M-RoPE)                     #
# ------------------------------------------------------------------ #
def _rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) int → rotated x (same dtype).

    Rotate-half convention (llama-style): pairs (x[..., :D/2], x[..., D/2:]).
    """
    freqs = _rope_freqs(x.shape[-1], theta, x.device)        # (D/2,)
    return _rotate_half(
        x, positions.to(torch.float32)[:, None, :, None] * freqs)


def _rotate_half(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, H, S, D) rotated by the fp32 angles ``ang`` (B, 1, S, D/2),
    pair i being (x[..., i], x[..., D/2 + i]); in x's dtype."""
    D = x.shape[-1]
    sin, cos = torch.sin(ang), torch.cos(ang)
    xf1 = x[..., : D // 2].to(torch.float32)
    xf2 = x[..., D // 2:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """Qwen2-VL's split of the rotary half-dim into (temporal, height,
    width) sections in the ratio 1 : 1.5 : 1.5 (128 → (16, 24, 24))."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, H, S, D); positions3: (B, 3, S) int, the t / h / w streams
    → rotated x (same dtype).

    Frequency i of the rotary half reads the stream of its section
    (:func:`mrope_sections`); the angles, the rotate-half layout and the
    fp32 arithmetic are :func:`apply_rope`'s, so with t = h = w the two
    agree bit for bit.
    """
    D = x.shape[-1]
    freqs = _rope_freqs(D, theta, x.device)                  # (D/2,)
    sel = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(mrope_sections(D), device=x.device))    # (D/2,)
    pos = positions3.to(torch.float32)[:, sel, :]            # (B, D/2, S)
    return _rotate_half(x, pos.transpose(1, 2)[:, None, :, :] * freqs)


def embed(tokens: torch.Tensor, table: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``, in ``dtype``.  The reference casts
    the table and then gathers; gathering first gives the same values
    (the cast is elementwise) without casting the whole table."""
    return table[tokens].to(dtype)


def logits(x: torch.Tensor, table_or_head: torch.Tensor) -> torch.Tensor:
    """Final projection x · tableᵀ with fp32 output.

    The reference multiplies bf16 operands with fp32 accumulation and
    output (``preferred_element_type=float32``).  ``torch.matmul`` of two
    bf16 tensors returns a bf16 result, so both operands, rounded to x's
    dtype, are upcast and multiplied in fp32 at full precision.
    """
    head = table_or_head.to(x.dtype).to(torch.float32)
    return torch.matmul(x.to(torch.float32), head.transpose(0, 1))


def cross_entropy(lg: torch.Tensor, labels: torch.Tensor, *,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy; lg fp32 (B, S, V); labels (B, S) int.

    Optional z-loss (log²Z regularizer); 0 by default.
    """
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.to(torch.long)[..., None])[..., 0]
    nll = lse - gold
    if z_loss > 0:
        nll = nll + z_loss * lse ** 2
    return torch.mean(nll)


def init_dense(shape, *, generator: torch.Generator, device,
               scale: float | None = None) -> torch.Tensor:
    """N(0, scale²) fp32 weights; scale defaults to fan_in^-½."""
    if scale is None:
        scale = shape[0] ** -0.5
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device) * scale


def cast(p: torch.Tensor, dtype) -> torch.Tensor:
    """``p`` in ``dtype``, through autograd: the training forward's cast
    of an fp32 master weight at each use, as the reference's
    ``astype``.  (``cast_param`` keeps a detached copy, which would give
    the weight no gradient.)"""
    return p if p.dtype == dtype else p.to(dtype)


def cast_param(module: nn.Module, name: str, dtype) -> torch.Tensor:
    """``getattr(module, name).to(dtype)``, kept between calls.

    The reference casts its fp32 master weights to the activation dtype
    at every use.  The port keeps the cast copy, which holds the same
    values, and makes it again when the parameter is changed in place
    (its version counter moves) or replaced.
    """
    p = getattr(module, name)
    if p.dtype == dtype:
        return p
    casts = module.__dict__.setdefault("_param_casts", {})
    stamp = (id(p), p._version, p.data_ptr())
    hit = casts.get((name, dtype))
    if hit is None or hit[0] != stamp:
        hit = casts[(name, dtype)] = (stamp, p.detach().to(dtype))
    return hit[1]
