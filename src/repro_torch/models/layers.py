"""Shared LM building blocks, as ``repro.models.layers``.

Conventions, as in the reference: parameters are fp32 "master" tensors
and compute casts them to the activation dtype; functions are
shape-polymorphic over batch and sequence.  RoPE, ``swiglu`` and
``cross_entropy`` arrive with the families and the training step that
use them.
"""
from __future__ import annotations

import torch
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMS norm computed in fp32, returned in x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


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


def init_dense(shape, *, generator: torch.Generator, device,
               scale: float | None = None) -> torch.Tensor:
    """N(0, scale²) fp32 weights; scale defaults to fan_in^-½."""
    if scale is None:
        scale = shape[0] ** -0.5
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device) * scale


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
