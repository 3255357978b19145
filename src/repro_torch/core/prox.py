"""Proximal operators and projections used by FLEXA best responses.

Elementwise / blockwise torch; every operator takes any leading axes
(a batch of instances is one more of them).
"""
from __future__ import annotations

import torch


def soft_threshold(v: torch.Tensor, t) -> torch.Tensor:
    """prox of ``t·‖·‖₁`` at ``v`` (t a scalar or broadcastable tensor)."""
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - t, 0.0)


def group_soft_threshold(v: torch.Tensor, t) -> torch.Tensor:
    """prox of ``t·‖·‖₂`` applied to the *last* axis of ``v`` (block shrink).

    ``v`` has shape (..., block); the whole block is scaled toward zero:
    ``prox(v) = max(0, 1 − t/‖v‖₂) · v``.
    """
    nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    scale = torch.clamp_min(1.0 - t / torch.clamp_min(nrm, 1e-30), 0.0)
    return scale * v


def project_box(v: torch.Tensor, lo, hi) -> torch.Tensor:
    return torch.clamp(v, lo, hi)


def project_nonneg(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(v, 0.0)
