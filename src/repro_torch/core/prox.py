"""Proximal operators used by FLEXA best responses (elementwise torch)."""
from __future__ import annotations

import torch


def soft_threshold(v: torch.Tensor, t) -> torch.Tensor:
    """prox of ``t·‖·‖₁`` at ``v`` (t a scalar or broadcastable tensor)."""
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - t, 0.0)
