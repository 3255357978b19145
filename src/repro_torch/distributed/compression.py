"""Gradient compression for the data-parallel reduction path, as
``repro.distributed.compression``.

Two schemes, both with **error feedback** (the residual of the
compression is carried and added to the next step's gradient):

* ``topk`` — keep the k largest-magnitude entries per tensor;
* ``int8`` — per-tensor symmetric quantization to int8.

They are functions on the gradients, applied between the backward pass
and the optimizer.  Gradients come as the optimizer takes them: per
parameter leaf a list of tensors (one per layer for a stacked leaf).
The reference compresses a stacked leaf as one tensor (its top-k
threshold and its int8 scale span all layers); the port keeps that: a
leaf's tensors are compressed together, through their concatenation.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class CompressionState(NamedTuple):
    residual: Any   # error-feedback carry, per leaf a list of fp32 tensors


def init_state(leaves) -> CompressionState:
    """Zero fp32 carries shaped like the parameter ``leaves``."""
    return CompressionState(residual=[
        [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
         for t in leaf.tensors] for leaf in leaves])


def _topk_flat(flat: torch.Tensor, frac: float) -> torch.Tensor:
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.sort(torch.abs(flat)).values[-k]
    mask = (torch.abs(flat) >= thresh).to(flat.dtype)
    return flat * mask


def _int8_flat(flat: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp_min(torch.max(torch.abs(flat)), 1e-12) / 127.0
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress(grads, state: CompressionState, *, kind: str = "topk",
             topk_frac: float = 0.1, feedback_scale=1.0):
    """Returns (compressed grads to feed the optimizer, new state).

    The residual stored for the next step is ``feedback_scale·(g + r −
    C(g + r))``; the training loop passes the reference's γ-scaled carry
    γᵏ(1 − γᵏ) for FLEXA (a device scalar) and 1.0 for AdamW.
    """
    if kind == "none":
        return grads, state
    if kind not in ("topk", "int8"):
        raise ValueError(kind)
    comp, resid = [], []
    for gs, rs in zip(grads, state.residual):
        gf = [g.to(torch.float32) + r for g, r in zip(gs, rs)]
        flat = torch.cat([t.reshape(-1) for t in gf])
        c = _topk_flat(flat, topk_frac) if kind == "topk" \
            else _int8_flat(flat)
        parts = torch.split(c, [t.numel() for t in gf])
        cs = [p.reshape(t.shape) for p, t in zip(parts, gf)]
        comp.append(cs)
        resid.append([feedback_scale * (t - ci) for t, ci in zip(gf, cs)])
    return comp, CompressionState(residual=resid)


def wire_bytes(grads, kind: str, topk_frac: float = 0.1) -> int:
    """Bytes this scheme would move on the DP reduction (reporting), per
    leaf as the reference counts them; ``grads`` per leaf a list of
    tensors."""
    total = 0
    for gs in grads:
        n = sum(g.numel() for g in gs)
        if kind == "none":
            total += n * 4
        elif kind == "topk":
            k = max(1, int(n * topk_frac))
            total += k * (4 + 4)                # value + index
        elif kind == "int8":
            total += n * 1 + 4                  # payload + scale
    return total
