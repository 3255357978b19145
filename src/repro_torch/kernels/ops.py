"""Kernel dispatch: the CUDA kernel for a tensor on the card, the plain
torch version for a tensor on the CPU.

The device of the data decides, and nothing else: there is no switch
that sends a CUDA tensor to the plain version, and a kernel that fails
to build or launch raises.  Index arrays are validated here (entries in
[−1, rows)) before the kernel sees them, on the host when they come from
the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import flexa_prox as _fp
from repro_torch.kernels import ref


def _index(idx, n_rows: int, name: str, device) -> torch.Tensor:
    """``idx`` as a contiguous int32 tensor on ``device``, every entry in
    [−1, n_rows) (checked where the array lives: one read-back for an
    index already on the card)."""
    if not isinstance(idx, torch.Tensor):
        idx = torch.as_tensor(np.asarray(idx))
    if idx.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got shape {tuple(idx.shape)}")
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < -1 or hi >= n_rows:
            raise IndexError(f"{name} entries must lie in [-1, {n_rows}); "
                             f"got [{lo}, {hi}]")
    return idx.to(device=device, dtype=torch.int32).contiguous()


def _on(device: torch.device, *tensors) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensors on {t.device} and {device}")


def gather_blocks(src: torch.Tensor, idx) -> torch.Tensor:
    """Row gather: out[k] = src[idx[k]] (−1 ⇒ zero row), fp32.  src (N, C)."""
    idx = _index(idx, src.shape[0], "idx", src.device)
    if src.device.type == "cpu":
        return ref.gather_rows_ref(src, idx)
    if src.device.type == "cuda":
        return _fp.gather_rows(src.contiguous(), idx)
    raise ValueError(f"no gather_rows kernel for device {src.device}")


def scatter_blocks(vals: torch.Tensor, inv, base: torch.Tensor
                   ) -> torch.Tensor:
    """Inverse-permutation scatter: out[i] = vals[inv[i]] or base[i]."""
    _on(base.device, vals)
    inv = _index(inv, vals.shape[0], "inv", base.device)
    if base.device.type == "cpu":
        return ref.scatter_rows_ref(vals, inv, base)
    if base.device.type == "cuda":
        return _fp.scatter_rows(vals.contiguous(), inv, base.contiguous())
    raise ValueError(f"no scatter_rows kernel for device {base.device}")
