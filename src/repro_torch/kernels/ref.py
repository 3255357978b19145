"""Plain torch versions of the port's kernels (the semantic definitions).

Each ``*_ref`` is the contract its CUDA kernel in
:mod:`repro_torch.kernels.flexa_prox` must meet bit for bit, written as
the reference's ``repro.kernels.ref`` oracle is: an index with −1 mapped
to 0, then ``torch.where``.  The dispatch (:mod:`repro_torch.kernels.ops`)
runs these for tensors on the CPU only.
"""
from __future__ import annotations

import torch


def gather_rows_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[k] = src[idx[k]] for idx[k] ≥ 0, zeros for −1 padding (fp32)."""
    idx = idx.to(torch.int64)
    taken = src.to(torch.float32)[torch.clamp_min(idx, 0)]
    return torch.where((idx >= 0).unsqueeze(-1), taken,
                       torch.zeros((), dtype=torch.float32,
                                   device=src.device))


def scatter_rows_ref(vals: torch.Tensor, inv: torch.Tensor,
                     base: torch.Tensor) -> torch.Tensor:
    """out[i] = vals[inv[i]] where inv[i] ≥ 0, else base[i] (base's dtype).

    A gather of the inverse permutation: each output row is written once.
    """
    inv = inv.to(torch.int64)
    taken = vals[torch.clamp_min(inv, 0)].to(base.dtype)
    return torch.where((inv >= 0).unsqueeze(-1), taken, base)
