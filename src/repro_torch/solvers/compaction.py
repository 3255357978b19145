"""Capacity-bucketed active-set compaction: make screening pay in FLOPs.

A port of ``repro.solvers.compaction``.  The screened λ-path certifies
that only an active subset of blocks can be nonzero; this module packs
those blocks into a dense layout whose width is a power-of-two
*capacity bucket* (the smallest power of two ≥ the active count, capped
at ``n_blocks``), so the solver's products shrink with the support.
Unused capacity slots carry index −1 and gather to zero rows, which are
algebraically inert.  Active blocks pack in ascending order, and the
inverse permutation scatters results back with every destination row
written exactly once.

Array movement goes through :mod:`repro_torch.kernels.ops`: the CUDA
``gather_rows`` / ``scatter_rows`` kernels for tensors on the card, their
plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops


def bucket_capacity(active_count: int, n_blocks: int) -> int:
    """Smallest power of two ≥ max(count, 1), capped at ``n_blocks``."""
    count = max(int(active_count), 1)
    cap = 1
    while cap < count:
        cap *= 2
    return min(cap, int(n_blocks))


def pack_indices(active_mask) -> np.ndarray:
    """Active block indices in ascending order (the stable packing)."""
    return np.flatnonzero(np.asarray(active_mask).astype(bool)).astype(
        np.int32)


@dataclasses.dataclass(frozen=True)
class CompactPlan:
    """One support's packing permutation at its capacity bucket.

    ``block_idx[k]`` is the source block of compact slot k (−1 ⇒ unused
    capacity, gathers zeros); ``inverse[j]`` is block j's compact slot
    (−1 ⇒ screened out, the scatter keeps the base value).
    """
    n_blocks: int
    block_size: int
    capacity: int
    block_idx: np.ndarray       # (capacity,) int32, −1 padding
    inverse: np.ndarray         # (n_blocks,) int32, −1 ⇒ inactive

    @property
    def dense(self) -> bool:
        """True when the bucket equals the full width — no FLOPs to skip."""
        return self.capacity >= self.n_blocks

    @property
    def n_compact(self) -> int:
        return self.capacity * self.block_size

    def pack_vector(self, x: torch.Tensor) -> torch.Tensor:
        """(n,) coordinate vector → (capacity·bs,) compact layout."""
        src = x.reshape(self.n_blocks, self.block_size)
        return ops.gather_blocks(src, self.block_idx).reshape(self.n_compact)

    def pack_columns(self, A: torch.Tensor) -> torch.Tensor:
        """(m, n) design matrix → (m, capacity·bs) active columns.

        Row gather over the transposed block layout: each block's ``bs``
        columns travel as one contiguous (bs·m) row.  The transposed copy
        of A is plain torch, as the reference leaves it to XLA.
        """
        m = A.shape[0]
        src = A.T.reshape(self.n_blocks, self.block_size * m)
        out = ops.gather_blocks(src, self.block_idx)
        return out.reshape(self.n_compact, m).T

    def pack_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """Coordinate mask through the same gather (pad slots → 0)."""
        return self.pack_vector(mask)

    def unpack_vector(self, x_c: torch.Tensor, base=None) -> torch.Tensor:
        """(capacity·bs,) compact result → (n,) full layout; screened
        blocks keep ``base`` (zeros when omitted)."""
        vals = x_c.reshape(self.capacity, self.block_size)
        if base is None:
            base = torch.zeros((self.n_blocks, self.block_size),
                               dtype=vals.dtype, device=vals.device)
        else:
            base = base.reshape(self.n_blocks, self.block_size)
        out = ops.scatter_blocks(vals, self.inverse, base)
        return out.reshape(self.n_blocks * self.block_size)


def make_plan(active_mask, block_size: int) -> CompactPlan:
    """Plan the packing of one certified (n_blocks,) support at its
    capacity bucket (two supports of similar size share plan shapes)."""
    mask = np.asarray(active_mask).astype(bool).reshape(-1)
    n_blocks = int(mask.shape[0])
    idx = pack_indices(mask)
    cap = bucket_capacity(idx.size, n_blocks)
    block_idx = np.full(cap, -1, np.int32)
    block_idx[:idx.size] = idx
    inverse = np.full(n_blocks, -1, np.int32)
    inverse[idx] = np.arange(idx.size, dtype=np.int32)
    return CompactPlan(n_blocks=n_blocks, block_size=int(block_size),
                       capacity=cap, block_idx=block_idx, inverse=inverse)
