"""Problem interface for composite minimization  min F(x) + G(x)  (Eq. (1)).

A :class:`Problem` bundles the smooth part ``F`` (value, gradient and a
per-coordinate curvature majorizer) as closures over torch tensors, and
the block-separable nonsmooth part ``G`` (kind + weight).

Every method takes ``x`` of shape ``(n,)`` or ``(B, n)``: the batched
engine (``repro_torch.solvers.batched``) runs B instances with a leading
batch dimension, where the reference vmaps a per-instance problem.  In
that case ``g_weight`` is a ``(B, 1)`` tensor of per-instance weights,
and a block-structured ``x`` has blocks ``(B, n_blocks, block_size)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.core.prox import group_soft_threshold, soft_threshold


@dataclass
class Problem:
    name: str
    n: int                      # total number of scalar variables
    block_size: int             # nᵢ (1 ⇒ scalar blocks, as in the paper's Lasso)
    f: Callable                 # x -> F(x)
    grad_f: Callable            # x -> ∇F(x)
    diag_curv: Callable         # x -> per-coordinate curvature majorizer of F
    g_kind: str = "l1"          # "l1" | "group_l2" | "zero"
    g_weight: Any = 0.0         # c: a float, or (B, 1) tensor when batched
    family: str = ""
    # Optional certificates (Nesterov instances have closed-form optima):
    v_star: Optional[float] = None
    x_star: Optional[torch.Tensor] = None
    lipschitz: Optional[float] = None   # L_F estimate
    data: dict = field(default_factory=dict)

    # ------------------------------------------------------------------ #
    @property
    def n_blocks(self) -> int:
        return self.n // self.block_size

    @property
    def device(self) -> torch.device:
        """Where the problem's data lives (the CPU for data-free F)."""
        for v in self.data.values():
            if isinstance(v, torch.Tensor):
                return v.device
        return torch.device("cpu")

    def blockify(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[:-1] + (self.n_blocks, self.block_size))

    def _g_off(self) -> bool:
        """G ≡ 0 shortcut (``g_weight`` may be a per-instance tensor)."""
        return self.g_kind == "zero" or (
            isinstance(self.g_weight, (int, float)) and self.g_weight == 0.0)

    def g(self, x: torch.Tensor):
        if self._g_off():
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        if self.g_kind == "l1":
            s = torch.abs(x).sum(-1, keepdim=True)
        elif self.g_kind == "group_l2":
            s = torch.linalg.vector_norm(self.blockify(x), dim=-1).sum(
                -1, keepdim=True)
        else:
            raise ValueError(self.g_kind)
        return (self.g_weight * s).squeeze(-1)

    def v(self, x: torch.Tensor):
        """Full objective V = F + G."""
        return self.f(x) + self.g(x)

    def prox(self, w: torch.Tensor, t) -> torch.Tensor:
        """Blockwise prox of ``t·g`` at ``w`` (t broadcastable over coords;
        under ``group_l2`` each block takes the t of its first coordinate)."""
        if self._g_off():
            return w
        if self.g_kind == "l1":
            return soft_threshold(w, t * self.g_weight)
        if self.g_kind == "group_l2":
            tb = torch.as_tensor(t, dtype=w.dtype, device=w.device)
            tb = self.blockify(tb.expand(w.shape))[..., :1]
            c = self.g_weight           # a (B, 1) weight gains the block axis
            if isinstance(c, torch.Tensor):
                c = c.unsqueeze(-1)
            return group_soft_threshold(self.blockify(w),
                                        tb * c).reshape(w.shape)
        raise ValueError(self.g_kind)

    def block_norms(self, x: torch.Tensor) -> torch.Tensor:
        """Per-block ℓ2 norms of a flat vector."""
        if self.block_size == 1:
            return torch.abs(x)
        return torch.linalg.vector_norm(self.blockify(x), dim=-1)

    def stationarity(self, x: torch.Tensor, tau: float = 1.0):
        """‖x − prox_g(x − ∇F(x)/τ)‖∞ — a stationarity residual.

        Zero exactly at the stationary points of (1) (fixed points of the
        best-response map, Prop. 3(b)); one per instance row.
        """
        w = x - self.grad_f(x) / tau
        return torch.abs(self.prox(w, 1.0 / tau) - x).max(-1).values
