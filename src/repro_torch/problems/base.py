"""Problem interface for composite minimization  min F(x) + G(x)  (Eq. (1)).

A :class:`Problem` bundles the smooth part ``F`` (value, gradient and a
per-coordinate curvature majorizer) as closures over torch tensors, and
the block-separable nonsmooth part ``G`` (kind + weight).

Every method takes ``x`` of shape ``(n,)`` or ``(B, n)``: the batched
engine (``repro_torch.solvers.batched``) runs B instances with a leading
batch dimension, where the reference vmaps a per-instance problem.  In
that case ``g_weight`` is a ``(B, 1)`` tensor of per-instance weights.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.core.prox import soft_threshold


@dataclass
class Problem:
    name: str
    n: int                      # total number of scalar variables
    block_size: int             # nᵢ (1 ⇒ scalar blocks, as in the paper's Lasso)
    f: Callable                 # x -> F(x)
    grad_f: Callable            # x -> ∇F(x)
    diag_curv: Callable         # x -> per-coordinate curvature majorizer of F
    g_kind: str = "l1"          # "l1" | "zero"
    g_weight: Any = 0.0         # c: a float, or (B, 1) tensor when batched
    family: str = ""
    # Optional certificates (Nesterov instances have closed-form optima):
    v_star: Optional[float] = None
    x_star: Optional[torch.Tensor] = None
    lipschitz: Optional[float] = None   # L_F estimate
    data: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.g_kind not in ("l1", "zero"):
            raise NotImplementedError(
                f"g_kind {self.g_kind!r} is not yet ported to repro_torch "
                "(the port has 'l1' and 'zero')")

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
        s = torch.abs(x).sum(-1, keepdim=True)
        return (self.g_weight * s).squeeze(-1)

    def v(self, x: torch.Tensor):
        """Full objective V = F + G."""
        return self.f(x) + self.g(x)

    def prox(self, w: torch.Tensor, t) -> torch.Tensor:
        """Blockwise prox of ``t·g`` at ``w`` (t broadcastable over coords)."""
        if self._g_off():
            return w
        return soft_threshold(w, t * self.g_weight)

    def block_norms(self, x: torch.Tensor) -> torch.Tensor:
        """Per-block ℓ2 norms of a flat vector."""
        if self.block_size == 1:
            return torch.abs(x)
        return torch.linalg.vector_norm(self.blockify(x), dim=-1)
