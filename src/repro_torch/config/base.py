"""Configuration dataclasses of the port (plain data, no torch import).

:class:`SolverConfig` is the reference's solver config field for field;
:class:`ClientConfig` keeps the fields the ``inline`` backend reads plus
``device`` — where the client runs its work (``"cuda"`` by default).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class SolverConfig:
    """Settings for the paper-faithful convex solver (Algorithm 1)."""

    rho: float = 0.5
    gamma0: float = 0.9
    theta: float = 1e-5
    tau0: float = 0.0               # 0 ⇒ paper default tr(AᵀA)/2n
    tau_adapt: bool = True
    tau_grow: float = 2.0
    tau_shrink: float = 0.5
    tau_patience: int = 10
    surrogate: str = "exact_block"  # "linear" | "exact_block" | "newton_cg"
    inexact_alpha1: float = 0.0     # εᵏ schedule (0 ⇒ exact subproblems)
    inexact_alpha2: float = 1.0
    max_iters: int = 2_000
    tol: float = 1e-6               # stop when ‖x̂(x)−x‖∞ ≤ tol
    jacobi: bool = False            # True ⇒ Sᵏ = 𝒩 (full parallel Jacobi)
    # --- Step S.3 selection rule (repro_torch.core.selection.make_mask) ---
    # "greedy" (paper FPA) | "full" | "southwell" | "topk" | "random" |
    # "hybrid" | "cyclic".
    selection: str = "greedy"
    sel_p: float = 0.25             # Bernoulli sketch probability
    sel_k: int = 8                  # k for the topk rule
    sel_chunks: int = 4             # cycle length for the cyclic rule
    seed: int = 0                   # torch.Generator seed (random rules)


@dataclass(frozen=True)
class ClientConfig:
    """One config for the front door (``repro_torch.client.FlexaClient``).

    ``backend`` names the execution backend (only ``"inline"`` is ported);
    ``device`` is where the client runs every workload — problems built
    on another device are moved there.
    """

    solver: SolverConfig = field(default_factory=SolverConfig)
    backend: str = "inline"
    device: str = "cuda"

    def replace(self, **kw: Any) -> "ClientConfig":
        return dataclasses.replace(self, **kw)
