"""Registry dispatch (what the client's inline backend executes)."""
from __future__ import annotations

from repro_torch.config.base import SolverConfig
from repro_torch.problems.base import Problem
from repro_torch.solvers.registry import get_solver
from repro_torch.solvers.result import SolverResult


def _solve(problem: Problem, method: str = "flexa",
           cfg: SolverConfig | None = None, x0=None,
           **options) -> SolverResult:
    """Solve ``min F(x) + G(x)`` with a registered method; the result's
    ``method`` is set to ``method``.  Unknown options raise TypeError."""
    cfg = cfg or SolverConfig()
    result = get_solver(method)(problem, x0, cfg, **options)
    result.method = method
    return result
