"""GRock [17] — greedy parallel coordinate descent (the paper's closest rival).

A port of ``repro.baselines.grock``.  Per iteration: every scalar best
response with *exact* column curvature d = max(2‖aᵢ‖², 1e-12) and unit
step, then only the P coordinates with the largest potential |x̂ᵢ − xᵢ|
move (``core.selection.topk_mask``).  ``P = 1`` is greedy
(Gauss-Southwell) CD; ``P = number of processors`` the parallel variant
the paper benchmarks.

GRock's convergence theory requires near-orthogonal columns once P > 1;
on correlated problems it can diverge, and the loop stops at the first
non-finite V, as the reference's does.  The elementwise chain is plain
torch, as the reference's is plain jnp.
"""
from __future__ import annotations

import math
import time

import torch

from repro_torch.core.flexa import as_x0
from repro_torch.core.prox import soft_threshold
from repro_torch.core.result import SolverResult
from repro_torch.core.selection import topk_mask
from repro_torch.problems.base import Problem


def solve(problem: Problem, P: int = 1, x0=None, max_iters: int = 2000,
          tol: float = 1e-6) -> SolverResult:
    t_start = time.perf_counter()
    x = as_x0(problem, x0)
    d = torch.clamp_min(problem.diag_curv(None), 1e-12)  # 2‖aᵢ‖²
    # c / d as a true fp32 division, as the reference's weakly typed c
    t = torch.as_tensor(problem.g_weight, dtype=torch.float32,
                        device=d.device) / d
    hist = {"V": [], "time": [], "stat": []}
    converged = False
    it = 0
    for it in range(max_iters):
        delta = soft_threshold(x - problem.grad_f(x) / d, t) - x
        x = x + topk_mask(torch.abs(delta), P) * delta  # P best coords
        stat = torch.max(torch.abs(delta))
        v, stat = torch.stack([problem.v(x).to(torch.float32),
                               stat]).tolist()
        hist["V"].append(v)
        hist["stat"].append(stat)
        hist["time"].append(time.perf_counter() - t_start)
        if stat <= tol:
            converged = True
            break
        if not math.isfinite(v):           # GRock can diverge (see above)
            break
    return SolverResult(x=x, iters=it + 1, converged=converged,
                        history=hist, method="grock")
