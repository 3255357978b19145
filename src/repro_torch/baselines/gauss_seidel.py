"""Sequential Gauss-Seidel best-response sweep (paper §4 benchmark (i)).

A port of ``repro.baselines.gauss_seidel``.  One iteration is one full
sweep over all n scalar coordinates, each taking the exact best response
x̂ᵢ (soft threshold with exact column curvature, ‖aᵢ‖² floored at 1e-12)
against the *already updated* residual, with unit step: classical cyclic
coordinate minimization for Lasso, with the residual maintained
incrementally (r ← r + aᵢ·δᵢ) and V = rᵀr + c‖x‖₁.

The reference runs each sweep as one device program (``lax.fori_loop``).
Here a sweep is one call of ``kernels.ops.gauss_seidel_sweep``: on the
card one launch of the CUDA kernel, which reads the columns as rows of a
contiguous Aᵀ that the solver makes once (an extra m·n floats); on the
CPU the plain per-coordinate loop.  Sequential by construction — the
paper runs it on a single process.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.flexa import as_x0
from repro_torch.core.result import SolverResult
from repro_torch.kernels import ops
from repro_torch.problems.base import Problem


def solve(problem: Problem, x0=None, max_iters: int = 200,
          tol: float = 1e-6) -> SolverResult:
    t_start = time.perf_counter()
    A = problem.data.get("A")
    b = problem.data.get("b")
    if A is None:
        raise ValueError("Gauss-Seidel baseline requires quadratic data A, b")
    x = as_x0(problem, x0).clone()          # updated in place
    c = float(problem.g_weight)
    colsq = torch.clamp_min((A * A).sum(0), 1e-12)
    At = A.T.contiguous()
    r = A @ x - b
    hist = {"V": [], "time": [], "stat": []}
    converged = False
    it = 0
    for it in range(max_iters):
        stat = ops.gauss_seidel_sweep(At, colsq, x, r, c)
        v = torch.dot(r, r) + c * torch.sum(torch.abs(x))
        v, stat = torch.stack([v, stat]).tolist()
        hist["V"].append(v)
        hist["stat"].append(stat)
        hist["time"].append(time.perf_counter() - t_start)
        if stat <= tol:
            converged = True
            break
    return SolverResult(x=x, iters=it + 1, converged=converged,
                        history=hist, method="gauss_seidel")
