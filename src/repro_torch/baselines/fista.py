"""FISTA [30] — the paper's benchmark algorithm for Lasso.

A port of ``repro.baselines.fista``: accelerated proximal gradient with
the constant step 1/L_F, L_F the problem's ``lipschitz`` (the power
iteration of :mod:`repro_torch.problems.lasso`, the initialization cost
the paper highlights).  History timestamps start with the call, as
Fig. 1 times it.  One host read per iteration: V and the stationarity
measure max |x_new − x| together.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.flexa import as_x0
from repro_torch.core.result import SolverResult
from repro_torch.problems.base import Problem

# Unified result contract; the historical name is kept because every
# baseline module of the reference re-exports it.
BaselineResult = SolverResult


def _step(problem: Problem, L: float, x, y, t):
    g = problem.grad_f(y)
    x_new = problem.prox(y - g / L, 1.0 / L)
    t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
    y_new = x_new + ((t - 1.0) / t_new) * (x_new - x)
    stat = torch.max(torch.abs(x_new - x))
    return x_new, y_new, t_new, problem.v(x_new), stat


def solve(problem: Problem, x0=None, max_iters: int = 2000,
          tol: float = 1e-6) -> SolverResult:
    t_start = time.perf_counter()
    x = as_x0(problem, x0)
    L = problem.lipschitz
    if L is None:
        raise ValueError("FISTA needs a Lipschitz estimate")
    y, t = x, torch.ones((), dtype=torch.float32, device=x.device)
    hist = {"V": [], "time": [], "stat": []}
    converged = False
    it = 0
    for it in range(max_iters):
        x, y, t, v, stat = _step(problem, L, x, y, t)
        v, stat = torch.stack([v.to(torch.float32), stat]).tolist()
        hist["V"].append(v)
        hist["stat"].append(stat)
        hist["time"].append(time.perf_counter() - t_start)
        if stat <= tol:
            converged = True
            break
    return SolverResult(x=x, iters=it + 1, converged=converged,
                        history=hist, method="fista")
