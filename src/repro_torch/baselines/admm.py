"""ADMM for Lasso [31, 32] (paper §4 benchmark (ii)).

A port of ``repro.baselines.admm``.  Splitting
min ‖Ax−b‖² + c‖z‖₁  s.t. x = z, scaled-dual form:

  x ← (2AᵀA + ρI)⁻¹ (2Aᵀb + ρ(z − u))
  z ← soft(x + u, c/ρ)
  u ← u + x − z

The x-update's solve is factored once, with the Woodbury identity on the
thin side (m ≪ n in all paper instances):

  (ρI + 2AᵀA)⁻¹ v = (1/ρ)·(v − Aᵀ (ρ/2·I + AAᵀ)⁻¹ A v)

the m×m Gram matrix factored once by ``torch.linalg.cholesky`` and
solved with ``torch.cholesky_solve``, both upper, as the reference's
``jax.scipy`` ``cho_factor`` / ``cho_solve``.  The Gram product and the factorization are
charged to the history clock, as the reference charges them.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.flexa import as_x0
from repro_torch.core.prox import soft_threshold
from repro_torch.core.result import SolverResult
from repro_torch.problems.base import Problem


def solve(problem: Problem, rho: float = 10.0, x0=None,
          max_iters: int = 2000, tol: float = 1e-6) -> SolverResult:
    t_start = time.perf_counter()
    A = problem.data.get("A")
    b = problem.data.get("b")
    if A is None:
        raise ValueError("ADMM baseline requires quadratic data A, b")
    m = A.shape[0]
    c = problem.g_weight
    x0 = as_x0(problem, x0)

    Atb2 = 2.0 * (A.T @ b)
    gram = A @ A.T + 0.5 * rho * torch.eye(m, dtype=A.dtype,
                                           device=A.device)
    chol = torch.linalg.cholesky(gram, upper=True)

    def x_update(v):
        w = torch.cholesky_solve((A @ v).unsqueeze(-1), chol,
                                 upper=True).squeeze(-1)
        return (v - A.T @ w) / rho

    x = z = u = x0
    hist = {"V": [], "time": [], "stat": []}
    converged = False
    it = 0
    for it in range(max_iters):
        x = x_update(Atb2 + rho * (z - u))
        z_new = soft_threshold(x + u, c / rho)
        u = u + x - z_new
        z = z_new
        stat = torch.max(torch.abs(x - z))   # primal residual ∞-norm
        v, stat = torch.stack([problem.v(z).to(torch.float32),
                               stat]).tolist()
        hist["V"].append(v)
        hist["stat"].append(stat)
        hist["time"].append(time.perf_counter() - t_start)
        if stat <= tol:
            converged = True
            break
    return SolverResult(x=z, iters=it + 1, converged=converged,
                        history=hist, method="admm")
