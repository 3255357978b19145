"""λ-grid construction for the regularization-path engine.

The homotopy driver (``repro_torch.path.driver``) sweeps a *decreasing* grid of
regularization weights c (the paper's ``g_weight``; λ in the screening
literature).  The anchor is

    λ_max  =  max_g ‖∇_g F(0)‖   (block norms of the gradient at zero),

the smallest weight at which x = 0 satisfies the KKT condition
``0 ∈ ∇F(0) + c·∂G(0)`` — i.e. the exact solution at every c ≥ λ_max is
identically zero.  For the repo's unnormalized Lasso (F = ‖Ax−b‖², ∇F =
2Aᵀ(Ax−b)) that is ``2‖Aᵀb‖∞``; for group Lasso the max group ℓ2 norm of
``2Aᵀb``.  Starting the path at λ_max gives the sequential strong rule a
*certified* first reference point (x(λ_max) = 0 exactly) for free.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.problems.base import Problem


def lambda_max(problem: Problem) -> float:
    """Smallest regularization weight with all-zero exact solution.

    Uses the problem's own block structure: per-coordinate |∇F(0)| under
    ℓ1, per-block ‖∇_g F(0)‖₂ under group-ℓ2.
    """
    g0 = problem.grad_f(torch.zeros((problem.n,), dtype=torch.float32,
                                    device=problem.device))
    return float(problem.block_norms(g0).max())


def geometric_grid(lam_max: float, n_points: int = 20,
                   lam_min_ratio: float = 0.01,
                   include_max: bool = True) -> np.ndarray:
    """Strictly decreasing geometric grid from λ_max to λ_max·ratio.

    The glmnet-style default: ``n_points`` weights log-uniformly spaced
    over [λ_max·lam_min_ratio, λ_max].  ``include_max=True`` keeps λ_max
    itself as the first point — its solution is x = 0 by construction, so
    the driver certifies it without spending a single iteration and every
    later point inherits an exact screening reference.
    """
    if lam_max <= 0:
        raise ValueError(f"lam_max must be positive, got {lam_max}")
    if n_points < 2:
        raise ValueError("a path needs at least 2 grid points")
    if not (0 < lam_min_ratio < 1):
        raise ValueError("lam_min_ratio must be in (0, 1)")
    grid = np.geomspace(lam_max, lam_max * lam_min_ratio, n_points)
    if not include_max:
        # Shift every point one geometric step down so the path still
        # spans the requested dynamic range without the trivial point.
        step = (lam_min_ratio) ** (1.0 / (n_points - 1))
        grid = grid * step
    return grid.astype(np.float64)


def validate_grid(lambdas) -> np.ndarray:
    """Check a user-supplied grid: positive and strictly decreasing."""
    lam = np.asarray(lambdas, np.float64).ravel()
    if lam.size == 0:
        raise ValueError("empty λ-grid")
    if np.any(lam <= 0):
        raise ValueError("λ-grid entries must be positive")
    if np.any(np.diff(lam) >= 0):
        raise ValueError("λ-grid must be strictly decreasing (homotopy "
                         "warm starts run from heavy to light "
                         "regularization)")
    return lam
