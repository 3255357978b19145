"""Surrogate curvature and best response (paper §3) for scalar blocks.

* ``linear``      — choice (5): curvature τᵢ, the scaled proximal step.
* ``exact_block`` — choice (6): curvature τᵢ + ∂²ᵢᵢF, closed form for
  quadratic F with scalar blocks (what the paper runs).
* ``newton_cg``   — choice (7): coincides with ``exact_block`` for scalar
  blocks.  Its inexact inner loop serves block problems (nᵢ > 1), which
  wait with the group-Lasso family.

Best responses are elementwise over the coordinate vector (with any
leading instance axes).
"""
from __future__ import annotations

import torch

from repro_torch.problems.base import Problem


def curvature(problem: Problem, tau, surrogate: str) -> torch.Tensor:
    """Per-coordinate curvature dᵢ of the strongly-convex surrogate."""
    if surrogate == "linear":
        return tau                  # already per-coordinate (..., n)
    if surrogate in ("exact_block", "newton_cg"):
        return tau + problem.diag_curv(None)
    raise ValueError(f"unknown surrogate {surrogate!r}")


def best_response(problem: Problem, x, grad, d):
    """x̂(x, τ) = argmin of the surrogate (Eq. (2)), blockwise: one prox."""
    w = x - grad / d
    return problem.prox(w, 1.0 / d)
