"""Surrogate curvature and best response (paper §3) for scalar blocks.

* ``linear``      — choice (5): curvature τᵢ, the scaled proximal step.
* ``exact_block`` — choice (6): curvature τᵢ + ∂²ᵢᵢF, closed form for
  quadratic F with scalar blocks (what the paper runs).
* ``newton_cg``   — choice (7): coincides with ``exact_block`` for scalar
  blocks.  Its inexact inner loop serves block problems (nᵢ > 1), which
  wait with the group-Lasso family.

Best responses are elementwise over the coordinate vector (with any
leading instance axes).  For the ℓ1 problems with scalar blocks (the
paper's Lasso) the best response, and under the full rule the update
that follows it, run as the fused kernels of
:mod:`repro_torch.kernels.ops` (the CUDA kernels on the card), whose
plain versions are these steps' torch expressions, rounding for
rounding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.problems.base import Problem


def curvature(problem: Problem, tau, surrogate: str) -> torch.Tensor:
    """Per-coordinate curvature dᵢ of the strongly-convex surrogate."""
    if surrogate == "linear":
        return tau                  # already per-coordinate (..., n)
    if surrogate in ("exact_block", "newton_cg"):
        return tau + problem.diag_curv(None)
    raise ValueError(f"unknown surrogate {surrogate!r}")


def fused(problem: Problem) -> bool:
    """Whether the best response is one soft threshold per coordinate
    with an active weight: ℓ1, scalar blocks, G on."""
    return (problem.g_kind == "l1" and problem.block_size == 1
            and not problem._g_off())


def _bucket(problem: Problem, x, grad, d):
    """x, ∇F, d as (B, n) rows (a solo x is one row) and c per row."""
    c = problem.g_weight
    if isinstance(c, torch.Tensor):
        c = c.reshape(-1)
    rows = (-1, problem.n)
    return x.reshape(rows), grad.reshape(rows), d.reshape(rows), c


def best_response(problem: Problem, x, grad, d):
    """x̂(x, τ) = argmin of the surrogate (Eq. (2)), blockwise: one prox
    (the fused batched best response where :func:`fused` holds)."""
    if fused(problem):
        z, _ = kops.flexa_best_response_batched(
            *_bucket(problem, x, grad, d))
        return z.view(x.shape)
    w = x - grad / d
    return problem.prox(w, 1.0 / d)


def full_update(problem: Problem, x, grad, d, gamma):
    """x + γ·(x̂ − x), γ per instance: step S.4 under the full rule, with
    x̂ recomputed by the fused kernel (needs :func:`fused`)."""
    return kops.flexa_apply_batched(*_bucket(problem, x, grad, d),
                                    gamma).view(x.shape)
