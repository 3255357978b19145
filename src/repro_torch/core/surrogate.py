"""Surrogate curvature and best response (paper §3).

* ``linear``      — choice (5): curvature τᵢ, the scaled proximal step.
* ``exact_block`` — choice (6): curvature τᵢ + ∂²ᵢᵢF, closed form for
  quadratic F with scalar blocks (what the paper runs); block problems
  take the blockwise max of ∂²ᵢᵢF, so the group prox stays exact.
* ``newton_cg``   — choice (7): coincides with ``exact_block`` for scalar
  blocks.  For block problems (group Lasso, nᵢ > 1) the subproblem is
  solved *inexactly* by an inner prox-gradient loop with a certified
  error bound, exercising Theorem 1's εᵢᵏ-inexactness feature.

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
        curv = problem.diag_curv(None)
        if problem.block_size > 1:
            # Block problems need a per-block scalar curvature so the group
            # prox stays exact; the blockwise max is a valid majorizer
            # (per instance row when the data are stacked).
            cb = problem.blockify(curv).max(-1).values
            curv = cb.repeat_interleave(problem.block_size, dim=-1)
        return tau + curv
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


def best_response(problem: Problem, x, grad, d, *,
                  inner_iters: int = 0, eps=None):
    """x̂(x, τ) = argmin of the surrogate (Eq. (2)), blockwise: one prox
    (the fused batched best response where :func:`fused` holds).

    With ``inner_iters > 0`` and block problems it runs an inner
    prox-gradient loop on the surrogate and returns a zᵏ with
    ``‖zᵏ − x̂‖ ≤ ε`` certified via the contraction bound (see below);
    with ``eps`` given it returns ``(z, cert)``.
    """
    if fused(problem):
        z, _ = kops.flexa_best_response_batched(
            *_bucket(problem, x, grad, d))
        z = z.view(x.shape)
    else:
        z = problem.prox(x - grad / d, 1.0 / d)
    if inner_iters <= 0 or problem.block_size == 1:
        return z
    # --- inexact path for nᵢ>1 Newton surrogates -------------------------
    # Surrogate per block: q(u) = gᵀ(u−x) + ½(u−x)ᵀ diag(d) (u−x) + g_i(u).
    # Prox-gradient on q with step 1/max(d) contracts at rate (1 − μ/L),
    # μ = min(d), L = max(d):  ‖z − ẑ‖ ≤ (L/μ)·‖z − T(z)‖.  L, μ and the
    # norm are taken per instance row, as the reference's vmap takes them.
    L = d.max(-1, keepdim=True).values
    mu = d.min(-1, keepdim=True).values

    def T(u):
        gq = grad + d * (u - x)
        return problem.prox(u - gq / L, 1.0 / L)

    for _ in range(inner_iters):
        z = T(z)
    if eps is not None:
        # One extra application measures the certified error (the
        # Theorem 1(v) check ‖z−T(z)‖·L/μ ≤ ε; the caller logs it).
        resid = torch.linalg.vector_norm(z - T(z), dim=-1)
        return z, resid * (L / mu).squeeze(-1)
    return z


def full_update(problem: Problem, x, grad, d, gamma):
    """x + γ·(x̂ − x), γ per instance: step S.4 under the full rule, with
    x̂ recomputed by the fused kernel (needs :func:`fused`)."""
    return kops.flexa_apply_batched(*_bucket(problem, x, grad, d),
                                    gamma).view(x.shape)
