"""Sparse logistic regression (paper §2, [24, 25]):

  F(x) = Σⱼ log(1 + exp(−aⱼ yⱼᵀ x)),   G(x) = c‖x‖₁  (or group ℓ2).

F is convex with Lipschitz gradient; the diagonal curvature majorizer is
``0.25·Σⱼ yⱼᵢ²`` (since σ'(t) ≤ 1/4), which drives the Newton-type surrogate
(choice (7) with a diagonal Hessian bound).  The instance generator is a
verbatim host copy of ``repro.problems.logreg.random_logreg_instance``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.problems.base import Problem
from repro_torch.problems.lasso import (_fp32, _matvec, _power_iter_sq,
                                       _rmatvec, stacked_fns)


def logistic_fns(Z, col_sq=None):
    """The F = Σⱼ log(1+exp(−zⱼᵀx)) closure triple (f, grad_f, diag_curv).

    ``Z = diag(a)·Y`` is the label-signed feature matrix, (m, n) or
    (B, m, n) for a stack of instances (closures per instance, as
    :func:`~repro_torch.problems.lasso.stacked_fns` builds them);
    ``col_sq`` may be precomputed to avoid re-reducing ‖zᵢ‖² in a loop.
    """
    if col_sq is None:
        col_sq = (Z * Z).sum(-2)
    if Z.dim() == 3:
        return stacked_fns([logistic_fns(*arrs)
                            for arrs in zip(Z, col_sq)])

    def f(x):
        t = _matvec(Z, x)
        # log(1+e^{−t}) computed stably
        return torch.logaddexp(torch.zeros_like(t), -t).sum(-1)

    def grad_f(x):
        sig = torch.sigmoid(-_matvec(Z, x))      # = e^{−t}/(1+e^{−t})
        return -_rmatvec(Z, sig)

    def diag_curv(_):
        # Global bound: σ(t)σ(−t) ≤ 1/4  ⇒  diag(∇²F) ≤ 0.25·Σ zⱼᵢ².
        return 0.25 * col_sq

    return f, grad_f, diag_curv


def logreg_from_z(Z, c: float, block_size: int = 1, *,
                  device=DEFAULT_DEVICE) -> Problem:
    """The logistic :class:`Problem` over a label-signed design ``Z``."""
    Z = _fp32(Z, resolve_device(device))
    f, grad_f, diag_curv = logistic_fns(Z)
    return Problem(
        name="sparse_logreg", n=Z.shape[1], block_size=block_size,
        f=f, grad_f=grad_f, diag_curv=diag_curv,
        g_kind="l1" if block_size == 1 else "group_l2", g_weight=float(c),
        family="logreg", lipschitz=float(0.25 * _power_iter_sq(Z)),
        data={"Z": Z})


def make_logreg(Y, a, c: float, block_size: int = 1, *,
                device=DEFAULT_DEVICE) -> Problem:
    """Y: (m, n) feature rows yⱼ; a: (m,) labels in {−1, +1}.  Both are
    rounded to fp32 before ``Z = Y·a`` (the margins are z = Zx)."""
    dev = resolve_device(device)
    Y, a = _fp32(Y, dev), _fp32(a, dev)
    return logreg_from_z(Y * a[:, None], c, block_size, device=dev)


def random_logreg_arrays(m: int, n: int, nnz_frac: float, seed: int = 0):
    """Host float64 ``(Y, a)`` of the reference generator, verbatim."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((m, n))
    w = np.zeros(n)
    s = max(1, int(round(nnz_frac * n)))
    idx = rng.permutation(n)[:s]
    w[idx] = rng.standard_normal(s)
    logits = Y @ w + 0.3 * rng.standard_normal(m)
    a = np.where(logits > 0, 1.0, -1.0)
    return Y, a


def random_logreg_instance(m: int, n: int, nnz_frac: float, c: float = 0.5,
                           seed: int = 0, block_size: int = 1, *,
                           device=DEFAULT_DEVICE) -> Problem:
    """Separable-ish synthetic instance with a sparse ground-truth direction."""
    Y, a = random_logreg_arrays(m, n, nnz_frac, seed=seed)
    return make_logreg(Y, a, c, block_size=block_size, device=device)
