"""ℓ1-regularized ℓ2-loss SVM (paper §2, [18]):

  F(x) = Σⱼ max{0, 1 − aⱼ yⱼᵀx}²,   G(x) = c‖x‖₁.

The squared hinge is C¹ with Lipschitz-continuous gradient (A2–A3 hold);
``∇F(x) = −2 Zᵀ max(0, 1−Zx)`` with Z = diag(a)Y, and ``2Σⱼ zⱼᵢ²`` is a
diagonal curvature majorizer.  The instance generator is a verbatim host
copy of ``repro.problems.svm.random_svm_instance``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.problems.base import Problem
from repro_torch.problems.lasso import (_fp32, _matvec, _power_iter_sq,
                                       _rmatvec, stacked_fns)


def squared_hinge_fns(Z, col_sq=None):
    """The F = ‖max(0, 1−Zx)‖² closure triple (f, grad_f, diag_curv).

    ``Z = diag(a)·Y``, (m, n) or (B, m, n) (closures per instance, as
    :func:`~repro_torch.problems.lasso.stacked_fns` builds them);
    ``col_sq`` may be precomputed to avoid re-reducing ‖zᵢ‖² inside a
    solve loop.
    """
    if col_sq is None:
        col_sq = (Z * Z).sum(-2)
    if Z.dim() == 3:
        return stacked_fns([squared_hinge_fns(*arrs)
                            for arrs in zip(Z, col_sq)])

    def f(x):
        h = torch.clamp_min(1.0 - _matvec(Z, x), 0.0)
        return (h * h).sum(-1)

    def grad_f(x):
        h = torch.clamp_min(1.0 - _matvec(Z, x), 0.0)
        return -2.0 * _rmatvec(Z, h)

    def diag_curv(_):
        return 2.0 * col_sq

    return f, grad_f, diag_curv


def svm_from_z(Z, c: float, block_size: int = 1, *,
               device=DEFAULT_DEVICE) -> Problem:
    """The squared-hinge :class:`Problem` over a label-signed design ``Z``
    (ℓ1 whatever the block size, as the reference's)."""
    Z = _fp32(Z, resolve_device(device))
    f, grad_f, diag_curv = squared_hinge_fns(Z)
    return Problem(
        name="l1_l2_svm", n=Z.shape[1], block_size=block_size,
        f=f, grad_f=grad_f, diag_curv=diag_curv,
        g_kind="l1", g_weight=float(c), family="svm",
        lipschitz=float(2.0 * _power_iter_sq(Z)), data={"Z": Z})


def make_svm(Y, a, c: float, block_size: int = 1, *,
             device=DEFAULT_DEVICE) -> Problem:
    dev = resolve_device(device)
    Y, a = _fp32(Y, dev), _fp32(a, dev)
    return svm_from_z(Y * a[:, None], c, block_size, device=dev)


def random_svm_arrays(m: int, n: int, nnz_frac: float, seed: int = 0):
    """Host float64 ``(Y, a)`` of the reference generator, verbatim."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((m, n))
    w = np.zeros(n)
    s = max(1, int(round(nnz_frac * n)))
    w[rng.permutation(n)[:s]] = rng.standard_normal(s)
    a = np.where(Y @ w > 0, 1.0, -1.0)
    return Y, a


def random_svm_instance(m: int, n: int, nnz_frac: float, c: float = 0.5,
                        seed: int = 0, *, device=DEFAULT_DEVICE) -> Problem:
    Y, a = random_svm_arrays(m, n, nnz_frac, seed=seed)
    return make_svm(Y, a, c, device=device)
