"""Group Lasso:  F(x) = ‖Ax − b‖²,  G(x) = c Σᵢ ‖xᵢ‖₂  (paper §2, [23]).

Reuses the Lasso smooth part; blocks have size nᵢ = block_size > 1 and the
prox is the block shrinkage operator.  The planted-instance generator is
a verbatim host copy of ``repro.problems.group_lasso.
nesterov_group_instance`` (numpy, float64), so one seed gives the same A,
b, x* and V* in both packages; only the conversion to fp32 tensors on
``device`` is the port's own.
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.problems.base import Problem
from repro_torch.problems.lasso import make_lasso


def make_group_lasso(A, b, c: float, block_size: int, v_star=None,
                     x_star=None, *, device=DEFAULT_DEVICE) -> Problem:
    return make_lasso(A, b, c, block_size=block_size, v_star=v_star,
                      x_star=x_star, name="group_lasso", device=device)


def nesterov_group_arrays(m: int, n_blocks: int, block_size: int,
                          nnz_frac: float, c: float = 1.0, seed: int = 0):
    """The planted group-sparse instance as host float64 arrays
    ``(A, b, x_star, v_star)`` — the reference generator, verbatim.

    Optimality of x*:  per block i,  2Aᵢᵀ(Ax*−b) + c ∂‖x*ᵢ‖₂ ∋ 0, i.e.
      support blocks:   2Aᵢᵀy* = −c x*ᵢ/‖x*ᵢ‖₂  (gradient aligned, norm c/2·2)
      off blocks:       ‖2Aᵢᵀy*‖₂ ≤ c.
    Each block of columns is rescaled as a unit to satisfy these exactly.
    """
    rng = np.random.default_rng(seed)
    n = n_blocks * block_size
    s = max(1, int(round(nnz_frac * n_blocks)))
    B = rng.standard_normal((m, n))
    y = rng.standard_normal(m)
    y /= np.linalg.norm(y)

    U = (B.T @ y).reshape(n_blocks, block_size)
    unorm = np.linalg.norm(U, axis=1)
    half_c = 0.5 * c
    perm = rng.permutation(n_blocks)
    sup, off = perm[:s], perm[s:]

    scale = np.ones(n_blocks)
    scale[sup] = half_c / unorm[sup]
    theta = rng.uniform(0.0, 1.0, size=off.shape[0])
    too_big = unorm[off] > half_c * theta
    scale[off] = np.where(too_big, half_c * theta / unorm[off], 1.0)
    A = (B.reshape(m, n_blocks, block_size)
         * scale[None, :, None]).reshape(m, n)

    # Support blocks: x*ᵢ parallel to Aᵢᵀy* (= scaled Uᵢ), arbitrary length.
    X = np.zeros((n_blocks, block_size))
    lens = rng.uniform(0.2, 1.0, size=s)
    X[sup] = (U[sup] / unorm[sup, None]) * lens[:, None]
    x_star = X.reshape(n)
    b = A @ x_star + y

    v_star = float(y @ y + c * np.linalg.norm(X, axis=1).sum())
    return A, b, x_star, v_star


def nesterov_group_instance(m: int, n_blocks: int, block_size: int,
                            nnz_frac: float, c: float = 1.0, seed: int = 0,
                            *, device=DEFAULT_DEVICE) -> Problem:
    """Plant a known group-sparse optimum for the group-Lasso objective
    and build the :class:`Problem` on ``device``."""
    A, b, x_star, v_star = nesterov_group_arrays(
        m, n_blocks, block_size, nnz_frac, c=c, seed=seed)
    return make_group_lasso(A, b, c, block_size, v_star=v_star,
                            x_star=x_star, device=device)
