"""Lasso:  F(x) = ‖Ax − b‖²,  G(x) = c‖x‖₁  (the paper's headline problem).

Nesterov's instance generator is a verbatim host copy of
``repro.problems.lasso.nesterov_instance`` (numpy, float64), so one seed
gives the same A, b, x* and V* bit for bit in both packages; only the
final conversion to fp32 tensors on ``device`` is the port's own.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.problems.base import Problem


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x for A (m, n) and x (n,) or (B, n)."""
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def _rmatvec(A: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Aᵀ @ r for A (m, n) and r (m,) or (B, m)."""
    return torch.matmul(A.transpose(-1, -2), r.unsqueeze(-1)).squeeze(-1)


def stacked_fns(fns) -> tuple:
    """The closure triple of a stack of instances from one solo triple per
    instance: row i of x runs instance i's own closures, so a batched row
    takes its solo run's products and roundings bit for bit (one batched
    product sums in another order, and the greedy rule's ties at ρ·max E
    then part the trajectories)."""
    def f(x):
        return torch.stack([fi(xi) for (fi, _, _), xi in zip(fns, x)])

    def grad_f(x):
        return torch.stack([gi(xi) for (_, gi, _), xi in zip(fns, x)])

    def diag_curv(_):
        return torch.stack([ci(None) for _, _, ci in fns])

    return f, grad_f, diag_curv


def quadratic_fns(A, b, col_sq=None):
    """The F = ‖Ax−b‖² closure triple (f, grad_f, diag_curv).

    ∇F = 2Aᵀ(Ax−b) and ∂²F/∂xᵢ² = 2‖aᵢ‖².  ``A`` is (m, n), or (B, m, n)
    with ``b`` (B, m) or (m,) for a stack of instances (closures per
    instance: :func:`stacked_fns`); ``x`` may carry a leading batch
    dimension either way.
    """
    if col_sq is None:
        col_sq = (A * A).sum(-2)            # ‖aᵢ‖² per column
    if A.dim() == 3:
        bs = b if b.dim() == 2 else [b] * A.shape[0]
        return stacked_fns([quadratic_fns(*arrs)
                            for arrs in zip(A, bs, col_sq)])

    def f(x):
        r = _matvec(A, x) - b
        return (r * r).sum(-1)

    def grad_f(x):
        return 2.0 * _rmatvec(A, _matvec(A, x) - b)

    def diag_curv(_):
        return 2.0 * col_sq

    return f, grad_f, diag_curv


def _fp32(a, dev: torch.device) -> torch.Tensor:
    """Host array or tensor → fp32 tensor on ``dev`` (host arrays are
    copied, so the tensor never aliases the caller's buffer)."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)


def make_lasso(A, b, c: float, block_size: int = 1, v_star=None,
               x_star=None, name: str = "lasso", *,
               device=DEFAULT_DEVICE) -> Problem:
    """A Lasso :class:`Problem` on ``device`` from host or device arrays
    (group Lasso, ``g_kind="group_l2"``, when ``block_size > 1``)."""
    dev = resolve_device(device)
    A, b = _fp32(A, dev), _fp32(b, dev)
    f, grad_f, diag_curv = quadratic_fns(A, b)
    if x_star is not None:
        x_star = _fp32(x_star, dev)
    return Problem(
        name=name, n=A.shape[1], block_size=block_size,
        f=f, grad_f=grad_f, diag_curv=diag_curv,
        g_kind="l1" if block_size == 1 else "group_l2", g_weight=float(c),
        family="lasso" if block_size == 1 else "group_lasso",
        v_star=v_star, x_star=x_star,
        lipschitz=float(2.0 * _power_iter_sq(A)),
        data={"A": A, "b": b},
    )


def _power_iter_sq(A: torch.Tensor, iters: int = 50, seed: int = 0) -> float:
    """λmax(AᵀA) via power iteration on the thin side, in float64 on A's
    device, from the reference's numpy-seeded start vector."""
    rng = np.random.default_rng(seed)
    m, n = A.shape
    A64 = A.to(torch.float64)
    M = A64 @ A64.T if m <= n else A64.T @ A64
    del A64
    v = torch.as_tensor(rng.standard_normal(M.shape[0]),
                        dtype=torch.float64).to(A.device)
    v /= torch.linalg.vector_norm(v)
    lam = 0.0
    for _ in range(iters):
        w = M @ v
        lam = float(torch.linalg.vector_norm(w))
        v = w / max(lam, 1e-30)
    return lam


def nesterov_arrays(m: int, n: int, nnz_frac: float, c: float = 1.0,
                    seed: int = 0):
    """Nesterov's planted instance as host float64 arrays
    ``(A, b, x_star, v_star)`` — the reference generator, verbatim.

    Construction (adapted to the factor-2 gradient of the unnormalized F):
      1. random B ~ N(0,1), random residual y* ~ N(0,1) (normalized),
      2. u = Bᵀ y*;  on a support of size s rescale columns so ⟨aᵢ,y*⟩ = ±c/2,
         off support shrink columns whenever |⟨aᵢ,y*⟩| > (c/2)θᵢ, θᵢ~U(0,1),
      3. x*ᵢ = ξᵢ·sign(uᵢ) on the support (ξᵢ~U(0,1)), 0 elsewhere,
      4. b = A x* + y*  ⇒  ∇F(x*) = −2Aᵀy*, and by step 2 the optimality
         condition 0 ∈ ∇F(x*) + c∂‖x*‖₁ holds exactly.
    Then V* = ‖y*‖² + c‖x*‖₁ in closed form.
    """
    rng = np.random.default_rng(seed)
    s = max(1, int(round(nnz_frac * n)))
    B = rng.standard_normal((m, n))
    y = rng.standard_normal(m)
    y /= np.linalg.norm(y)

    u = B.T @ y
    half_c = 0.5 * c
    scale = np.ones(n)
    # Support: the s *largest* |uᵢ| (Nesterov's choice) — keeps the support
    # column rescaling c/(2|uᵢ|) bounded, i.e. a well-conditioned instance.
    order = np.argsort(-np.abs(u))
    sup, off = order[:s], order[s:]
    scale[sup] = half_c / np.abs(u[sup])
    theta = rng.uniform(0.0, 1.0, size=off.shape[0])
    too_big = np.abs(u[off]) > half_c * theta
    shrink = np.where(too_big, half_c * theta / np.abs(u[off]), 1.0)
    scale[off] = shrink
    A = B * scale[None, :]

    x_star = np.zeros(n)
    x_star[sup] = rng.uniform(0.0, 1.0, size=s) * np.sign(u[sup])
    b = A @ x_star + y

    v_star = float(y @ y + c * np.abs(x_star).sum())
    return A, b, x_star, v_star


def nesterov_instance(m: int, n: int, nnz_frac: float, c: float = 1.0,
                      seed: int = 0, block_size: int = 1, *,
                      device=DEFAULT_DEVICE) -> Problem:
    """Plant a known optimum for  min ‖Ax−b‖² + c‖x‖₁  (Nesterov [7]) and
    build the Lasso :class:`Problem` on ``device``."""
    A, b, x_star, v_star = nesterov_arrays(m, n, nnz_frac, c=c, seed=seed)
    return make_lasso(
        A, b, c, block_size=block_size, v_star=v_star, x_star=x_star,
        name=f"nesterov_lasso(m={m},n={n},nnz={nnz_frac:.0%})",
        device=device)
