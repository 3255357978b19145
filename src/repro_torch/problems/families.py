"""Problem-family registry: ``lasso``, ``group_lasso``, ``logreg``, ``svm``.

A :class:`ProblemFamily` packages what the batched engine needs to
rebuild an instance's F closures from raw data tensors: the data keys,
the closure builder (the very builder the solo constructor installs),
the curvature scale used by the §4 default τ, and the screening hook of
the λ-path.  G stays orthogonal: the family fixes F, while ``g_kind`` /
``block_size`` select the prox, so sparse and group-sparse logistic
regression are one family.

:func:`problem_from_arrays` and :func:`state_from_arrays` carry host
(numpy) data across to the port: tests hand the same arrays to both
packages, so no object of the reference ever enters the port.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.core.flexa import FlexaState, make_generator
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.problems.base import Problem
from repro_torch.problems.group_lasso import make_group_lasso
from repro_torch.problems.lasso import make_lasso, quadratic_fns
from repro_torch.problems.logreg import logistic_fns, logreg_from_z
from repro_torch.problems.svm import squared_hinge_fns, svm_from_z

#: Families of the reference that this port does not implement yet.
NOT_YET_PORTED = ()


@dataclass(frozen=True)
class ProblemFamily:
    name: str
    data_keys: tuple            # Problem.data arrays stacked per instance
    make_fns: Callable          # (*arrays, col_sq=None) -> (f, grad, curv)
    curv_scale: float           # diag_curv == curv_scale * col_sq
    # Safe-screening hook (repro_torch.path.screening): gradient ->
    # per-block dual-correlation scores (None ⇒ not screenable).
    screen_scores: Callable | None = None   # (grad, block_size) -> (n_blocks,)

    @property
    def screenable(self) -> bool:
        return self.screen_scores is not None

    def col_sq(self, *arrays) -> torch.Tensor:
        """‖column‖² of the (m, n) design matrix (arrays[0]); a stack of
        instances takes one reduction per instance, its solo run's (a
        reduction over the stack sums in another order on the card)."""
        A = arrays[0]
        if A.dim() == 3:
            return torch.stack([self.col_sq(a) for a in A])
        return (A * A).sum(-2)

    def half_curv(self, col_sq) -> torch.Tensor:
        """diag_curv/2 — what the §4 default τ rule reduces over."""
        return 0.5 * self.curv_scale * col_sq


_FAMILIES: dict[str, ProblemFamily] = {}


def register_family(fam: ProblemFamily) -> ProblemFamily:
    if fam.name in _FAMILIES:
        raise ValueError(f"problem family {fam.name!r} already registered")
    _FAMILIES[fam.name] = fam
    return fam


def get_family(name: str) -> ProblemFamily:
    try:
        return _FAMILIES[name]
    except KeyError:
        raise KeyError(f"unknown problem family {name!r}; available: "
                       f"{available_families()}") from None


def available_families() -> tuple[str, ...]:
    return tuple(sorted(_FAMILIES))


def _lasso_screen_scores(grad, block_size: int):
    """ℓ1 correlation bound |∇ⱼF(x)| = |2 aⱼᵀ(Ax − b)| per coordinate
    (KKT: xⱼ = 0 is optimal only if |∇ⱼF| ≤ c)."""
    return torch.abs(grad)


def _block_grad_norms(grad, block_size: int):
    return torch.linalg.vector_norm(
        grad.reshape(grad.shape[:-1] + (-1, block_size)), dim=-1)


def _group_lasso_screen_scores(grad, block_size: int):
    """Group-norm bound: ‖∇_g F(x)‖₂ per block (block KKT: a zero group is
    optimal only if its gradient group-norm is ≤ c)."""
    return _block_grad_norms(grad, block_size)


def _grad_block_scores(grad, block_size: int):
    """The generic dual-correlation bound for any smooth F: |∇ⱼF| under
    ℓ1 blocks, ‖∇_g F‖₂ under group blocks — the KKT zero-block
    condition is ``score_g ≤ c`` for every convex differentiable F.  The
    strong rule's unit-slope assumption is a heuristic beyond the
    quadratic; the KKT recheck keeps the path exact where it misses."""
    if block_size == 1:
        return torch.abs(grad)
    return _block_grad_norms(grad, block_size)


register_family(ProblemFamily(
    name="lasso", data_keys=("A", "b"),
    make_fns=quadratic_fns, curv_scale=2.0,
    screen_scores=_lasso_screen_scores))
# Same smooth part as lasso; the group structure lives in the G side of the
# shape signature (block_size > 1, g_kind="group_l2").
register_family(ProblemFamily(
    name="group_lasso", data_keys=("A", "b"),
    make_fns=quadratic_fns, curv_scale=2.0,
    screen_scores=_group_lasso_screen_scores))
register_family(ProblemFamily(
    name="logreg", data_keys=("Z",),
    make_fns=logistic_fns, curv_scale=0.25,
    screen_scores=_grad_block_scores))
register_family(ProblemFamily(
    name="svm", data_keys=("Z",),
    make_fns=squared_hinge_fns, curv_scale=2.0,
    screen_scores=_grad_block_scores))


def infer_family(problem: Problem) -> str:
    """The family of a :class:`Problem` (explicit field, else structural)."""
    if problem.family:
        return problem.family
    if "A" in problem.data:
        return "lasso" if problem.block_size == 1 else "group_lasso"
    raise ValueError(
        "cannot infer a problem family for "
        f"{problem.name!r} (set Problem.family to one of "
        f"{available_families()})")


def build_problem(family: str, arrays, c, *, n: int, block_size: int,
                  g_kind: str, col_sq=None) -> Problem:
    """Rebuild a family :class:`Problem` from raw tensors (no host work).

    ``c`` is a float, or a ``(B, 1)`` tensor when ``arrays`` carry a
    batch of instances (see :mod:`repro_torch.problems.base`).
    """
    fam = get_family(family)
    f, grad_f, diag_curv = fam.make_fns(*arrays, col_sq=col_sq)
    return Problem(
        name=f"batched_{family}", n=n, block_size=block_size,
        f=f, grad_f=grad_f, diag_curv=diag_curv,
        g_kind=g_kind, g_weight=c, family=family,
        data=dict(zip(fam.data_keys, arrays)))


def problem_from_arrays(family: str, arrays: Mapping, c: float, *,
                        block_size: int = 1,
                        device=DEFAULT_DEVICE) -> Problem:
    """The port's :class:`Problem` from host arrays of a family's data
    (``{"A": ..., "b": ...}`` for the two Lasso families, ``{"Z": ...}``
    for logreg and svm) and its weight ``c``."""
    fam = get_family(family)
    missing = [k for k in fam.data_keys if k not in arrays]
    if missing:
        raise ValueError(f"family {family!r} needs arrays {fam.data_keys}; "
                         f"missing {missing}")
    if family in ("lasso", "group_lasso"):
        make = make_lasso if family == "lasso" else make_group_lasso
        p = make(arrays["A"], arrays["b"], c, block_size=block_size,
                 device=device)
        if p.family != family:
            raise ValueError(f"block_size {block_size} makes a "
                             f"{p.family!r} problem, not {family!r}")
        return p
    make = logreg_from_z if family == "logreg" else svm_from_z
    return make(arrays["Z"], c, block_size, device=device)


def problem_on(problem: Problem, device) -> Problem:
    """``problem`` with its data on ``device`` (itself when already there).

    Registered families rebuild their closures over the moved data and
    keep their certificates; ad-hoc problems cannot be moved.
    """
    dev = resolve_device(device)
    if problem.device == dev:
        return problem
    family = infer_family(problem)
    fam = get_family(family)
    arrays = [problem.data[k].to(dev) for k in fam.data_keys]
    f, grad_f, diag_curv = fam.make_fns(*arrays)
    return dataclasses.replace(
        problem, f=f, grad_f=grad_f, diag_curv=diag_curv,
        x_star=None if problem.x_star is None else problem.x_star.to(dev),
        data=dict(zip(fam.data_keys, arrays)))


def state_from_arrays(arrays: Mapping, *, cfg=None, device=DEFAULT_DEVICE):
    """A :class:`~repro_torch.core.flexa.FlexaState` from host arrays.

    ``arrays`` holds the reference state's fields by name (``x``,
    ``gamma``, ``tau_scale``, ``v_prev``, ``consec_dec``,
    ``n_tau_changes``, ``k``, ``stat``) as numpy values — a warm start
    carried across packages.  The randomized selection rules get a fresh
    generator seeded from ``cfg.seed`` (generators do not cross).
    """
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.from_numpy(np.array(arrays[name])).to(dev, dtype)

    f32, i32 = torch.float32, torch.int32
    return FlexaState(
        x=t("x", f32), gamma=t("gamma", f32), tau_scale=t("tau_scale", f32),
        v_prev=t("v_prev", f32), consec_dec=t("consec_dec", i32),
        n_tau_changes=t("n_tau_changes", i32), k=t("k", i32),
        stat=t("stat", f32),
        gen=None if cfg is None else make_generator(cfg, dev))
