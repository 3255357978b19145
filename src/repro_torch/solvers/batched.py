"""Batched multi-instance FLEXA: B independent solves in lockstep.

The reference vmaps Algorithm 1 over a stack of instances inside one
``lax.while_loop``.  Here the batch is a written-out leading dimension:
:func:`repro_torch.core.flexa.flexa_iteration` runs on ``x`` of shape
``(B, n)`` with per-instance γ, τ, weights ``c`` and freeze masks, and
the loop (:func:`repro_torch.core.flexa.run_frozen`) freezes converged
instances while stragglers keep iterating, reading the stop flags back
every ``CHECK_EVERY`` iterations.

Instances share one static signature (:class:`BatchedProblemSpec`).
When every instance carries the *same* data tensor (the λ-path: one
design matrix at several weights) it is used once, unstacked — the
products broadcast over the batch — instead of being copied B times.
Stacked data run one closure triple per instance
(:func:`repro_torch.problems.lasso.stacked_fns`).

Randomized selection rules draw from one generator per batch (seeded
from ``cfg.seed``), so their masks differ from solo runs; deterministic
rules (the default greedy) give each row of stacked data its solo
trajectory bit for bit, and each row of shared data its solo trajectory
up to fp32 summation order.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.config.base import SolverConfig
from repro_torch.core import flexa as _flexa
from repro_torch.core.flexa import FlexaState, flexa_iteration
from repro_torch.problems.base import Problem
from repro_torch.problems.families import build_problem, get_family, infer_family
from repro_torch.solvers.result import SolverResult


@dataclass(frozen=True)
class BatchedProblemSpec:
    """The static signature every instance in one batch must share."""
    m: int
    n: int
    block_size: int = 1
    g_kind: str = "l1"
    family: str = "lasso"

    @classmethod
    def of(cls, problem: Problem) -> "BatchedProblemSpec":
        family = infer_family(problem)
        fam = get_family(family)
        missing = [k for k in fam.data_keys if k not in problem.data]
        if missing:
            raise ValueError(
                f"batched FLEXA on family {family!r} needs problem data "
                f"{fam.data_keys} (got {problem.name!r} missing {missing})")
        design = problem.data[fam.data_keys[0]]
        return cls(m=int(design.shape[0]), n=int(problem.n),
                   block_size=int(problem.block_size),
                   g_kind=str(problem.g_kind), family=family)


def family_problem(arrays, c, spec: BatchedProblemSpec,
                   col_sq=None) -> Problem:
    """The batch's :class:`Problem` over (possibly stacked) data arrays;
    ``c`` is the ``(B, 1)`` weight column."""
    return build_problem(spec.family, arrays, c, n=spec.n,
                         block_size=spec.block_size, g_kind=spec.g_kind,
                         col_sq=col_sq)


def _tau_base(half_curv, cfg: SolverConfig, n: int) -> torch.Tensor:
    """The §4 default τ from ``diag_curv/2`` via the shared
    :func:`~repro_torch.core.flexa.tau0_from_colsq` (one row per
    instance when the data are stacked, each reduced as its solo run
    reduces it)."""
    if cfg.tau0 > 0:
        return torch.full((n,), cfg.tau0, dtype=torch.float32,
                          device=half_curv.device)
    if half_curv.dim() == 2:
        t0 = torch.stack([_flexa.tau0_from_colsq(h, n) for h in half_curv])
    else:
        t0 = _flexa.tau0_from_colsq(half_curv, n)
    t0 = t0.to(torch.float32)
    return t0.unsqueeze(-1).expand(t0.shape + (n,))


def make_batched_solver(spec: BatchedProblemSpec, cfg: SolverConfig):
    """``run(data, c, x0, active=None) -> (final FlexaState, converged)``.

    ``data`` is the tuple of family arrays, each either shared by the
    batch (e.g. ``A`` (m, n)) or stacked (``A`` (B, m, n)); ``c`` (B,),
    ``x0`` (B, n), ``active`` an optional (B, n) freeze mask (None
    freezes nothing, with the numbers of an all-ones mask, and lets the
    full rule take the fused update).
    """
    fam = get_family(spec.family)

    def run(data, c, x0, active=None):
        col_sq = fam.col_sq(*data)              # once per solve
        tau_base = _tau_base(fam.half_curv(col_sq), cfg, spec.n)
        problem = family_problem(data, c.unsqueeze(-1), spec,
                                 col_sq=col_sq)

        def step(state: FlexaState) -> FlexaState:
            return flexa_iteration(problem, cfg, tau_base, state,
                                   active=active)[0]

        final = _flexa.run_frozen(
            step, _flexa.init_state(problem, x0, cfg), cfg)
        return final, final.stat <= cfg.tol

    return run


def _stack_instances(problems: Sequence[Problem]):
    spec = BatchedProblemSpec.of(problems[0])
    for p in problems[1:]:
        other = BatchedProblemSpec.of(p)
        if other != spec:
            raise ValueError(
                f"all instances in a batch must share one shape signature; "
                f"got {spec} and {other}")
    fam = get_family(spec.family)
    device = problems[0].device
    data = []
    for k in fam.data_keys:
        arrs = [p.data[k] for p in problems]
        if all(a is arrs[0] for a in arrs):
            data.append(arrs[0].to(torch.float32))
        else:
            data.append(torch.stack([a.to(device, torch.float32)
                                     for a in arrs]))
    c = torch.tensor([float(p.g_weight) for p in problems],
                     dtype=torch.float32, device=device)
    return spec, tuple(data), c


def _batch_arg(v, B: int, n: int, name: str, device) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.float32).to(device)
    if t.shape != (B, n):
        raise ValueError(f"{name} must be (B, n) = {(B, n)}")
    return t


def _solve_batched(problems: Sequence[Problem], x0=None,
                   cfg: SolverConfig | None = None,
                   record_history: bool = False,
                   active=None) -> SolverResult:
    """Solve B same-signature instances in lockstep.

    Returns a :class:`SolverResult` with ``x`` (B, n) and per-instance
    ``iters`` / ``converged``.  ``record_history=True`` steps from the
    host and records the batched trajectory (lists of (B,) arrays);
    ``active`` is an optional (B, n) per-instance freeze mask.
    """
    cfg = cfg or SolverConfig()
    spec, data, c = _stack_instances(problems)
    B = len(problems)
    device = c.device
    x0 = (torch.zeros((B, spec.n), dtype=torch.float32, device=device)
          if x0 is None else _batch_arg(x0, B, spec.n, "x0", device))
    if active is not None:
        active = _batch_arg(active, B, spec.n, "active", device)

    t0 = time.perf_counter()
    if not record_history:
        run = make_batched_solver(spec, cfg)
        final, converged = run(data, c, x0, active)
        return SolverResult(
            x=final.x, iters=final.k.cpu().numpy(),
            converged=converged.cpu().numpy(), state=final,
            method="flexa_batched",
            meta={"batch": B, "family": spec.family,
                  "wall_s": time.perf_counter() - t0})

    # History path: same math, stepped from the host so the trajectory
    # can be recorded (convergence freezing identical).
    fam = get_family(spec.family)
    col_sq = fam.col_sq(*data)
    tau_base = _tau_base(fam.half_curv(col_sq), cfg, spec.n)
    problem = family_problem(data, c.unsqueeze(-1), spec, col_sq=col_sq)
    state = _flexa.init_state(problem, x0, cfg)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    hist: dict[str, list] = {k: [] for k in
                             _flexa.HISTORY_KEYS + ("time",)}
    while not bool(done.all()):
        new_state, info = flexa_iteration(problem, cfg, tau_base, state,
                                          active=active)
        state = _flexa.freeze_done(done, new_state, state)
        done = done | (state.stat <= cfg.tol) | (state.k >= cfg.max_iters)
        for key in _flexa.HISTORY_KEYS:
            hist[key].append(info[key].cpu().numpy())
        hist["time"].append(time.perf_counter() - t0)
    return SolverResult(
        x=state.x, iters=state.k.cpu().numpy(),
        converged=(state.stat <= cfg.tol).cpu().numpy(), state=state,
        history=hist, method="flexa_batched",
        meta={"batch": B, "family": spec.family,
              "wall_s": time.perf_counter() - t0})
