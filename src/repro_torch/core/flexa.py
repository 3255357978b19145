"""Algorithm 1 — the Flexible Parallel Algorithm (FLEXA) driver.

  (S.1) termination: ‖x̂(xᵏ) − xᵏ‖∞ ≤ tol
  (S.2) best response zᵏ (exact or inexact, per surrogate choice)
  (S.3) selection mask from the error bound Eᵢ = ‖x̂ᵢ − xᵢᵏ‖
  (S.4) xᵏ⁺¹ = xᵏ + γᵏ (ẑᵏ − xᵏ), γᵏ from Eq. (4)
  plus the §4 practical τ-controller (double on objective increase, halve
  after ``tau_patience`` consecutive decreases, finitely many changes).

Two drivers, as in ``repro.core.flexa``:

* :func:`solve` — a Python loop that records a per-iteration history
  (objective, stationarity, |Sᵏ|, wall time); it reads the step's
  numbers back every iteration, as the benchmarks need.
* :func:`solve_compiled` — the production loop: the state stays on the
  device and the host reads the stop flag once every
  :data:`CHECK_EVERY` iterations.  A finished solve is frozen (its state
  stops changing), so the extra iterations up to the next check are
  inert and the result is identical to checking every iteration.

:func:`flexa_iteration` takes ``x`` of shape ``(n,)`` or ``(B, n)``: the
batched engine runs it on a leading batch dimension where the reference
vmaps it.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from repro_torch.config.base import SolverConfig
from repro_torch.core import selection, stepsize
from repro_torch.core.result import SolverResult
from repro_torch.core.surrogate import (best_response, curvature,
                                        full_update, fused)
from repro_torch.problems.base import Problem

#: Iterations between two host reads of the stop flag in the device loops.
CHECK_EVERY = 16

MAX_TAU_CHANGES = 60  # "finite number of changes" cap (Theorem 1 compliance)

#: History keys the per-iteration driver records (plus ``time``).
HISTORY_KEYS = ("V", "stat", "E_max", "sel_frac", "gamma", "tau_scale")


class FlexaState(NamedTuple):
    x: torch.Tensor
    gamma: torch.Tensor          # γᵏ (scalar, or (B,))
    tau_scale: torch.Tensor      # multiplier on the base τ vector
    v_prev: torch.Tensor         # V(xᵏ)
    consec_dec: torch.Tensor     # consecutive-decrease counter (τ rule)
    n_tau_changes: torch.Tensor  # finite-change budget accounting
    k: torch.Tensor              # iteration counter
    stat: torch.Tensor           # ‖x̂(xᵏ)−xᵏ‖∞ of the *last* step
    gen: Optional[torch.Generator]   # randomized selection rules only


def make_generator(cfg: SolverConfig, device) -> torch.Generator | None:
    """The selection rule's generator, seeded from ``cfg.seed`` (None for
    rules that draw nothing)."""
    if cfg.jacobi or not selection.needs_generator(cfg.selection):
        return None
    return torch.Generator(device=device).manual_seed(cfg.seed)


def tau0_from_colsq(col_sq, n: int):
    """Paper §4 default  τᵢ = tr(AᵀA)/2n  from the column norms ‖aᵢ‖²
    (reduced over the last axis)."""
    return col_sq.sum(-1) / (2.0 * n)


def default_tau0(problem: Problem) -> float:
    """Paper §4: τᵢ = tr(AᵀA)/2n for Lasso-type quadratics."""
    col_sq = problem.diag_curv(None) / 2.0
    return float(tau0_from_colsq(col_sq, problem.n))


def _base_tau(problem: Problem, cfg: SolverConfig) -> torch.Tensor:
    t0 = cfg.tau0 if cfg.tau0 > 0 else default_tau0(problem)
    return torch.full((problem.n,), t0, dtype=torch.float32,
                      device=problem.device)


def init_state(problem: Problem, x0, cfg: SolverConfig,
               gen: torch.Generator | None = None) -> FlexaState:
    """Iteration-0 state at ``x0`` (``(n,)`` or ``(B, n)``).  ``gen``
    defaults to :func:`make_generator`."""
    x0 = torch.as_tensor(x0, dtype=torch.float32).to(problem.device)
    lead = x0.shape[:-1]

    def full(v, dtype):
        return torch.full(lead, v, dtype=dtype, device=x0.device)

    return FlexaState(
        x=x0,
        gamma=full(cfg.gamma0, torch.float32),
        tau_scale=full(1.0, torch.float32),
        v_prev=problem.v(x0).to(torch.float32),
        consec_dec=full(0, torch.int32),
        n_tau_changes=full(0, torch.int32),
        k=full(0, torch.int32),
        stat=full(float("inf"), torch.float32),
        gen=make_generator(cfg, x0.device) if gen is None else gen,
    )


def flexa_iteration(problem: Problem, cfg: SolverConfig,
                    tau_base: torch.Tensor, state: FlexaState,
                    active: torch.Tensor | None = None):
    """One Algorithm-1 iteration ``state -> (state, info)`` — S.2–S.4 plus
    the §4 τ-controller.

    ``active`` is an optional per-coordinate {0,1} freeze mask (the
    λ-path's screening hook): coordinates with ``active == 0`` are
    excluded from Sᵏ, never updated, and excluded from the ‖x̂−x‖∞
    termination measure.  ``None`` and an all-ones mask give the same
    numbers (the multiplies are by exact 1.0s).
    """
    x = state.x
    tau = tau_base * state.tau_scale.unsqueeze(-1)
    grad = problem.grad_f(x)
    d = curvature(problem, tau, cfg.surrogate)
    if active is not None:
        active = active.to(torch.float32)
        active_b = active if problem.block_size == 1 \
            else problem.blockify(active)[..., 0]

    # (S.2) best response; optionally inexact with the Thm-1(v) schedule.
    if cfg.inexact_alpha1 > 0 and problem.block_size > 1:
        inner = 5  # few inner prox-grad steps; cert recorded in info
        zhat, cert = best_response(problem, x, grad, d,
                                   inner_iters=inner, eps=0.0)
    else:
        zhat = best_response(problem, x, grad, d)
        cert = torch.zeros(x.shape[:-1], dtype=torch.float32,
                           device=x.device)

    # (S.3) error bound + selection rule.  Screened-out blocks contribute
    # E = 0, so the greedy threshold ρ·M is measured over the surviving
    # subproblem, and the final mask multiply keeps them out of Sᵏ.
    E = problem.block_norms(zhat - x)
    if active is not None:
        E = E * active_b
    M = E.max(-1).values
    mask_b = selection.make_mask(E, cfg, state.gen, state.k, M=M)
    if active is not None:
        mask_b = mask_b * active_b
    mask = mask_b if problem.block_size == 1 \
        else mask_b.repeat_interleave(problem.block_size, dim=-1)

    # (S.4) damped, masked update.  Under the full rule with nothing
    # frozen the mask is all ones, and the fused kernel gives the same
    # bits: x + γ·(x̂ − x), x̂ recomputed instead of read back.
    if active is None and selection.is_full(cfg) and fused(problem):
        xnew = full_update(problem, x, grad, d, state.gamma)
    else:
        xnew = x + state.gamma.unsqueeze(-1) * mask * (zhat - x)
    v_new = problem.v(xnew)

    # §4 τ-controller (finitely many changes).
    can_change = state.n_tau_changes < MAX_TAU_CHANGES
    adapt = bool(cfg.tau_adapt)
    rose = v_new > state.v_prev
    increased = rose & can_change & adapt
    consec = torch.where(rose, torch.zeros_like(state.consec_dec),
                         state.consec_dec + 1)
    halve = (consec >= cfg.tau_patience) & can_change & adapt
    tau_scale = torch.where(increased, state.tau_scale * cfg.tau_grow,
                            state.tau_scale)
    tau_scale = torch.where(halve, tau_scale * cfg.tau_shrink, tau_scale)
    consec = torch.where(halve, torch.zeros_like(consec), consec)
    n_changes = state.n_tau_changes + increased.to(torch.int32) \
        + halve.to(torch.int32)

    # ‖x̂−x‖∞ termination measure (surviving coordinates only).
    step_err = torch.abs(zhat - x)
    if active is not None:
        step_err = step_err * active
    stat = step_err.max(-1).values
    new_state = FlexaState(
        x=xnew,
        gamma=stepsize.gamma_next(state.gamma, cfg.theta),
        tau_scale=tau_scale,
        v_prev=v_new,
        consec_dec=consec,
        n_tau_changes=n_changes,
        k=state.k + 1,
        stat=stat,
        gen=state.gen,
    )
    info = {
        "V": v_new,
        "stat": stat,
        "E_max": M,
        "sel_frac": mask_b.mean(-1),
        "gamma": state.gamma,
        "tau_scale": tau_scale,
        "inexact_cert": cert,
    }
    return new_state, info


def freeze_done(done: torch.Tensor, new: FlexaState,
                old: FlexaState) -> FlexaState:
    """Keep ``old`` on the instances already finished (their k stops)."""
    def merge(a, b):
        if not isinstance(a, torch.Tensor):
            return a
        keep = done.reshape(done.shape + (1,) * (a.ndim - done.ndim))
        return torch.where(keep, b, a)
    return FlexaState(*(merge(a, b) for a, b in zip(new, old)))


def _finished(state: FlexaState, cfg: SolverConfig) -> torch.Tensor:
    return (state.stat <= cfg.tol) | (state.k >= cfg.max_iters)


def run_frozen(step, state: FlexaState, cfg: SolverConfig) -> FlexaState:
    """Iterate ``step`` until every instance has stopped (stat ≤ tol or
    k ≥ max_iters), reading the stop flag every :data:`CHECK_EVERY`
    iterations (and never stepping more than max_iters times: ``state``
    starts at k = 0); finished instances are frozen, so the result equals
    a loop that checks after every iteration."""
    done = _finished(state, cfg)
    steps = 0
    while not bool(done.all()):
        # No chunk runs past max_iters steps: by then every instance has
        # stopped (k counts from 0 at most once per step).
        for _ in range(max(1, min(CHECK_EVERY, cfg.max_iters - steps))):
            state = freeze_done(done, step(state), state)
            done = done | _finished(state, cfg)
        steps += CHECK_EVERY
    return state


def as_x0(problem: Problem, x0) -> torch.Tensor:
    """The start point: ``x0`` as fp32 on the problem's device (zeros
    when None); may alias an ``x0`` already there."""
    if x0 is None:
        return torch.zeros((problem.n,), dtype=torch.float32,
                           device=problem.device)
    return torch.as_tensor(x0, dtype=torch.float32).to(problem.device)


def solve(problem: Problem, x0=None, cfg: SolverConfig | None = None,
          callback=None, active=None) -> SolverResult:
    """Python-loop driver with history recording (benchmark path).

    ``active`` restricts the solve to a fixed per-coordinate active set;
    frozen coordinates keep their ``x0`` value."""
    cfg = cfg or SolverConfig()
    tau_base = _base_tau(problem, cfg)
    if active is not None:
        active = torch.as_tensor(active, dtype=torch.float32).to(
            problem.device)
    state = init_state(problem, as_x0(problem, x0), cfg)

    hist: dict[str, list] = {k: [] for k in HISTORY_KEYS + ("time",)}
    t0 = time.perf_counter()
    converged = False
    for it in range(cfg.max_iters):
        state, info = flexa_iteration(problem, cfg, tau_base, state,
                                      active=active)
        # One device-to-host read per iteration for all recorded values.
        vals = torch.stack([info[k].to(torch.float32)
                            for k in HISTORY_KEYS]).tolist()
        for key, v in zip(HISTORY_KEYS, vals):
            hist[key].append(v)
        hist["time"].append(time.perf_counter() - t0)
        if callback is not None:
            callback(it, state, info)
        if hist["stat"][-1] <= cfg.tol:
            converged = True
            break
    return SolverResult(x=state.x, iters=int(state.k), converged=converged,
                        state=state, history=hist, method="flexa")


def solve_compiled(problem: Problem, x0=None,
                   cfg: SolverConfig | None = None) -> SolverResult:
    """Device-resident driver: no host read per step beyond the stop flag
    every :data:`CHECK_EVERY` iterations; no history."""
    cfg = cfg or SolverConfig()
    tau_base = _base_tau(problem, cfg)

    def step(state):
        return flexa_iteration(problem, cfg, tau_base, state)[0]

    final = run_frozen(step, init_state(problem, as_x0(problem, x0), cfg),
                       cfg)
    return SolverResult(x=final.x, iters=int(final.k),
                        converged=bool(final.stat <= cfg.tol), state=final,
                        method="flexa_compiled")
