"""Homotopy driver: warm-started λ-path solving with safe screening.

A port of ``repro.path.driver._solve_path``.  ``_solve_path`` sweeps a
decreasing λ-grid (``repro_torch.path.grid``) over one problem instance;
every point runs through the batched engine
(``repro_torch.solvers.batched._solve_batched`` — B = 1, or B =
``lam_batch`` for λ-chunked grids) with

* **warm starts** — point k starts from the solution at point k−1;
* **safe screening** — the sequential strong rule
  (``repro_torch.path.screening``) freezes blocks predicted zero at the
  new weight through the solver's freeze mask
  (``flexa_iteration(active=...)``);
* a **KKT recheck** after every screened solve that re-admits violators
  and re-solves, so every returned solution is exact;
* optionally (``compact=True``) **compaction** — each KKT round packs the
  certified active columns into a power-of-two capacity bucket
  (``repro_torch.solvers.compaction``, through the CUDA gather/scatter
  kernels on the card) and solves the narrow problem.

``_solve_path_batched`` runs B instances that share one shape signature
(the K-fold cross-validation workload: one fold per instance) down one
grid in lockstep — one batched solve per point (and per KKT round), with
per-instance warm starts and screening masks.

Work accounting matches the reference: a **device row-iteration** is one
instance-row advanced one FLEXA iteration, and ``device_flops`` prices
it at m × program width.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.config.base import SolverConfig
from repro_torch.core.flexa import tau0_from_colsq
from repro_torch.obs import trace as obs
from repro_torch.obs.ledger import CostLedger
from repro_torch.problems.base import Problem
from repro_torch.problems.families import build_problem, get_family, infer_family
from repro_torch.path.grid import geometric_grid, lambda_max, validate_grid
from repro_torch.path.screening import (DEFAULT_KKT_SLACK, ScreenReport,
                                        block_scores, expand_blocks,
                                        kkt_violations, strong_rule_active)
from repro_torch.solvers.batched import _solve_batched
from repro_torch.solvers.compaction import make_plan

#: Screening falls back to an unscreened solve after this many KKT
#: re-admission rounds at one path point (never observed > 2 in anger;
#: the fallback guarantees exactness whatever the rule did).
MAX_KKT_ROUNDS = 8


@dataclass
class PathResult:
    """One solved regularization path (per-λ leading axis P)."""
    lambdas: np.ndarray         # (P,) decreasing weights
    x: np.ndarray               # (P, n) exact solutions
    V: np.ndarray               # (P,) objective F + λ·G at the solution
    iters: np.ndarray           # (P,) solver iterations spent (KKT rounds
                                #      included; 0 for certified-trivial
                                #      points at λ ≥ λ_max)
    converged: np.ndarray       # (P,) bool
    support: np.ndarray         # (P,) nonzero blocks of the solution
    active_blocks: np.ndarray   # (P,) blocks the solver actually ran
    screened: list = field(default_factory=list)   # per-λ ScreenReport
    row_iters: int = 0          # Σ device row-iterations over the path
    device_flops: int = 0       # Σ iters × B × m × program-width (matvec
                                #   currency; what compaction shrinks)
    lam_max: float = 0.0
    meta: dict = field(default_factory=dict)
    ledger: CostLedger | None = None    # unified stack-wide accounting
                                        # (row/live/flops/waste/compiles);
                                        # row_iters/device_flops above are
                                        # kept as mirrors of its keys

    @property
    def n_points(self) -> int:
        return int(self.lambdas.shape[0])


def _problem_at(problem: Problem, c: float) -> Problem:
    """The same instance at regularization weight ``c`` (certificates for
    the original weight are dropped — they no longer apply)."""
    return dataclasses.replace(
        problem, g_weight=float(c), v_star=None, x_star=None,
        name=f"{problem.name}@c={c:.3g}")


def _resolve_grid(problem: Problem, lambdas, n_points: int,
                  lam_min_ratio: float) -> tuple[np.ndarray, float]:
    lam_max = lambda_max(problem)
    if lambdas is None:
        grid = geometric_grid(lam_max, n_points=n_points,
                              lam_min_ratio=lam_min_ratio)
    else:
        grid = validate_grid(lambdas)
    return grid, lam_max


def _solve_path(problem: Problem, lambdas=None, *, n_points: int = 20,
                lam_min_ratio: float = 0.01,
                cfg: SolverConfig | None = None,
                warm: bool = True, screen: bool = True,
                kkt_slack: float = DEFAULT_KKT_SLACK,
                lam_batch: int = 1, tol_schedule=None,
                compact: bool = False, clock=None) -> PathResult:
    """Solve a decreasing λ-grid for one Lasso instance.

    Every point (and every KKT re-admission round) runs through the
    batched engine (``_solve_batched``) with B = 1 or B = ``lam_batch``
    rows: the regularization weight, warm start and freeze mask are
    arguments of one program per shape signature.

    Parameters
    ----------
    problem       : template instance; its ``g_weight`` is overridden per
                    grid point.
    lambdas       : explicit decreasing grid, or ``None`` for a geometric
                    ``n_points`` × ``lam_min_ratio`` grid from λ_max.
    warm          : warm-start each point from the previous solution
                    (``False`` = cold: every point starts at zero).
    screen        : sequential strong rule + KKT recheck (needs a
                    screenable family; exactness is restored by the
                    recheck, so final solutions are identical to
                    unscreened solves up to solver tolerance).
    lam_batch     : > 1 solves the grid in consecutive chunks of this many
                    λ-points through ONE ``_solve_batched`` call per
                    chunk (all points of a chunk warm-start and screen
                    against the chunk's anchor — the last solved point
                    before it), trading warm-start freshness for device
                    parallelism.  ``lam_batch = P`` with ``warm=False,
                    screen=False`` is exactly the *cold batched grid*:
                    the whole path as one wave.

    tol_schedule  : optional per-point stopping tolerances (length-P
                    array-like aligned with the resolved grid) — the
                    coarse-to-fine continuation knob for CV sweeps: run
                    the whole grid at a loose tol, then re-solve only
                    the selected λ at full accuracy.  ``None``
                    keeps ``cfg.tol`` everywhere.  Points sharing a
                    ``lam_batch`` chunk run at the *tightest* tolerance
                    in the chunk (never looser than asked).

    clock         : zero-arg float callable used for ``meta["wall_s"]``
                    (default ``time.perf_counter``) — inject a virtual
                    clock for reproducible path wall-times.

    compact       : pack each KKT round's active set into its capacity
                    bucket (needs ``screen=True``).

    Randomized selection rules draw from one generator per batch, so
    their trajectories differ from a solo ``solve()`` of the same point
    (deterministic rules — the default greedy — agree).
    """
    cfg = cfg or SolverConfig()
    clock = clock if clock is not None else time.perf_counter
    family = infer_family(problem)
    fam = get_family(family)
    if screen and not fam.screenable:
        raise ValueError(
            f"family {family!r} has no screening hook; call with "
            "screen=False or register ProblemFamily.screen_scores")
    if lam_batch < 1:
        raise ValueError("lam_batch must be >= 1")
    if compact and not screen:
        raise ValueError(
            "compact=True packs the *certified* active set — it needs "
            "screen=True (without screening there is no support to "
            "compact)")

    grid, lam_max = _resolve_grid(problem, lambdas, n_points,
                                  lam_min_ratio)
    n, bs = problem.n, problem.block_size
    n_blocks = problem.n_blocks
    P = grid.shape[0]
    tols = _resolve_tol_schedule(tol_schedule, cfg, P)

    # Compacted solves run on a narrower problem whose *default* τ would
    # differ (tr(AᵀA)/2n over the packed columns only).  Pin the dense
    # default as an explicit tau0 so every capacity bucket iterates with
    # bit-identical per-coordinate τ — and padded zero columns (col_sq
    # = 0) keep the surrogate curvature d ≥ τ > 0.
    tau0_pin = float(cfg.tau0)
    if compact and cfg.tau0 <= 0:
        arrays = [problem.data[key] for key in fam.data_keys]
        tau0_pin = float(tau0_from_colsq(
            fam.half_curv(fam.col_sq(*arrays)), n))

    xs = np.zeros((P, n), np.float32)
    V = np.zeros(P); iters = np.zeros(P, np.int64)
    conv = np.zeros(P, bool)
    active_ct = np.zeros(P, np.int64)
    screened: list[ScreenReport] = []
    row_iters = 0
    device_flops = 0
    program_widths: set[int] = set()
    signatures: set = set()     # (program width, cfg) pairs the path ran

    # The certified anchor: x(λ_max) = 0 exactly (definition of λ_max).
    c_prev = lam_max
    x_prev = np.zeros(n, np.float32)
    scores_prev = (block_scores(fam, _problem_at(problem, lam_max),
                                x_prev) if screen else None)

    t0 = clock()
    k = 0
    while k < P:
        # Trivial points: every c ≥ λ_max has the exact solution 0.
        if grid[k] >= lam_max * (1.0 - 1e-12):
            ck = float(grid[k])
            pk = _problem_at(problem, ck)
            xs[k] = 0.0
            V[k] = float(pk.v(torch.zeros(n, dtype=torch.float32,
                                          device=problem.device)))
            conv[k] = True
            active_ct[k] = n_blocks
            screened.append(ScreenReport(n_blocks=n_blocks,
                                         screened_out=0))
            c_prev, x_prev = ck, xs[k]
            # scores at 0 are λ-independent for these families (x = 0),
            # so scores_prev stays valid.
            k += 1
            continue

        chunk = list(range(k, min(k + lam_batch, P)))
        # Chunk-mates share one batched solve, so they run at the
        # tightest tolerance in the chunk (never looser than asked).
        cfg_k = _cfg_at_tol(cfg, float(tols[chunk].min()))
        with obs.span("path.point", cat="path", k=k,
                      lam=float(grid[k]), chunk=len(chunk)):
            out = _solve_chunk(problem, fam, grid[chunk], c_prev,
                               x_prev, scores_prev, cfg_k, warm=warm,
                               screen=screen, kkt_slack=kkt_slack,
                               compact=compact, tau0_pin=tau0_pin)
        for j, kk in enumerate(chunk):
            xs[kk] = out["x"][j]
            V[kk] = out["V"][j]
            iters[kk] = out["iters"][j]
            conv[kk] = out["converged"][j]
            active_ct[kk] = out["active_blocks"][j]
            screened.append(out["reports"][j])
        row_iters += out["row_iters"]
        device_flops += out["device_flops"]
        program_widths |= out["program_widths"]
        signatures |= {(w, cfg_k) for w in out["program_widths"]}
        c_prev = float(grid[chunk[-1]])
        x_prev = xs[chunk[-1]]
        scores_prev = out["scores_last"]
        k = chunk[-1] + 1

    support = np.array([
        int(np.count_nonzero(
            np.linalg.norm(xs[p].reshape(n_blocks, bs), axis=-1)))
        for p in range(P)], np.int64)
    # Unified accounting: the lockstep batch runs every chunk row until
    # the slowest stops, so row − live is freeze waste (no padding rows
    # on the path — every row is a real λ-point).
    live = int(iters.sum())
    led = CostLedger(row_iters=int(row_iters), live_iters=live,
                     device_flops=int(device_flops),
                     freeze_iters=int(row_iters) - live,
                     compiles=len(signatures))
    return PathResult(
        lambdas=grid, x=xs, V=V, iters=iters, converged=conv,
        support=support, active_blocks=active_ct, screened=screened,
        row_iters=int(row_iters), device_flops=int(device_flops),
        lam_max=lam_max,
        meta={"family": family, "warm": warm, "screen": screen,
              "lam_batch": lam_batch, "compact": compact,
              "program_widths": sorted(program_widths),
              "tol_schedule": (None if tol_schedule is None
                               else [float(t) for t in tols]),
              "wall_s": clock() - t0},
        ledger=led)


def _resolve_tol_schedule(tol_schedule, cfg: SolverConfig,
                          P: int) -> np.ndarray:
    """Per-point stopping tolerances (``cfg.tol`` where unspecified)."""
    if tol_schedule is None:
        return np.full(P, float(cfg.tol))
    tols = np.asarray(tol_schedule, np.float64).ravel()
    if tols.shape != (P,):
        raise ValueError(
            f"tol_schedule must align with the λ-grid: expected shape "
            f"({P},), got {tols.shape}")
    return tols


def _cfg_at_tol(cfg: SolverConfig, tol: float) -> SolverConfig:
    """``cfg`` with ``tol`` overridden (identity when unchanged)."""
    return cfg if tol == cfg.tol else dataclasses.replace(cfg, tol=tol)


def _screen_mask(fam, scores_prev, c_new, c_prev, x_warm, n_blocks, bs,
                 screen: bool) -> np.ndarray:
    if not screen:
        return np.ones(n_blocks, np.float64)
    warm_norms = np.linalg.norm(
        np.asarray(x_warm, np.float64).reshape(n_blocks, bs), axis=-1)
    return strong_rule_active(scores_prev, c_new, c_prev,
                              warm_block_norms=warm_norms)


def _kkt_round(fam, probs, cs, x_hat, active, rounds, violations,
               kkt_slack):
    """One KKT recheck round over a batch of solved points.

    Computes the per-instance screening scores at the solutions, flags
    frozen violators, and applies the shared re-admission policy
    (re-admit violators; after :data:`MAX_KKT_ROUNDS` rounds fall back
    to the full active set).  Mutates ``active``/``rounds``/
    ``violations`` in place and returns ``(scores, done)`` — ``done``
    True when no instance violates and the chunk may be accepted.  The
    single definition all KKT loops share (sequential, lockstep; the
    serve engine's event-driven variant mirrors it via the same
    screening primitives and round cap).
    """
    B = len(probs)
    scores = np.stack([block_scores(fam, probs[i], x_hat[i])
                       for i in range(B)])
    viol = np.stack([
        kkt_violations(scores[i], active[i], float(cs[i]),
                       slack=kkt_slack) for i in range(B)])
    n_viol = viol.sum(axis=1).astype(int)
    if not n_viol.any():
        return scores, True
    rounds[n_viol > 0] += 1
    violations += n_viol
    np.maximum(active, viol, out=active)
    active[rounds >= MAX_KKT_ROUNDS] = 1.0
    return scores, False


def _compact_round(probs, fam, plan, x0_masked, mask_c, cfg,
                   tau0_pin: float):
    """One screened solve over the *packed* active columns.

    The chunk's design columns gather once through the plan (shared by
    every chunk-mate — only ``c`` varies), warm starts and per-instance
    freeze masks gather through the same permutation, and the narrow
    problem runs through the ordinary batched engine — one program
    signature (``BatchedProblemSpec``) per capacity bucket however many
    supports the path visits.  Solutions
    scatter back to the full layout for the (full-width) KKT recheck.
    """
    B = len(probs)
    template = probs[0]
    dev = template.device
    arrays = [template.data[key] for key in fam.data_keys]
    arrays_c = (plan.pack_columns(arrays[0]),) + tuple(arrays[1:])
    cprobs = [build_problem(fam.name, arrays_c, float(p.g_weight),
                            n=plan.n_compact,
                            block_size=plan.block_size,
                            g_kind=template.g_kind) for p in probs]
    x0_t = torch.as_tensor(x0_masked).to(dev)
    mask_t = torch.as_tensor(mask_c).to(dev)
    x0_c = torch.stack([plan.pack_vector(x0_t[i]) for i in range(B)])
    mask_cc = torch.stack([plan.pack_mask(mask_t[i]) for i in range(B)])
    # τ pinned to the dense default (see _solve_path): identical
    # per-coordinate τ whatever the bucket, positive d on pad columns.
    cfg_c = (cfg if cfg.tau0 > 0
             else dataclasses.replace(cfg, tau0=tau0_pin))
    r = _solve_batched(cprobs, x0=x0_c, cfg=cfg_c, active=mask_cc)
    x_hat = torch.stack([plan.unpack_vector(r.x[i])
                         for i in range(B)]).cpu().numpy()
    return r, x_hat


def _solve_chunk(problem, fam, cs, c_prev, x_prev, scores_prev, cfg, *,
                 warm, screen, kkt_slack, compact: bool = False,
                 tau0_pin: float = 0.0) -> dict:
    """A chunk of λ-points solved as ONE batched program (B = len(cs);
    B = 1 is the plain sequential-homotopy step).

    All points screen/warm-start against the chunk anchor (c_prev,
    x_prev) — the sequential strong rule remains valid for every point
    because each cᵢ < c_prev; the bound is just looser for the far end of
    the chunk than point-by-point referencing would give.

    With ``compact=True`` each KKT round repacks the chunk's *union*
    active set into its capacity bucket (``repro_torch.solvers.compaction``)
    and solves the narrow subproblem; a bucket at the full width falls
    back to the plain masked-dense program (nothing to skip).  KKT
    re-admission can bump the bucket, which simply repacks the next
    round — the per-λ repack the homotopy needs when the certified
    support drops a bucket comes for free from re-planning every round.
    """
    n, bs, n_blocks = problem.n, problem.block_size, problem.n_blocks
    m = int(problem.data[fam.data_keys[0]].shape[0])
    B = len(cs)
    probs = [_problem_at(problem, float(c)) for c in cs]
    active = np.stack([
        _screen_mask(fam, scores_prev, float(c), c_prev, x_prev,
                     n_blocks, bs, screen) for c in cs])
    screened_out0 = (n_blocks - active.sum(axis=1)).astype(int)
    x_warm = (np.asarray(x_prev, np.float32) if warm
              else np.zeros(n, np.float32))
    x0 = np.broadcast_to(x_warm, (B, n)).copy()
    total_iters = np.zeros(B, np.int64)
    rounds = np.zeros(B, np.int64)
    violations = np.zeros(B, np.int64)
    row_iters = 0
    device_flops = 0
    program_widths: set[int] = set()
    round_no = 0
    while True:
        mask_c = np.stack([expand_blocks(active[i], bs)
                           for i in range(B)])
        plan = (make_plan(active.max(axis=0) > 0, bs)
                if compact else None)
        with obs.span("path.kkt_round", cat="path", round=round_no, B=B):
            if plan is not None and not plan.dense:
                obs.instant("path.repack", cat="path",
                            width=plan.n_compact, round=round_no)
                r, x_hat = _compact_round(probs, fam, plan, x0 * mask_c,
                                          mask_c, cfg, tau0_pin)
                n_prog = plan.n_compact
            else:
                r = _solve_batched(probs, x0=x0 * mask_c, cfg=cfg,
                                   active=mask_c if screen else None)
                x_hat = r.x.cpu().numpy()
                n_prog = n
        round_no += 1
        it = np.asarray(r.iters, np.int64)
        total_iters += it
        # The batched while_loop runs every row until the slowest one
        # stops — that is what the device executed.  FLOPs are the same
        # count priced at the program width the rows actually ran at
        # (matvec-dominated: ∝ m × n_prog per row-iteration).
        row_iters += int(it.max()) * B
        device_flops += int(it.max()) * B * m * n_prog
        program_widths.add(n_prog)
        if not screen:
            scores = None
            break
        scores, done = _kkt_round(fam, probs, cs, x_hat, active, rounds,
                                  violations, kkt_slack)
        if done:
            break
        x0 = x_hat
    return {
        "x": list(x_hat),
        "V": [float(probs[i].v(torch.as_tensor(x_hat[i]).to(
            problem.device))) for i in range(B)],
        "iters": list(total_iters),
        "converged": list(np.asarray(r.converged, bool)),
        "active_blocks": [int(a.sum()) for a in active],
        "reports": [ScreenReport(n_blocks=n_blocks,
                                 screened_out=int(screened_out0[i]),
                                 kkt_rounds=int(rounds[i]),
                                 violations=int(violations[i]))
                    for i in range(B)],
        "row_iters": row_iters,
        "device_flops": device_flops,
        "program_widths": program_widths,
        "scores_last": None if scores is None else scores[-1],
    }


def _solve_path_batched(problems, lambdas=None, *, n_points: int = 20,
                        lam_min_ratio: float = 0.01,
                        cfg: SolverConfig | None = None,
                        warm: bool = True, screen: bool = True,
                        kkt_slack: float = DEFAULT_KKT_SLACK,
                        tol_schedule=None, clock=None) -> list[PathResult]:
    """Sweep ONE λ-grid over B same-signature instances in lockstep.

    The cross-validation workhorse: each fold is one instance; every grid
    point is one ``_solve_batched`` call over all folds (per-fold warm
    start and screening mask).  The shared grid is derived from the
    *largest* per-instance λ_max, so every fold's path starts at a
    certified zero solution.  Returns one :class:`PathResult` per
    instance; ``row_iters`` (whole-sweep device total) is recorded on
    each result's ``meta["sweep_row_iters"]`` as well as split per point.
    """
    if not problems:
        raise ValueError("need at least one instance")
    cfg = cfg or SolverConfig()
    clock = clock if clock is not None else time.perf_counter
    family = infer_family(problems[0])
    fam = get_family(family)
    if screen and not fam.screenable:
        raise ValueError(f"family {family!r} has no screening hook")
    B = len(problems)
    n, bs = problems[0].n, problems[0].block_size
    n_blocks = problems[0].n_blocks

    lam_maxes = [lambda_max(p) for p in problems]
    lam_max = max(lam_maxes)
    if lambdas is None:
        grid = geometric_grid(lam_max, n_points=n_points,
                              lam_min_ratio=lam_min_ratio)
    else:
        grid = validate_grid(lambdas)
    P = grid.shape[0]
    tols = _resolve_tol_schedule(tol_schedule, cfg, P)

    xs = np.zeros((B, P, n), np.float32)
    V = np.zeros((B, P)); iters = np.zeros((B, P), np.int64)
    conv = np.zeros((B, P), bool)
    active_ct = np.zeros((B, P), np.int64)
    reports: list[list[ScreenReport]] = [[] for _ in range(B)]
    sweep_row_iters = 0
    sweep_flops = 0
    m = int(problems[0].data[fam.data_keys[0]].shape[0])
    per_point_rows = np.zeros(P, np.int64)
    signatures: set = set()     # solver configs the sweep ran

    c_prev = lam_max
    x_prev = np.zeros((B, n), np.float32)
    scores_prev = (np.stack([
        block_scores(fam, _problem_at(problems[i], lam_max), x_prev[i])
        for i in range(B)]) if screen else None)

    t0 = clock()
    for k in range(P):
        ck = float(grid[k])
        cfg_k = _cfg_at_tol(cfg, float(tols[k]))
        signatures.add(cfg_k)
        probs_k = [_problem_at(problems[i], ck) for i in range(B)]
        # A fold whose own λ_max is below ck has the certified solution 0;
        # its mask is emptied below (the solver confirms it in a handful
        # of iterations from x0 = 0 rather than being mis-certified).
        trivial = np.array([ck >= lam_maxes[i] * (1.0 - 1e-12)
                            for i in range(B)])
        active = np.stack([
            np.ones(n_blocks, np.float64) if not screen else
            _screen_mask(fam, scores_prev[i], ck, c_prev, x_prev[i],
                         n_blocks, bs, screen)
            if not trivial[i] else np.zeros(n_blocks, np.float64)
            for i in range(B)])
        # A fully-screened instance (trivial point) still needs a
        # nonempty mask for the solver to terminate on: give it one block
        # — it converges immediately at x = 0.
        empty = active.sum(axis=1) == 0
        active[empty, 0] = 1.0
        screened_out0 = (n_blocks - active.sum(axis=1)).astype(int)

        x0 = (x_prev if warm else np.zeros((B, n), np.float32)).copy()
        total_iters = np.zeros(B, np.int64)
        rounds = np.zeros(B, np.int64)
        violations = np.zeros(B, np.int64)
        round_no = 0
        while True:
            mask_c = np.stack([expand_blocks(active[i], bs)
                               for i in range(B)])
            with obs.span("path.kkt_round", cat="path", k=k,
                          round=round_no, B=B):
                r = _solve_batched(probs_k, x0=x0 * mask_c, cfg=cfg_k,
                                   active=mask_c if screen else None)
            round_no += 1
            it = np.asarray(r.iters, np.int64)
            total_iters += it
            sweep_row_iters += int(it.max()) * B
            sweep_flops += int(it.max()) * B * m * n
            per_point_rows[k] += int(it.max()) * B
            x_hat = r.x.cpu().numpy()
            if not screen:
                scores = None
                break
            scores, done = _kkt_round(fam, probs_k, [ck] * B, x_hat,
                                      active, rounds, violations,
                                      kkt_slack)
            if done:
                break
            x0 = x_hat

        xs[:, k] = x_hat
        iters[:, k] = total_iters
        conv[:, k] = np.asarray(r.converged, bool)
        active_ct[:, k] = active.sum(axis=1).astype(int)
        for i in range(B):
            V[i, k] = float(probs_k[i].v(torch.as_tensor(x_hat[i]).to(
                problems[i].device)))
            reports[i].append(ScreenReport(
                n_blocks=n_blocks, screened_out=int(screened_out0[i]),
                kkt_rounds=int(rounds[i]),
                violations=int(violations[i])))
        c_prev = ck
        x_prev = x_hat
        scores_prev = scores

    wall = clock() - t0
    # One sweep-wide ledger (the device work is shared by all folds in
    # lockstep); each result carries a copy so any single fold can be
    # inspected standalone without double counting inside one result.
    sweep_live = int(iters.sum())
    sweep_led = CostLedger(
        row_iters=int(sweep_row_iters), live_iters=sweep_live,
        device_flops=int(sweep_flops),
        freeze_iters=int(sweep_row_iters) - sweep_live,
        compiles=len(signatures))
    results = []
    for i in range(B):
        supp = np.array([
            int(np.count_nonzero(np.linalg.norm(
                xs[i, p].reshape(n_blocks, bs), axis=-1)))
            for p in range(P)], np.int64)
        results.append(PathResult(
            lambdas=grid, x=xs[i], V=V[i], iters=iters[i],
            converged=conv[i], support=supp, active_blocks=active_ct[i],
            screened=reports[i],
            row_iters=int(per_point_rows.sum()),
            device_flops=int(sweep_flops),
            lam_max=lam_maxes[i],
            meta={"family": family, "warm": warm, "screen": screen,
                  "instances": B, "instance": i,
                  "sweep_row_iters": int(sweep_row_iters),
                  "tol_schedule": (None if tol_schedule is None
                                   else [float(t) for t in tols]),
                  "wall_s": wall},
            ledger=sweep_led.copy()))
    return results
