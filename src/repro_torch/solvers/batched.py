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

Besides the run-to-convergence driver, this module holds the resumable
*slab core* the continuous-batching runtime (``repro_torch.serve.
continuous``) schedules over: :func:`slab_alloc` packs a fixed-capacity
stack of instance buffers (:class:`SlabState`), :func:`write_slots`
splices admitted requests into their rows in place, and
:func:`make_chunk_stepper` advances every live slot by K iterations with
the same freeze-on-convergence merge as :func:`make_batched_solver`, so
a slot's trajectory is its solo run's whichever driver runs it.  Each
slot's randomized-selection stream is its own generator, seeded by
:func:`request_seed` from ``(cfg.seed, request id)``: a request's
trajectory depends neither on its slot nor on its neighbours.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.config.base import SolverConfig
from repro_torch.core import flexa as _flexa
from repro_torch.core import selection
from repro_torch.core.flexa import FlexaState, flexa_iteration
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.obs.health import (STATUS_DIVERGED, STATUS_RUNNING,
                                    STATUS_STALLED, STATUS_STOPPED,
                                    HealthConfig)
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


# ===================================================================== #
# Resumable slab core (continuous batching)                             #
# ===================================================================== #
def request_seed(seed: int, req_id: int) -> int:
    """The seed of request ``req_id``'s selection generator: 63 bits of
    ``numpy.random.SeedSequence((seed, req_id))``, a pure function of the
    engine's ``cfg.seed`` and the request id (never of a slot)."""
    state = np.random.SeedSequence((int(seed), int(req_id))).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))


def request_generator(cfg: SolverConfig, req_id: int, device):
    """Request ``req_id``'s own selection generator (None for rules that
    draw nothing)."""
    if cfg.jacobi or not selection.needs_generator(cfg.selection):
        return None
    return torch.Generator(device=device).manual_seed(
        request_seed(cfg.seed, req_id))


class SlabState(NamedTuple):
    """Device buffers of one fixed-capacity slot slab (leading dim S):
    the per-slot family data, weights, column norms, base τ, the stacked
    :class:`FlexaState` (``gen`` a list of S per-slot generators, or
    None), the per-slot freeze mask and stopping tolerance."""
    data: tuple                 # family arrays, each (S, ...)
    c: torch.Tensor             # (S,)
    col_sq: torch.Tensor        # (S, n)
    tau_base: torch.Tensor      # (S, n)
    state: FlexaState           # stacked, leading dim S
    active: torch.Tensor        # (S, n) per-slot freeze mask (1 = live)
    tol: torch.Tensor           # (S,) per-slot stopping tolerance

    @property
    def capacity(self) -> int:
        return int(self.c.shape[0])


class SlotAdmission(NamedTuple):
    """Requests to splice into slab rows, one entry per row: ``data[i]``
    the family arrays (host arrays or tensors, ``data_keys`` order),
    ``x0[i]`` and ``active[i]`` an (n,) array or None."""
    slots: tuple
    data: tuple
    c: tuple
    x0: tuple
    req_ids: tuple
    active: tuple
    tol: tuple


def slab_data_shapes(spec: BatchedProblemSpec) -> tuple:
    """Per-instance shapes of the family data arrays, in ``data_keys``
    order: the leading key is the (m, n) design/feature matrix, ``b`` the
    (m,) observation vector."""
    shapes = []
    for j, key in enumerate(get_family(spec.family).data_keys):
        if j == 0:
            shapes.append((spec.m, spec.n))
        elif key == "b":
            shapes.append((spec.m,))
        else:
            raise NotImplementedError(
                f"no slab layout for data key {key!r} of family "
                f"{spec.family!r}")
    return tuple(shapes)


def slab_alloc(spec: BatchedProblemSpec, cfg: SolverConfig, capacity: int,
               device=DEFAULT_DEVICE) -> SlabState:
    """A slab of ``capacity`` empty slots on ``device``.

    Empty slots hold placeholders (zero data, unit column norms and τ,
    ``c`` = 1) that run through the iteration and stay finite; their
    ``stat`` starts at +inf, so they never read as converged.  Every
    slot's tolerance starts at ``cfg.tol``.
    """
    S, n = int(capacity), spec.n
    dev = resolve_device(device)
    f32 = torch.float32
    data = tuple(torch.zeros((S,) + shp, dtype=f32, device=dev)
                 for shp in slab_data_shapes(spec))
    c = torch.ones((S,), dtype=f32, device=dev)
    col_sq = torch.ones((S, n), dtype=f32, device=dev)
    state = _flexa.init_state(
        family_problem(data, c.unsqueeze(-1), spec, col_sq=col_sq),
        torch.zeros((S, n), dtype=f32, device=dev), cfg)
    if state.gen is not None:               # one idle stream for all
        state = state._replace(gen=[state.gen] * S)
    return SlabState(data=data, c=c, col_sq=col_sq,
                     tau_base=torch.ones((S, n), dtype=f32, device=dev),
                     state=state,
                     active=torch.ones((S, n), dtype=f32, device=dev),
                     tol=torch.full((S,), cfg.tol, dtype=f32, device=dev))


def _rows(rows, dev) -> torch.Tensor:
    """Stack per-row vectors as an fp32 tensor on ``dev``."""
    return torch.stack([torch.as_tensor(np.asarray(r, np.float32))
                        for r in rows]).to(dev)


def write_slots(slab: SlabState, spec: BatchedProblemSpec,
                cfg: SolverConfig, adm: SlotAdmission) -> SlabState:
    """Splice the admitted requests into their slots (the slot writer).

    Each admitted row's data is copied straight into its slab row (only
    the admitted rows cross to the device); its column norms, base τ and
    iteration-0 state are computed from its own solo problem, exactly as
    a solo solve computes them; its generator is its request's own.  The
    (S, m, n) data are written in place; the small per-slot buffers are
    rebuilt.
    """
    dev = slab.c.device
    fam = get_family(spec.family)
    idx = torch.as_tensor(list(adm.slots), dtype=torch.long, device=dev)
    csq, tb, inits = [], [], []
    for slot, arrays, c, x0, rid in zip(adm.slots, adm.data, adm.c, adm.x0,
                                        adm.req_ids):
        row = []
        for buf, a in zip(slab.data, arrays):
            if not isinstance(a, torch.Tensor):   # (a read-only array
                a = torch.from_numpy(                # is copied first)
                    np.require(a, np.float32, ["C", "W"]))
            buf[slot].copy_(a)
            row.append(buf[slot])
        cs = fam.col_sq(*row)
        csq.append(cs)
        tb.append(_tau_base(fam.half_curv(cs), cfg, spec.n))
        solo = build_problem(spec.family, row, float(c), n=spec.n,
                             block_size=spec.block_size,
                             g_kind=spec.g_kind, col_sq=cs)
        x0 = (torch.zeros((spec.n,), dtype=torch.float32, device=dev)
              if x0 is None
              else torch.as_tensor(np.asarray(x0, np.float32)).to(dev))
        inits.append(_flexa.init_state(
            solo, x0, cfg, gen=request_generator(cfg, rid, dev)))
    gens = slab.state.gen
    if gens is not None:
        gens = list(gens)
        for slot, init in zip(adm.slots, inits):
            gens[slot] = init.gen

    def put(dst, rows):
        return dst.index_copy(0, idx, torch.stack(rows).to(dst.dtype))

    state = FlexaState(*(put(f, [getattr(s, name) for s in inits])
                         for name, f in zip(FlexaState._fields[:-1],
                                            slab.state[:-1])), gen=gens)
    active = [np.ones(spec.n, np.float32) if a is None else a
              for a in adm.active]
    return slab._replace(
        c=slab.c.index_copy(0, idx, torch.as_tensor(
            list(adm.c), dtype=torch.float32, device=dev)),
        col_sq=put(slab.col_sq, csq), tau_base=put(slab.tau_base, tb),
        state=state,
        active=slab.active.index_copy(0, idx, _rows(active, dev)),
        tol=slab.tol.index_copy(0, idx, torch.as_tensor(
            list(adm.tol), dtype=torch.float32, device=dev)))


def make_chunk_stepper(spec: BatchedProblemSpec, cfg: SolverConfig,
                       chunk_iters: int,
                       health: HealthConfig | None = None):
    """One scheduler tick on one slab:

        chunk(slab, stop, admission=None, *, masked=False)
            -> (slab, stop)
        chunk(slab, stop, admission, *, masked, health_carry=(prev, stall))
            -> (slab, status, prev_stat, stall)         # watchdog on

    ``stop`` is the (S,) bool device mask of slots not to advance (empty
    or finished).  Phase 1 splices ``admission`` (:func:`write_slots`)
    and clears those slots' stop bits.  Phase 2 runs ``chunk_iters``
    iterations on every slot with the wave driver's freeze merge: a slot
    flips its own stop bit the moment its stat reaches its own tolerance
    (``slab.tol``) or it exhausts ``max_iters``, and is frozen from the
    next iteration on, so its answer is independent of the chunk size.
    Nothing in the K iterations reads a value back to the host.

    ``chunk.splice_s`` holds the host wall of the last call's splice
    (the admitted rows' host → device copies and iteration-0 states; 0
    when nothing was admitted).

    ``masked`` says whether any live slot carries a freeze mask: without
    one the iteration runs with ``active=None``, the same numbers as an
    all-ones mask, which lets the full rule take the fused S.4 kernel.

    With ``health`` (a :class:`~repro_torch.obs.health.HealthConfig`)
    the tick also takes and returns the device-resident per-slot carry
    ``(prev_stat, stall)`` — the last chunk-end stat and the count of
    consecutive chunks without a decrease, reset on admitted rows — and
    returns an int32 status vector (RUNNING / STOPPED / DIVERGED /
    STALLED) in place of the stop mask.  The health pass runs after the
    iterations and only reads their outputs.
    """
    K = int(chunk_iters)

    def advance(slab: SlabState, stop, masked: bool):
        problem = family_problem(slab.data, slab.c.unsqueeze(-1), spec,
                                 col_sq=slab.col_sq)
        active = slab.active if masked else None
        state = slab.state
        for _ in range(K):
            new = flexa_iteration(problem, cfg, slab.tau_base, state,
                                  active=active)[0]
            state = _flexa.freeze_done(stop, new, state)
            stop = stop | (state.stat <= slab.tol) \
                | (state.k >= cfg.max_iters)
        return slab._replace(state=state), stop

    def admit(slab, stop, admission):
        step.splice_s = 0.0
        if admission is None or not admission.slots:
            return slab, stop, None
        t0 = time.perf_counter()
        slab = write_slots(slab, spec, cfg, admission)
        step.splice_s = time.perf_counter() - t0
        idx = torch.as_tensor(list(admission.slots), dtype=torch.long,
                              device=stop.device)
        return slab, stop.index_fill(0, idx, False), idx

    def chunk(slab, stop, admission=None, *, masked=False):
        slab, stop, _ = admit(slab, stop, admission)
        return advance(slab, stop, masked)

    H = 0 if health is None else int(health.stall_window)

    def chunk_health(slab, stop, admission=None, *, masked=False,
                     health_carry=None):
        prev_stat, stall = health_carry
        ran = ~stop
        slab, stop, idx = admit(slab, stop, admission)
        if idx is not None:
            ran = ran.index_fill(0, idx, True)
            prev_stat = prev_stat.index_fill(0, idx, float("inf"))
            stall = stall.index_fill(0, idx, 0)
        slab, stop_out = advance(slab, stop, masked)
        st = slab.state
        stat = st.stat
        finite = (torch.isfinite(st.x).all(-1) & torch.isfinite(st.v_prev)
                  & torch.isfinite(stat))
        diverged = ran & ~finite
        # +1 each chunk the stat fails to strictly decrease; reset on a
        # decrease or a normal stop.  The first chunk after admission
        # compares against +inf, so quarantine lands at chunk H+1 at the
        # earliest.
        decreased = stat < prev_stat
        stall = torch.where(stop_out | decreased, torch.zeros_like(stall),
                            stall + 1)
        stalled = ran & ~stop_out & ~diverged & (stall >= H)
        status = torch.where(stop_out, STATUS_STOPPED, STATUS_RUNNING)
        status = torch.where(stalled, STATUS_STALLED, status)
        status = torch.where(diverged, STATUS_DIVERGED,
                             status).to(torch.int32)
        return slab, status, stat, stall

    step = chunk if health is None else chunk_health
    step.splice_s = 0.0
    return step


def read_slots(state: FlexaState, slots) -> list[FlexaState]:
    """Single-instance states of the given slots, on the host (the
    generator of each row rides along)."""
    idx = torch.as_tensor(list(slots), dtype=torch.long,
                          device=state.x.device)
    rows = [f.index_select(0, idx).cpu() for f in state[:-1]]
    return [FlexaState(*(r[i] for r in rows),
                       gen=None if state.gen is None else state.gen[s])
            for i, s in enumerate(slots)]


def slab_migrate(slab: SlabState, slots, spec: BatchedProblemSpec,
                 cfg: SolverConfig, capacity: int) -> SlabState:
    """Repack the given live slots into a fresh slab of ``capacity``.

    ``slots[i]``'s whole row — data, weights, norms, the mid-flight
    :class:`FlexaState` and its generator — lands bitwise in slot ``i``
    of the new slab; the rest are :func:`slab_alloc` placeholders.  The
    port runs the same eager iteration at every capacity, so a migrated
    request keeps its trajectory bit for bit.  Works both ways: shrink
    at the drain tail, grow back for new arrivals.
    """
    capacity = int(capacity)
    k = len(slots)
    if k > capacity:
        raise ValueError(
            f"cannot migrate {k} live slots into capacity {capacity}")
    fresh = slab_alloc(spec, cfg, capacity, slab.c.device)
    if k == 0:
        return fresh
    slots = [int(s) for s in slots]
    sel = torch.as_tensor(slots, dtype=torch.long, device=slab.c.device)

    def move(dst, src):
        dst[:k] = src.index_select(0, sel)
        return dst

    for dst, src in zip(fresh.data, slab.data):   # row by row, in place
        for i, s in enumerate(slots):
            dst[i].copy_(src[s])
    gens = fresh.state.gen
    if gens is not None:
        gens = [slab.state.gen[s] for s in slots] + list(gens[k:])
    return SlabState(
        data=fresh.data, c=move(fresh.c, slab.c),
        col_sq=move(fresh.col_sq, slab.col_sq),
        tau_base=move(fresh.tau_base, slab.tau_base),
        state=FlexaState(*(move(d, s) for d, s in zip(fresh.state[:-1],
                                                        slab.state[:-1])),
                         gen=gens),
        active=move(fresh.active, slab.active),
        tol=move(fresh.tol, slab.tol))


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
