"""Continuous-batching solver runtime: slot slabs + admission scheduling
(a port of ``repro.serve.continuous``).

The wave engine (``repro_torch.serve.engine.SolverServeEngine``) holds a
whole padded bucket until its slowest instance converges.  This runtime
applies the paper's "virtually all possibilities in between" to the
serving schedule instead:

* a **slot slab** per (family × shape) signature
  (:class:`repro_torch.solvers.batched.SlabState`) holds a fixed-capacity
  stack of live instances on the device;
* a **chunk step** (:func:`repro_torch.solvers.batched.
  make_chunk_stepper`) advances every live slot by K FLEXA iterations; a
  slot that converges mid-chunk freezes exactly as in the wave driver, so
  its answer is independent of K and equal to its solo solve;
* after each chunk the host reads ONE (S,) stop (or, with the watchdog,
  status) vector, **evicts** the finished slots — reading back their x, k
  and stat — and **backfills** them from an **admission queue** ordered
  FIFO, by priority or by earliest deadline.  Admissions are staged on
  the host and spliced at the start of the next tick: only the admitted
  rows are copied onto the device, each straight into its slab row.

Staging: every tick's admissions are built from the requests' own arrays
(:class:`~repro_torch.solvers.batched.SlotAdmission`), never from a
host buffer that a later tick rewrites, and each row is copied into the
slab before the tick returns — no device copy can read a buffer the host
mutates afterwards.

Per-request generators: each slot's randomized-selection stream is its
own ``torch.Generator`` seeded by ``request_seed(cfg.seed, req_id)``, so
a request's trajectory depends neither on its slot, its neighbours, K
nor its admission tick.  That makes the runtime deterministic under a
fixed seed and arrival trace.

Telemetry (latency percentiles, chunk throughput, slot occupancy,
padding waste, admission copies) flows into ``repro_torch.serve.metrics``.
"""
from __future__ import annotations

import heapq
import itertools
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config.base import ServeConfig, SolverConfig
from repro_torch.deprecation import warn_legacy
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.obs import trace as obs
from repro_torch.obs.health import (STATUS_LABELS, STATUS_RUNNING,
                                    HealthConfig, SolveFailure)
from repro_torch.serve.engine import (SolveRequest, SolveResponse,
                                      validate_request)
from repro_torch.serve.metrics import ServeTelemetry
from repro_torch.serve.pathstate import PathRequest, PathState
from repro_torch.solvers.batched import (BatchedProblemSpec, SlotAdmission,
                                         make_chunk_stepper, slab_alloc,
                                         slab_migrate)
from repro_torch.solvers.compaction import bucket_capacity


@dataclass
class QueueEntry:
    """One queued request plus the scheduling facts the policies read."""
    req_id: int
    request: SolveRequest
    arrival: float
    priority: int = 0
    deadline: float | None = None


class AdmissionQueue:
    """Policy-ordered admission: FIFO, priority, or earliest-deadline.

    All three are heaps with a monotonically increasing sequence number as
    the final tie-break, so the order is total and deterministic:

    * ``fifo``     — arrival order;
    * ``priority`` — higher ``SolveRequest.priority`` first (FIFO within
      a class);
    * ``deadline`` — earliest ``SolveRequest.deadline`` first; requests
      without one after every dated one, FIFO among themselves.
    """

    POLICIES = ("fifo", "priority", "deadline")

    def __init__(self, policy: str = "fifo"):
        if policy not in self.POLICIES:
            raise ValueError(
                f"unknown admission policy {policy!r}; pick from "
                f"{self.POLICIES}")
        self.policy = policy
        self._heap: list = []
        self._seq = itertools.count()

    def _key(self, e: QueueEntry) -> tuple:
        if self.policy == "priority":
            return (-e.priority, e.arrival)
        if self.policy == "deadline":
            return (math.inf if e.deadline is None else float(e.deadline),
                    e.arrival)
        return (e.arrival,)

    def push(self, entry: QueueEntry) -> None:
        heapq.heappush(self._heap,
                       (self._key(entry), next(self._seq), entry))

    def pop(self) -> QueueEntry:
        return heapq.heappop(self._heap)[-1]

    def remove_if(self, pred) -> list[QueueEntry]:
        """Remove every queued entry for which ``pred(entry)`` holds;
        returns them in policy order (an O(len) rebuild, used by the
        deadline sweep, never on the per-tick path)."""
        kept, removed = [], []
        for item in self._heap:
            (removed if pred(item[-1]) else kept).append(item)
        if removed:
            heapq.heapify(kept)
            self._heap = kept
        return [item[-1] for item in sorted(removed, key=lambda t: t[:2])]

    def __len__(self) -> int:
        return len(self._heap)


class _SlotSlab:
    """Host-side bookkeeping around one device slab (one signature).

    :meth:`backfill` stages admissions (host only); the next :meth:`step`
    splices them and runs the chunk: one device step and one (S,)
    readback per tick, however many requests were admitted or evicted.
    """

    def __init__(self, spec: BatchedProblemSpec, cfg: SolverConfig,
                 serve: ServeConfig, telemetry: ServeTelemetry, device,
                 resolve_x0=None, deadline_of=None):
        self.spec = spec
        self.cfg = cfg
        self.device = device
        self.capacity = int(serve.slab_capacity)
        self._base_capacity = self.capacity
        self._compact_drain = bool(serve.compact_drain)
        self.chunk_iters = int(serve.chunk_iters)
        self._health_cfg = HealthConfig.of(serve)
        self.telemetry = telemetry
        self.queue = AdmissionQueue(serve.policy)
        self.slab = slab_alloc(spec, cfg, self.capacity, device)
        self._health_carry = self._fresh_health(self.capacity)
        self._chunk = make_chunk_stepper(spec, cfg, self.chunk_iters,
                                         self._health_cfg)
        # warm_from resolver: req_id -> finished solution (None = still
        # in flight, defer admission); deadline resolver for the sweep.
        self._resolve_x0 = resolve_x0 or (lambda req_id: None)
        self._deadline_of = deadline_of or (lambda req_id: None)
        # Host mirrors: stop == "do not advance" (empty or finished slot).
        self.stop = np.ones(self.capacity, bool)
        self.active = np.zeros(self.capacity, bool)
        self.slot_req = np.full(self.capacity, -1, np.int64)
        # Per-slot tolerance: eviction's ``converged`` uses the slot's.
        self.slot_tol = np.full(self.capacity, cfg.tol, np.float32)
        # Whether the slot's request carries a freeze mask.
        self.slot_masked = np.zeros(self.capacity, bool)
        # Staged admissions of the next tick: slot -> (entry, x0, tol).
        self._staged: dict[int, tuple] = {}
        self._open_audit: dict = {}          # req_id -> its audit record

    def _fresh_health(self, capacity: int):
        """Device-resident health carry ``(prev_stat, stall)`` at rest
        (+inf previous stat, zero stall); None with the watchdog off."""
        if self._health_cfg is None:
            return None
        return (torch.full((capacity,), float("inf"), dtype=torch.float32,
                           device=self.device),
                torch.zeros((capacity,), dtype=torch.int32,
                            device=self.device))

    def _chunk_flops(self, capacity: int) -> int:
        """Matvec currency of one chunk: every slot (live or padding)
        advances ``chunk_iters`` rows at ``m × n``."""
        return self.chunk_iters * capacity * self.spec.m * self.spec.n

    # ------------------------------------------------------------- #
    # Drain-tail slab compaction (ServeConfig.compact_drain)
    # ------------------------------------------------------------- #
    def _resize(self, target: int, tick: int) -> None:
        """Migrate the live slots into a slab of capacity ``target``
        (bitwise row moves; the health carry moves with its slots).
        Callers resize only with nothing staged."""
        old = self.capacity
        live_slots = [int(s) for s in np.flatnonzero(self.active)]
        self.slab = slab_migrate(self.slab, live_slots, self.spec,
                                 self.cfg, target)
        if self._health_carry is not None:
            prev_stat, stall = self._health_carry
            fresh_ps, fresh_st = self._fresh_health(int(target))
            if live_slots:
                sel = torch.as_tensor(live_slots, dtype=torch.long,
                                      device=self.device)
                k = len(live_slots)
                fresh_ps[:k] = prev_stat.index_select(0, sel)
                fresh_st[:k] = stall.index_select(0, sel)
            self._health_carry = (fresh_ps, fresh_st)
        self.capacity = int(target)
        stop = np.ones(self.capacity, bool)
        active = np.zeros(self.capacity, bool)
        slot_req = np.full(self.capacity, -1, np.int64)
        slot_tol = np.full(self.capacity, self.cfg.tol, np.float32)
        slot_masked = np.zeros(self.capacity, bool)
        for new_slot, old_slot in enumerate(live_slots):
            stop[new_slot] = self.stop[old_slot]
            active[new_slot] = True
            slot_req[new_slot] = self.slot_req[old_slot]
            slot_tol[new_slot] = self.slot_tol[old_slot]
            slot_masked[new_slot] = self.slot_masked[old_slot]
            rec = self._open_audit.get(int(self.slot_req[old_slot]))
            if rec is not None:
                rec["slot"] = new_slot
                rec.setdefault("migrations", []).append(
                    {"tick": tick, "from_slot": old_slot,
                     "to_slot": new_slot, "from_capacity": old,
                     "to_capacity": self.capacity})
        self.stop, self.active, self.slot_req = stop, active, slot_req
        self.slot_tol, self.slot_masked = slot_tol, slot_masked
        self.telemetry.record_migration(from_capacity=old,
                                        to_capacity=self.capacity)
        obs.instant("serve.migrate", cat="continuous", tick=tick,
                    from_capacity=old, to_capacity=self.capacity,
                    live=len(live_slots))

    def _maybe_shrink(self, tick: int) -> None:
        """Shrink to the live count's capacity bucket at the drain tail:
        queue empty, nothing staged, and the stragglers fit a bucket at
        most half the current capacity."""
        if not self._compact_drain:
            return
        live = self.live
        if (live > 0 and self.capacity > 1 and len(self.queue) == 0
                and not self._staged):
            target = bucket_capacity(live, self._base_capacity)
            if target <= self.capacity // 2:
                self._resize(target, tick)

    def _maybe_grow(self, tick: int) -> None:
        """Grow back toward the base capacity when arrivals outnumber the
        free slots of a shrunk slab."""
        if not self._compact_drain \
                or self.capacity >= self._base_capacity:
            return
        free = int((~self.active).sum())
        if len(self.queue) > free and not self._staged:
            target = min(
                bucket_capacity(self.live + len(self.queue),
                                self._base_capacity),
                self._base_capacity)
            if target > self.capacity:
                self._resize(target, tick)

    # ------------------------------------------------------------- #
    @property
    def live(self) -> int:
        return int(self.active.sum())

    @property
    def pending(self) -> int:
        return len(self.queue) + self.live

    def _stage(self, slot: int, entry: QueueEntry, x0, audit: list,
               tick: int) -> None:
        r = entry.request
        tol = self.cfg.tol if r.tol is None else float(r.tol)
        self._staged[slot] = (entry, x0, tol)
        self.active[slot] = True
        self.slot_req[slot] = entry.req_id
        self.slot_tol[slot] = tol
        self.slot_masked[slot] = r.active_mask is not None
        self.telemetry.record_admit(entry.req_id)
        obs.instant("serve.admit", cat="continuous", tick=tick,
                    req_id=entry.req_id, slot=slot)
        rec = {"req_id": entry.req_id, "slot": slot,
               "signature": repr(self.spec), "admit_tick": tick,
               "evict_tick": None}
        audit.append(rec)
        self._open_audit[entry.req_id] = rec

    def _entry_x0(self, entry: QueueEntry):
        """``(x0, admissible)``: a ``warm_from`` dependency still in
        flight makes the entry inadmissible this tick.  ``warm_from``
        always names an earlier request, so deferral cannot deadlock."""
        r = entry.request
        if r.warm_from is not None:
            x0 = self._resolve_x0(r.warm_from)
            return x0, x0 is not None
        return r.x0, True

    def backfill(self, audit: list, tick: int) -> None:
        """Admit queued requests into free slots.  A request whose
        ``warm_from`` is still running is held aside this tick and
        re-queued, so later admissible requests take the slot."""
        self._maybe_grow(tick)
        free = [int(s) for s in np.flatnonzero(~self.active)]
        held: list[QueueEntry] = []
        while free and len(self.queue):
            entry = self.queue.pop()
            x0, ok = self._entry_x0(entry)
            if not ok:
                held.append(entry)
                continue
            self._stage(free.pop(0), entry, x0, audit, tick)
        for entry in held:
            self.queue.push(entry)

    def _admission(self) -> SlotAdmission:
        """This tick's staged rows, built from the requests' own arrays."""
        slots = sorted(self._staged)
        staged = [self._staged[s] for s in slots]
        return SlotAdmission(
            slots=tuple(slots),
            data=tuple(e.request.data_arrays(self.spec)
                       for e, _, _ in staged),
            c=tuple(float(e.request.c) for e, _, _ in staged),
            x0=tuple(x0 for _, x0, _ in staged),
            req_ids=tuple(e.req_id for e, _, _ in staged),
            active=tuple(e.request.active_mask for e, _, _ in staged),
            tol=tuple(tol for _, _, tol in staged))

    def step(self, tick: int) -> list[tuple[int, SolveResponse]]:
        """One tick (splice the staged rows + one chunk); returns the
        evictions."""
        self._maybe_shrink(tick)
        if not self.active.any():
            return []
        t0 = time.perf_counter()
        admission = None
        if self._staged:
            admission = self._admission()
            self._staged = {}
        stop = torch.from_numpy(self.stop.copy()).to(self.device)
        masked = bool((self.slot_masked & self.active).any())
        with obs.span("serve.chunk", cat="continuous", tick=tick,
                      live=self.live, capacity=self.capacity,
                      chunk_iters=self.chunk_iters):
            if self._health_cfg is None:
                self.slab, stop_dev = self._chunk(
                    self.slab, stop, admission, masked=masked)
                # The one per-tick host sync.
                stop = stop_dev.cpu().numpy().copy()
                status = None
            else:
                # Watchdog on: the readback widens to the int32 verdict
                # vector; the health carry stays on the device.
                self.slab, status_dev, prev_stat, stall = self._chunk(
                    self.slab, stop, admission, masked=masked,
                    health_carry=self._health_carry)
                self._health_carry = (prev_stat, stall)
                status = status_dev.cpu().numpy().copy()
                stop = status != STATUS_RUNNING
        wall = time.perf_counter() - t0
        if admission is not None:
            self.telemetry.record_admission_copy(
                rows=len(admission.slots), wall_s=self._chunk.splice_s)
        self.telemetry.record_chunk(live=self.live, capacity=self.capacity,
                                    chunk_iters=self.chunk_iters,
                                    wall_s=wall,
                                    flops=self._chunk_flops(self.capacity))

        if self.telemetry.sample_progress:
            # Opt-in residual sampling: one extra readback per tick.
            ks_all = self.slab.state.k.cpu().numpy()
            stats_all = self.slab.state.stat.cpu().numpy()
            for slot in np.flatnonzero(self.active):
                self.telemetry.record_progress(
                    int(self.slot_req[slot]), iters=int(ks_all[slot]),
                    stat=float(stats_all[slot]))

        finished = np.flatnonzero(stop & self.active)
        out = []
        if finished.size:
            state = self.slab.state
            sel = torch.as_tensor(finished, dtype=torch.long,
                                  device=self.device)
            xs = state.x.index_select(0, sel).cpu().numpy()
            ks = state.k.index_select(0, sel).cpu().numpy()
            stats = state.stat.index_select(0, sel).cpu().numpy()
            for j, slot in enumerate(finished):
                req_id = int(self.slot_req[slot])
                # Quarantine verdicts ride the eviction path of healthy
                # completions, so the exactly-once audit holds unchanged.
                verdict = "ok" if status is None else \
                    STATUS_LABELS.get(int(status[slot]), "ok")
                resp = SolveResponse(
                    x=xs[j], iters=int(ks[j]),
                    converged=bool(stats[j] <= self.slot_tol[slot]),
                    stat=float(stats[j]), bucket=self.capacity,
                    status=verdict)
                out.append((req_id, resp))
                self.telemetry.record_completion(
                    req_id, iters=resp.iters, converged=resp.converged,
                    status=verdict)
                if verdict != "ok":
                    self.telemetry.record_quarantine(verdict)
                    obs.instant("serve.quarantine", cat="continuous",
                                tick=tick, req_id=req_id, slot=int(slot),
                                status=verdict, iters=resp.iters)
                obs.instant("serve.evict", cat="continuous", tick=tick,
                            req_id=req_id, slot=int(slot),
                            iters=resp.iters, converged=resp.converged)
                rec = self._open_audit.pop(req_id)
                rec["evict_tick"] = tick
                rec["status"] = verdict
                self.active[slot] = False
                self.slot_req[slot] = -1
        self.stop = stop
        return out

    def expire_overdue(self, now: float,
                       tick: int) -> list[tuple[int, SolveResponse]]:
        """Evict every request whose absolute deadline has passed, as
        ``status="timeout"`` responses:

        * **queued** entries (never admitted) are removed from the queue
          and answered with their own ``x0`` (or zeros) at ``iters=0`` —
          no audit record exists to close;
        * **live** slots return their current iterate; the audit record
          is closed with ``status="timeout"`` and the slot freed.  A slot
          staged but not yet spliced answers with its staged x0.
        """
        out: list[tuple[int, SolveResponse]] = []

        def overdue(e: QueueEntry) -> bool:
            return e.deadline is not None and float(e.deadline) <= now

        for entry in self.queue.remove_if(overdue):
            r = entry.request
            x = np.zeros(self.spec.n, np.float32) if r.x0 is None \
                else np.asarray(r.x0, np.float32)
            resp = SolveResponse(
                x=x, iters=0, converged=False, stat=float("inf"),
                bucket=self.capacity, status="timeout")
            out.append((entry.req_id, resp))
            self.telemetry.record_completion(
                entry.req_id, iters=0, converged=False, status="timeout")
            self.telemetry.record_timeout()
            obs.instant("serve.timeout", cat="continuous", tick=tick,
                        req_id=entry.req_id, queued=True)

        live_overdue = [int(s) for s in np.flatnonzero(self.active)
                        if (d := self._deadline_of(int(self.slot_req[s])))
                        is not None and float(d) <= now]
        if live_overdue:
            state = self.slab.state
            xs = state.x.cpu().numpy()
            ks = state.k.cpu().numpy()
            stats = state.stat.cpu().numpy()
            for slot in live_overdue:
                req_id = int(self.slot_req[slot])
                staged = self._staged.pop(slot, None)
                if staged is not None:
                    # Not yet spliced: the slab row still holds a
                    # previous request's state.
                    x0 = staged[1]
                    resp = SolveResponse(
                        x=(np.zeros(self.spec.n, np.float32) if x0 is None
                           else np.array(x0, np.float32)),
                        iters=0, converged=False, stat=float("inf"),
                        bucket=self.capacity, status="timeout")
                else:
                    resp = SolveResponse(
                        x=xs[slot], iters=int(ks[slot]), converged=False,
                        stat=float(stats[slot]), bucket=self.capacity,
                        status="timeout")
                out.append((req_id, resp))
                self.telemetry.record_completion(
                    req_id, iters=resp.iters, converged=False,
                    status="timeout")
                self.telemetry.record_timeout()
                obs.instant("serve.timeout", cat="continuous", tick=tick,
                            req_id=req_id, slot=slot, queued=False,
                            iters=resp.iters)
                rec = self._open_audit.pop(req_id)
                rec["evict_tick"] = tick
                rec["status"] = "timeout"
                self.active[slot] = False
                self.slot_req[slot] = -1
                self.stop[slot] = True
        return out


class ContinuousSolverEngine:
    """Serve solve requests through slot slabs with continuous batching.

    Usage::

        eng = ContinuousSolverEngine(SolverConfig(tol=1e-6),
                                     ServeConfig(slab_capacity=8,
                                                 chunk_iters=16))
        ids = [eng.submit(r) for r in requests]
        responses = eng.drain()            # {req_id: SolveResponse}

    ``submit`` only enqueues (host-side); device work happens in
    :meth:`step` — one scheduler tick: backfill free slots from the
    admission queue, advance the serviced slabs one chunk, evict what
    finished.  :meth:`drain` ticks until nothing is queued or live.

    Determinism: with a fixed ``cfg.seed`` and submission order, the
    responses, the audit log and the telemetry's iteration counts are
    reproducible.  Prefer the front door:
    ``FlexaClient(backend="continuous")``.
    """

    def __init__(self, cfg: SolverConfig | None = None,
                 serve: ServeConfig | None = None, *,
                 telemetry: ServeTelemetry | None = None,
                 device=DEFAULT_DEVICE):
        warn_legacy("repro_torch.serve.ContinuousSolverEngine",
                    'FlexaClient(backend="continuous").submit(...)')
        self.cfg = cfg or SolverConfig()
        self.serve = serve or ServeConfig()
        if self.serve.slab_capacity < 1:
            raise ValueError("slab_capacity must be >= 1")
        if self.serve.chunk_iters < 1:
            raise ValueError("chunk_iters must be >= 1")
        if self.serve.mesh_devices > 1:
            raise ValueError(
                "mesh_devices > 1 needs the mesh engine, which is not yet "
                "ported to repro_torch (ROADMAP Queue 1 step 12)")
        AdmissionQueue(self.serve.policy)    # validate the policy eagerly
        self.device = resolve_device(device)
        self.telemetry = telemetry or ServeTelemetry()
        self._slabs: dict[BatchedProblemSpec, _SlotSlab] = {}
        self._responses: dict[int, SolveResponse] = {}
        self._spec_of: dict[int, BatchedProblemSpec] = {}
        #: Audit log of slot assignments (one record per admission,
        #: closed at eviction): the exactly-once-service record.
        self.audit: list[dict] = []
        #: Typed quarantine and timeout outcomes, in eviction order.
        self.failures: list[SolveFailure] = []
        self._tick = 0
        self._rr = 0                    # round-robin cursor over slabs
        self._deadlines: dict[int, float] = {}
        self._paths: dict[int, PathState] = {}
        self._path_of_req: dict[int, int] = {}
        self._path_ids = itertools.count()

    @property
    def pending(self) -> int:
        """Requests submitted but not yet completed."""
        return sum(s.pending for s in self._slabs.values())

    @property
    def queued(self) -> int:
        """Requests waiting in admission queues (not yet in a slot)."""
        return sum(len(s.queue) for s in self._slabs.values())

    def submit(self, request: SolveRequest, *,
               arrival: float | None = None) -> int:
        """Enqueue one request; returns its request id."""
        spec = request.spec
        validate_request(None, request, spec)
        if request.warm_from is not None:
            ref_spec = self._spec_of.get(request.warm_from)
            if ref_spec is None:
                raise ValueError(
                    f"warm_from={request.warm_from}: unknown request id "
                    "(must reference an earlier request of this engine)")
            if ref_spec != spec:
                raise ValueError(
                    f"warm_from={request.warm_from}: signature mismatch "
                    f"({ref_spec} vs {spec}) — a warm start only makes "
                    "sense within one (family × shape) signature")
        req_id = self.telemetry.next_request_id()
        t = self.telemetry.now() if arrival is None else arrival
        self.telemetry.record_arrival(req_id, spec.family, "continuous",
                                      t=t)
        self._spec_of[req_id] = spec
        if request.deadline is not None:
            self._deadlines[req_id] = float(request.deadline)
        slab = self._slabs.get(spec)
        if slab is None:
            slab = self._slabs[spec] = _SlotSlab(
                spec, self.cfg, self.serve, self.telemetry, self.device,
                resolve_x0=self._warm_solution,
                deadline_of=self._deadlines.get)
        slab.queue.push(QueueEntry(
            req_id=req_id, request=request, arrival=t,
            priority=request.priority, deadline=request.deadline))
        return req_id

    def _warm_solution(self, req_id: int):
        """x0 of a ``warm_from`` admission (None = still in flight)."""
        resp = self._responses.get(req_id)
        return None if resp is None else resp.x

    def submit_path(self, preq: PathRequest, *,
                    arrival: float | None = None) -> int:
        """Enqueue a whole λ-path; returns its *path id*.  Only the first
        point that needs a solve is submitted now (points at c ≥ λ_max are
        certified without one); each completion runs the KKT recheck and
        submits the next request inside :meth:`step`."""
        path_id = next(self._path_ids)
        st = PathState(path_id, preq, device=self.device)
        self._paths[path_id] = st
        first = st.next_request()
        if first is not None:
            req_id = self.submit(first, arrival=arrival)
            st.req_ids.append(req_id)
            self._path_of_req[req_id] = path_id
        return path_id

    def path_result(self, path_id: int) -> dict:
        """Snapshot of one path's progress (``done``, per-λ solutions,
        iterations, screening counters, request ids)."""
        return self._paths[path_id].result()

    def step(self) -> list[int]:
        """One scheduler tick: backfill → chunk → evict over the slabs
        this tick services (round-robin; ``slabs_per_tick = k > 0``
        services k slabs a tick, so every slab is reached within
        ⌈n_slabs / k⌉ ticks).  Path completions trigger their follow-up
        requests before the tick returns.  Returns the request ids
        completed this tick."""
        self._tick += 1
        done = []
        slabs = list(self._slabs.values())
        if slabs:
            per_tick = self.serve.slabs_per_tick or len(slabs)
            start = self._rr % len(slabs)
            order = slabs[start:] + slabs[:start]
            serviced = order[:per_tick]
            self._rr = (start + per_tick) % len(slabs)
            with obs.span("serve.tick", cat="continuous",
                          tick=self._tick, slabs=len(serviced),
                          queued=self.queued):
                for slab in serviced:
                    slab.backfill(self.audit, self._tick)
                    for req_id, resp in slab.step(self._tick):
                        self._responses[req_id] = resp
                        done.append(req_id)
                        if resp.status != "ok":
                            self.failures.append(SolveFailure(
                                req_id=req_id, status=resp.status,
                                iters=resp.iters, stat=resp.stat,
                                tick=self._tick))
        # Path advancement after the sweep: it may submit follow-ups
        # (possibly creating slabs).
        for req_id in done:
            path_id = self._path_of_req.get(req_id)
            if path_id is None:
                continue
            st = self._paths[path_id]
            follow_up = st.on_completion(self._responses[req_id])
            if follow_up is not None:
                new_id = self.submit(follow_up)
                st.req_ids.append(new_id)
                self._path_of_req[new_id] = path_id
        return done

    def expire_overdue(self, now: float | None = None) -> list[int]:
        """Evict every request whose ``deadline`` has passed
        (``status="timeout"``; audit closed, telemetry counted, a
        :class:`SolveFailure` appended).  Opt-in: deadlines are inert
        until this is called.  A timed-out request of a path ends the
        whole path.  Returns the expired request ids."""
        now = self.telemetry.now() if now is None else float(now)
        expired = []
        for slab in list(self._slabs.values()):
            for req_id, resp in slab.expire_overdue(now, self._tick):
                self._responses[req_id] = resp
                self._deadlines.pop(req_id, None)
                expired.append(req_id)
                self.failures.append(SolveFailure(
                    req_id=req_id, status="timeout", iters=resp.iters,
                    stat=resp.stat, tick=self._tick))
                path_id = self._path_of_req.get(req_id)
                if path_id is not None:
                    self._paths[path_id].done = True
        return expired

    def drain(self) -> dict[int, SolveResponse]:
        """Tick until every submitted request has completed."""
        while self.pending:
            self.step()
        return dict(self._responses)

    @property
    def responses(self) -> dict[int, SolveResponse]:
        return self._responses
