"""Serve telemetry: one recorder shared by the wave and continuous engines
and the inline backend (a host copy of ``repro.serve.metrics``).

:class:`ServeTelemetry` records

* the **request lifecycle** — arrival (submit), admission (first device
  iteration), completion — from which queue wait and end-to-end latency
  (p50/p99/mean) derive;
* **chunk-level** counters of the continuous engine — chunks, FLEXA
  iterations per second of chunk wall, slot occupancy (live slots / slab
  capacity, weighted per chunk), padding waste (idle-slot row
  iterations), drain-tail migrations, and the host wall spent copying
  admitted rows onto the device;
* **wave-level** counters of the bucketed engine — bucket occupancy,
  padding waste (row iterations spent on padding clones) and freeze
  waste (row iterations spent stepping converged instances while a
  straggler holds the bucket open);
* the watchdog's quarantines, deadline timeouts, opt-in progress samples
  and sliding SLO windows (``repro_torch.obs.windows``).

The snapshot has the reference's keys.  Its ``compile_cache`` section is
empty: eager PyTorch builds no programs to cache.  The mesh engine's
per-device telemetry (``MeshTelemetry``) waits for the mesh engine
(ROADMAP Queue 1 step 12).

Timestamps come from an injectable ``clock`` (default
``time.perf_counter``).
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs.ledger import CostLedger

#: Wire-format version of :meth:`ServeTelemetry.snapshot` — the same
#: schema number as the reference's snapshot.
SNAPSHOT_SCHEMA = 1


def percentile(values, q: float):
    """Linear-interpolation percentile; ``None`` on an empty sample."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


@dataclass
class RequestTrace:
    """Lifecycle timestamps and outcome of one solve request."""
    req_id: int
    family: str
    arrival: float
    admitted: float | None = None
    completed: float | None = None
    iters: int = 0
    converged: bool = False
    engine: str = ""                # "inline" | "wave" | "continuous"
    #: "ok" | "diverged" | "stalled" (watchdog quarantine verdicts) |
    #: "timeout" (deadline eviction via ``expire_overdue``).
    status: str = "ok"
    samples: list = field(default_factory=list)  # (t, iters, stat) triples

    @property
    def queue_wait(self) -> float | None:
        if self.admitted is None:
            return None
        return self.admitted - self.arrival

    @property
    def latency(self) -> float | None:
        if self.completed is None:
            return None
        return self.completed - self.arrival

    def as_dict(self) -> dict:
        """Plain-dict view for dashboards / ticket diagnostics."""
        return {
            "req_id": self.req_id, "family": self.family,
            "engine": self.engine, "arrival": self.arrival,
            "admitted": self.admitted, "completed": self.completed,
            "queue_wait": self.queue_wait, "latency": self.latency,
            "iters": self.iters, "converged": self.converged,
            "status": self.status,
            "samples": list(self.samples),
        }


def _chunk_summary(t: "ServeTelemetry") -> dict:
    """The continuous engine's chunk counters as a snapshot dict."""
    row = t.chunk_row_iters
    return {
        "chunks": t.chunks,
        "chunk_iters": t.chunk_iters,
        "row_iters": row,
        "live_iters": t.chunk_live_iters,
        "device_flops": t.chunk_flops,
        "occupancy_mean": t.chunk_live_iters / row if row else 0.0,
        "padding_waste": ((row - t.chunk_live_iters) / row
                          if row else 0.0),
        "chunk_wall_s": t.chunk_wall,
        "iters_per_s": (t.chunk_live_iters / t.chunk_wall
                        if t.chunk_wall > 0 else None),
        "migrations": t.migrations,
        "admitted_rows": t.admitted_rows,
        "admit_copy_s": t.admit_copy_wall,
    }


@dataclass
class ServeTelemetry:
    """Mutable counters a backend or engine appends to as it serves."""
    clock: object = time.perf_counter
    requests: dict = field(default_factory=dict)    # req_id -> RequestTrace
    _req_ids: object = field(default_factory=itertools.count)
    # continuous-engine chunk counters
    chunks: int = 0
    chunk_iters: int = 0            # Σ K over chunks (per-slot iterations)
    chunk_row_iters: int = 0        # Σ K·capacity (device row iterations)
    chunk_live_iters: int = 0       # Σ K·live     (useful row iterations)
    chunk_flops: int = 0            # Σ K·capacity·m·n (matvec currency)
    chunk_wall: float = 0.0
    migrations: int = 0             # drain-tail slab capacity changes
    admitted_rows: int = 0          # rows copied into slabs on admission
    admit_copy_wall: float = 0.0    # host wall of those copies, seconds
    # wave-engine per-bucket records
    waves: list = field(default_factory=list)
    # opt-in per-chunk residual sampling (one extra readback per tick)
    sample_progress: bool = False
    # numerical-health watchdog quarantine counters
    quarantined_diverged: int = 0
    quarantined_stalled: int = 0
    # deadline evictions (ContinuousSolverEngine.expire_overdue)
    timeouts: int = 0
    # sliding-window SLO metrics (repro_torch.obs.windows): horizon in
    # clock seconds; 0 = disabled (windows cost extra clock reads).
    window_s: float = 0.0
    _windows: object = None

    def now(self) -> float:
        return float(self.clock())

    def windows(self):
        """The lazily created :class:`repro_torch.obs.windows.
        MetricWindows` (``None`` when ``window_s`` is 0/unset)."""
        if not self.window_s or self.window_s <= 0:
            return None
        if self._windows is None:
            from repro_torch.obs.windows import MetricWindows
            self._windows = MetricWindows(horizon=self.window_s)
        return self._windows

    def next_request_id(self) -> int:
        """Allocate a request id unique within this telemetry (a
        telemetry shared between engines never sees one id twice)."""
        return next(self._req_ids)

    # ------------------------------------------------------------- #
    # request lifecycle
    # ------------------------------------------------------------- #
    def record_arrival(self, req_id: int, family: str, engine: str,
                       t: float | None = None) -> None:
        self.requests[req_id] = RequestTrace(
            req_id=req_id, family=family, engine=engine,
            arrival=self.now() if t is None else t)

    def record_admit(self, req_id: int, t: float | None = None) -> None:
        self.requests[req_id].admitted = self.now() if t is None else t

    def record_completion(self, req_id: int, *, iters: int, converged: bool,
                          status: str = "ok",
                          t: float | None = None) -> None:
        r = self.requests[req_id]
        r.completed = self.now() if t is None else t
        r.iters = int(iters)
        r.converged = bool(converged)
        r.status = str(status)
        w = self.windows()
        if w is not None:
            # The completion timestamp doubles as the window sample time.
            w.add("completions", r.completed, 1.0)
            if r.latency is not None:
                w.add("latency", r.completed, r.latency)
            if r.queue_wait is not None:
                w.add("queue_wait", r.completed, r.queue_wait)

    def record_quarantine(self, status: str, t: float | None = None) -> None:
        """One watchdog quarantine event ("diverged" or "stalled")."""
        if status == "diverged":
            self.quarantined_diverged += 1
        elif status == "stalled":
            self.quarantined_stalled += 1
        else:
            raise ValueError(f"unknown quarantine status {status!r}")
        w = self.windows()
        if w is not None:
            w.add("health_events", self.now() if t is None else t, 1.0)

    def record_timeout(self, t: float | None = None) -> None:
        """One deadline eviction (``status="timeout"``): a policy
        outcome, counted apart from the health verdicts."""
        self.timeouts += 1
        w = self.windows()
        if w is not None:
            w.add("timeouts", self.now() if t is None else t, 1.0)

    def record_progress(self, req_id: int, *, iters: int, stat: float,
                        t: float | None = None) -> None:
        """One sampled (time, iters, stat) point for a request; no-op
        unless :attr:`sample_progress` is on."""
        if not self.sample_progress:
            return
        r = self.requests.get(req_id)
        if r is not None:
            r.samples.append((self.now() if t is None else t,
                              int(iters), float(stat)))

    # ------------------------------------------------------------- #
    # engine-side counters
    # ------------------------------------------------------------- #
    def record_chunk(self, *, live: int, capacity: int, chunk_iters: int,
                     wall_s: float, flops: int = 0) -> None:
        self.chunks += 1
        self.chunk_iters += chunk_iters
        self.chunk_row_iters += chunk_iters * capacity
        self.chunk_live_iters += chunk_iters * live
        self.chunk_flops += int(flops)
        self.chunk_wall += wall_s
        w = self.windows()
        if w is not None:
            w.add("occupancy", self.now(),
                  live / capacity if capacity else 0.0)

    def record_admission_copy(self, *, rows: int, wall_s: float) -> None:
        """Rows copied host → device into a slab on one tick."""
        self.admitted_rows += int(rows)
        self.admit_copy_wall += float(wall_s)

    def record_migration(self, *, from_capacity: int,
                         to_capacity: int) -> None:
        """One drain-tail slab migration."""
        self.migrations += 1

    def record_wave(self, *, bucket: int, n_real: int, iters,
                    wall_s: float, device_iters_max: int | None = None,
                    flops: int = 0) -> None:
        """One wave bucket: ``iters`` are the per-row iteration counts of
        the real requests; ``device_iters_max`` the max over all rows,
        padding clones included."""
        iters = [int(i) for i in iters]
        iters_max = max(iters) if iters else 0
        if device_iters_max is not None:
            iters_max = max(iters_max, int(device_iters_max))
        row_iters = bucket * iters_max          # what the device executed
        useful = sum(iters)
        self.waves.append({
            "bucket": bucket, "n_real": n_real, "padded": bucket - n_real,
            "occupancy": n_real / bucket if bucket else 0.0,
            "iters_max": iters_max, "useful_row_iters": useful,
            "row_iters": row_iters,
            "padding_waste": ((bucket - n_real) * iters_max / row_iters
                              if row_iters else 0.0),
            "freeze_waste": ((n_real * iters_max - useful) / row_iters
                             if row_iters else 0.0),
            "flops": int(flops),
            "wall_s": wall_s,
        })

    # ------------------------------------------------------------- #
    # aggregation
    # ------------------------------------------------------------- #
    def latencies(self) -> list:
        return [r.latency for r in self.requests.values()
                if r.latency is not None]

    def ledger(self) -> CostLedger:
        """Unified :class:`~repro_torch.obs.ledger.CostLedger` over
        everything this telemetry recorded.

        Continuous chunks cannot split freeze from padding, so their
        whole ``row - live`` remainder lands in ``padding_iters``; waves
        attribute both exactly.  ``compiles`` stays 0: eager PyTorch
        builds no programs."""
        led = CostLedger()
        led.add(row_iters=self.chunk_row_iters,
                live_iters=self.chunk_live_iters,
                padding_iters=self.chunk_row_iters - self.chunk_live_iters,
                device_flops=self.chunk_flops)
        for w in self.waves:
            pad = w["padded"] * w["iters_max"]
            led.add(row_iters=w["row_iters"],
                    live_iters=w["useful_row_iters"],
                    padding_iters=pad,
                    freeze_iters=(w["row_iters"] - w["useful_row_iters"]
                                  - pad),
                    device_flops=w.get("flops", 0))
        return led

    def snapshot(self) -> dict:
        """Everything a dashboard wants, with the reference's keys."""
        lats = self.latencies()
        waits = [r.queue_wait for r in self.requests.values()
                 if r.queue_wait is not None]
        completed = [r for r in self.requests.values()
                     if r.completed is not None]
        out = {
            "schema": SNAPSHOT_SCHEMA,
            "requests": len(self.requests),
            "completed": len(completed),
            "in_flight": len(self.requests) - len(completed),
            "converged": sum(r.converged for r in completed),
            "iters_total": sum(r.iters for r in completed),
            "latency_p50": percentile(lats, 50),
            "latency_p99": percentile(lats, 99),
            "latency_mean": (float(np.mean(lats)) if lats else None),
            "latency_max": (float(np.max(lats)) if lats else None),
            "queue_wait_p50": percentile(waits, 50),
            "queue_wait_p99": percentile(waits, 99),
            "ledger": self.ledger().as_dict(),
            "compile_cache": {},
        }
        if (self.quarantined_diverged or self.quarantined_stalled
                or self.timeouts):
            out["health"] = {
                "quarantined": (self.quarantined_diverged
                                + self.quarantined_stalled),
                "diverged": self.quarantined_diverged,
                "stalled": self.quarantined_stalled,
                "timeouts": self.timeouts,
            }
        w = self.windows()
        if w is not None:
            out["windows"] = w.snapshot(self.now())
        if self.chunks:
            out["continuous"] = _chunk_summary(self)
        if self.waves:
            row = sum(w["row_iters"] for w in self.waves)
            useful = sum(w["useful_row_iters"] for w in self.waves)
            pad = sum(w["padded"] * w["iters_max"] for w in self.waves)
            out["wave"] = {
                "waves": len(self.waves),
                "row_iters": row,
                "device_flops": sum(w.get("flops", 0) for w in self.waves),
                "occupancy_mean": (float(np.mean(
                    [w["occupancy"] for w in self.waves]))),
                "padding_waste": pad / row if row else 0.0,
                "freeze_waste": ((row - useful - pad) / row
                                 if row else 0.0),
                "wall_s": sum(w["wall_s"] for w in self.waves),
            }
        return out
