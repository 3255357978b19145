"""Serve telemetry: host copies of ``RequestTrace`` and ``ServeTelemetry``.

The port's inline backend records each request's lifecycle (arrival,
admission, completion, iterations) here, as the reference's backends
do, so ``FlexaClient.diagnostics`` and the session snapshot read the
same fields in both packages.  The reference's engine-side counters
(continuous chunks, waves, watchdog quarantines, deadline timeouts,
progress sampling, SLO windows) arrive with the serving engines of a
later slice; until then the snapshot has the reference's keys for
inline work, whose engine sections are absent there too.  Its
``compile_cache`` section is empty: eager PyTorch builds no programs to
cache.

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
    engine: str = ""
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


@dataclass
class ServeTelemetry:
    """Request lifecycles a backend appends to as it serves."""
    clock: object = time.perf_counter
    requests: dict = field(default_factory=dict)    # req_id -> RequestTrace
    _req_ids: object = field(default_factory=itertools.count)

    def now(self) -> float:
        return float(self.clock())

    def next_request_id(self) -> int:
        """Allocate a request id unique within this telemetry."""
        return next(self._req_ids)

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

    def latencies(self) -> list:
        return [r.latency for r in self.requests.values()
                if r.latency is not None]

    def ledger(self) -> CostLedger:
        """Session ledger: the inline backend records no engine-side
        device work (per-result ledgers carry it), and eager PyTorch
        builds no programs, so every key is zero."""
        return CostLedger()

    def snapshot(self) -> dict:
        """Everything a dashboard wants, with the reference's keys."""
        lats = self.latencies()
        waits = [r.queue_wait for r in self.requests.values()
                 if r.queue_wait is not None]
        completed = [r for r in self.requests.values()
                     if r.completed is not None]
        return {
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
