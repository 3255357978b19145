"""Execution backends behind the client front door (a port of
``repro.client.backends``).

A backend is *how* a normalized :class:`~repro_torch.client.specs.WorkItem`
is executed.  The port has the ``inline`` backend — in-process: the
method registry for solos, the homotopy driver for paths — which runs
every workload on the client's device, moving a problem built elsewhere
onto it first.  The reference's serving backends (``wave``,
``continuous``, ``mesh``, ``remote``) are not ported yet.
"""
from __future__ import annotations

import numpy as np

from repro_torch.client.errors import NotPortedError, UnknownBackendError
from repro_torch.client.specs import SoloResult, WorkItem
from repro_torch.config.base import ClientConfig
from repro_torch.device import resolve_device
from repro_torch.obs.ledger import CostLedger
from repro_torch.path.driver import _solve_path
from repro_torch.problems.families import get_family, infer_family, problem_on
from repro_torch.serve.metrics import ServeTelemetry

#: Backends of the reference that this port does not have yet.
NOT_YET_PORTED = ("continuous", "mesh", "remote", "wave")


def _dims(problem) -> tuple[int, int]:
    """(m, n) pricing dims of a registry-family instance ((0, 0) for
    ad-hoc problems, whose cost the shared currency cannot express)."""
    try:
        fam = infer_family(problem)
        A = problem.data[get_family(fam).data_keys[0]]
    except (ValueError, KeyError):
        return 0, 0
    return (int(A.shape[0]), int(A.shape[1])) if A.dim() == 2 else (0, 0)


def _request_ledger(iter_counts, problems) -> CostLedger:
    """Per-request useful-work pricing: each request's own iterations at
    its own (m, n)."""
    led = CostLedger()
    for it, p in zip(iter_counts, problems):
        it = int(it)
        m, n = _dims(p)
        led.add(row_iters=it, live_iters=it, device_flops=it * m * n)
    return led


class Backend:
    """Execution strategy for normalized work items.

    ``submit`` may complete eagerly (returns the tickets it finished);
    ``step`` advances asynchronous work; ``pending`` counts unfinished
    tickets; ``result`` returns a completed ticket's result (``None``
    while in flight); ``validate`` rejects what the strategy cannot run.
    """

    name = "?"

    def __init__(self, config: ClientConfig, telemetry: ServeTelemetry):
        self.config = config
        self.telemetry = telemetry
        self.device = resolve_device(config.device)
        self._results: dict[int, object] = {}

    def validate(self, item: WorkItem) -> None:
        pass

    def submit(self, item: WorkItem, arrival=None) -> list[int]:
        raise NotImplementedError

    def step(self) -> list[int]:
        return []

    @property
    def pending(self) -> int:
        return 0

    def result(self, ticket: int):
        return self._results.get(ticket)

    def request_ids(self, ticket: int) -> list[int]:
        return []

    def stats(self) -> dict:
        return {"backend": self.name, "device": str(self.device)}

    def close(self) -> None:
        pass


_BACKENDS: dict[str, type] = {}


def register_backend(cls: type) -> type:
    """Register a :class:`Backend` subclass under ``cls.name``."""
    if cls.name in _BACKENDS:
        raise ValueError(f"backend {cls.name!r} already registered")
    _BACKENDS[cls.name] = cls
    return cls


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def make_backend(config: ClientConfig,
                 telemetry: ServeTelemetry) -> Backend:
    if config.backend in NOT_YET_PORTED:
        raise NotPortedError(
            f"backend {config.backend!r} is not yet ported to repro_torch; "
            f"available: {available_backends()}")
    try:
        cls = _BACKENDS[config.backend]
    except KeyError:
        raise UnknownBackendError(
            f"unknown backend {config.backend!r}; available: "
            f"{available_backends()}") from None
    return cls(config, telemetry)


@register_backend
class InlineBackend(Backend):
    """In-process execution: the reference semantics."""

    name = "inline"

    def __init__(self, config, telemetry):
        super().__init__(config, telemetry)
        self._ticket_rids: dict[int, list[int]] = {}

    def _begin_request(self, item: WorkItem, arrival) -> int:
        """Record the request lifecycle the serve engines record natively
        (one request per ticket; inline admits at arrival)."""
        tele = self.telemetry
        rid = tele.next_request_id()
        t = tele.now() if arrival is None else arrival
        tele.record_arrival(rid, item.family or "adhoc", self.name, t=t)
        tele.record_admit(rid, t=t)
        self._ticket_rids[item.ticket] = [rid]
        return rid

    def request_ids(self, ticket: int) -> list[int]:
        return list(self._ticket_rids.get(ticket, []))

    def submit(self, item: WorkItem, arrival=None) -> list[int]:
        cfg = self.config.solver
        spec = item.spec
        rid = self._begin_request(item, arrival)
        problem = problem_on(spec.problem, self.device)
        if item.kind == "solo":
            from repro_torch.solvers.api import _solve
            r = _solve(problem, method=spec.method, cfg=cfg, x0=spec.x0,
                       **spec.options)
            stat = getattr(r.state, "stat", None)
            res = SoloResult(
                x=r.x.cpu().numpy(), iters=int(r.iters),
                converged=bool(np.asarray(r.converged).all()),
                stat=None if stat is None else float(stat),
                backend=self.name, raw=r,
                ledger=_request_ledger([r.iters], [problem]))
            iters, conv = res.iters, res.converged
        else:
            res = _solve_path(
                problem, spec.lambdas, n_points=spec.n_points,
                lam_min_ratio=spec.lam_min_ratio, cfg=cfg,
                warm=spec.warm, screen=spec.screen,
                kkt_slack=spec.kkt_slack, lam_batch=spec.lam_batch,
                tol_schedule=spec.tol_schedule, compact=spec.compact,
                clock=self.telemetry.clock)
            iters, conv = int(res.iters.sum()), bool(res.converged.all())
        self._results[item.ticket] = res
        self.telemetry.record_completion(rid, iters=iters, converged=conv)
        return [item.ticket]
