"""Execution backends behind the client front door (a port of
``repro.client.backends``).

A backend is *how* a normalized :class:`~repro_torch.client.specs.WorkItem`
is executed.  The port has the ``inline`` backend — in-process: the
method registry for solos, the lockstep batched engine for batches, the
homotopy driver for paths and CV sweeps — which runs every workload on
the client's device, moving a problem built elsewhere onto it first.
The reference's serving backends (``wave``, ``continuous``, ``mesh``,
``remote``) are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.client.errors import NotPortedError, UnknownBackendError
from repro_torch.client.specs import (BatchResult, CVResult, SoloResult,
                                      WorkItem, mse_score)
from repro_torch.config.base import ClientConfig, SolverConfig
from repro_torch.device import resolve_device
from repro_torch.obs.ledger import CostLedger
from repro_torch.path.driver import (_problem_at, _solve_path,
                                     _solve_path_batched)
from repro_torch.problems.families import get_family, infer_family, problem_on
from repro_torch.serve.metrics import ServeTelemetry
from repro_torch.solvers.batched import _solve_batched

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


def _batch_result(r, item: WorkItem, backend: str) -> BatchResult:
    """The client contract of a batched :class:`SolverResult`."""
    iters = np.asarray(r.iters)
    return BatchResult(
        x=r.x.cpu().numpy(), iters=iters,
        converged=np.asarray(r.converged),
        stat=r.state.stat.cpu().numpy(), backend=backend, raw=r,
        ledger=_batch_ledger(item, iters))


def _batch_ledger(item: WorkItem, iters: np.ndarray) -> CostLedger:
    """Lockstep pricing: the device runs every instance for the slowest
    instance's iteration count (frozen rows thereafter)."""
    B = len(item.problems)
    row = int(iters.max()) * B if B else 0
    live = int(iters.sum())
    m, n = _dims(item.problems[0]) if B else (0, 0)
    led = CostLedger()
    led.add(row_iters=row, live_iters=live, freeze_iters=row - live,
            device_flops=row * m * n)
    return led


def _scorer(spec):
    if spec.score is not None:
        return spec.score
    if spec.validation is not None:
        return mse_score(spec.validation)
    return None


def _cv_select(item: WorkItem, folds: list) -> dict:
    """Score a finished sweep; returns scores/best or empties."""
    score = _scorer(item.spec)
    if score is None:
        return {"scores": None, "scores_mean": None, "best_index": None,
                "best_lambda": None}
    K, P = len(folds), int(folds[0].lambdas.shape[0])
    scores = np.array([[score(i, k, folds[i].x[k]) for k in range(P)]
                       for i in range(K)])
    mean = scores.mean(axis=0)
    best = int(np.argmin(mean))
    return {"scores": scores, "scores_mean": mean, "best_index": best,
            "best_lambda": float(folds[0].lambdas[best])}


def _winner_problems(problems: list, best_lambda: float) -> list:
    return [_problem_at(p, best_lambda) for p in problems]


def _finish_cv(item: WorkItem, folds: list, backend: str,
               x_best: np.ndarray | None, select: dict, meta: dict,
               ledger: CostLedger | None = None) -> CVResult:
    if select["best_index"] is not None and x_best is None:
        # Full-tolerance sweep: the winner column IS the answer.
        x_best = np.stack([f.x[select["best_index"]] for f in folds])
    return CVResult(folds=folds, lambdas=folds[0].lambdas,
                    backend=backend, x_best=x_best,
                    meta={**meta, "tol_coarse": item.spec.tol_coarse},
                    ledger=ledger, **select)


def _cv_ledger(folds: list, resolve_led: CostLedger | None) -> CostLedger:
    """Sweep cost + (optional) winner re-solve cost.  The lockstep sweep
    attaches one *sweep-wide* ledger copy to every fold, so one copy is
    the sweep's (summing would count it K times)."""
    led = folds[0].ledger.copy()
    if resolve_led is not None:
        led.merge(resolve_led)
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

    def _begin_requests(self, item: WorkItem, arrival) -> list[int]:
        """Record the request lifecycle the serve engines record natively
        (one request per problem, one per solo or path ticket; inline
        admits at arrival)."""
        tele = self.telemetry
        n = 1 if item.kind in ("solo", "path") else len(item.problems)
        rids = []
        for _ in range(n):
            rid = tele.next_request_id()
            t = tele.now() if arrival is None else arrival
            tele.record_arrival(rid, item.family or "adhoc", self.name, t=t)
            tele.record_admit(rid, t=t)
            rids.append(rid)
        self._ticket_rids[item.ticket] = rids
        return rids

    def _finish_requests(self, item: WorkItem, rids: list[int]) -> None:
        res = self._results[item.ticket]
        if item.kind == "solo":
            stats = [(res.iters, res.converged)]
        elif item.kind == "batch":
            stats = [(int(i), bool(c))
                     for i, c in zip(np.ravel(res.iters),
                                     np.ravel(res.converged))]
        elif item.kind == "path":
            stats = [(int(res.iters.sum()), bool(res.converged.all()))]
        else:                                   # cv: one trace per fold
            stats = [(int(f.iters.sum()), bool(f.converged.all()))
                     for f in res.folds]
        for rid, (iters, conv) in zip(rids, stats):
            self.telemetry.record_completion(rid, iters=iters,
                                             converged=conv)

    def request_ids(self, ticket: int) -> list[int]:
        return list(self._ticket_rids.get(ticket, []))

    def submit(self, item: WorkItem, arrival=None) -> list[int]:
        cfg = self.config.solver
        spec = item.spec
        rids = self._begin_requests(item, arrival)
        problems = [problem_on(p, self.device) for p in item.problems]
        if item.kind == "solo":
            from repro_torch.solvers.api import _solve
            r = _solve(problems[0], method=spec.method, cfg=cfg, x0=spec.x0,
                       **spec.options)
            stat = getattr(r.state, "stat", None)
            res = SoloResult(
                x=r.x.cpu().numpy(), iters=int(r.iters),
                converged=bool(np.asarray(r.converged).all()),
                stat=None if stat is None else float(stat),
                backend=self.name, raw=r,
                ledger=_request_ledger([r.iters], problems))
        elif item.kind == "batch":
            r = _solve_batched(problems, x0=spec.x0, cfg=cfg,
                               record_history=spec.record_history,
                               active=spec.active)
            res = _batch_result(r, item, self.name)
        elif item.kind == "path":
            res = _solve_path(
                problems[0], spec.lambdas, n_points=spec.n_points,
                lam_min_ratio=spec.lam_min_ratio, cfg=cfg,
                warm=spec.warm, screen=spec.screen,
                kkt_slack=spec.kkt_slack, lam_batch=spec.lam_batch,
                tol_schedule=spec.tol_schedule, compact=spec.compact,
                clock=self.telemetry.clock)
        else:
            res = self._run_cv(item, problems, cfg)
        self._results[item.ticket] = res
        self._finish_requests(item, rids)
        return [item.ticket]

    def _run_cv(self, item: WorkItem, problems: list,
                cfg: SolverConfig) -> CVResult:
        spec = item.spec
        sweep_cfg = (cfg if spec.tol_coarse is None
                     else dataclasses.replace(cfg, tol=spec.tol_coarse))
        folds = _solve_path_batched(
            problems, spec.lambdas, n_points=spec.n_points,
            lam_min_ratio=spec.lam_min_ratio, cfg=sweep_cfg,
            warm=spec.warm, screen=spec.screen,
            kkt_slack=spec.kkt_slack, tol_schedule=spec.tol_schedule,
            clock=self.telemetry.clock)
        select = _cv_select(item, folds)
        x_best = None
        resolve_led = None
        if select["best_index"] is not None \
                and spec.tol_coarse is not None:
            # Coarse-to-fine continuation: only the winner gets the
            # full-accuracy re-solve, warm-started from its coarse
            # solution (unscreened, so exactness needs no KKT loop).
            x0 = np.stack([f.x[select["best_index"]] for f in folds])
            r = _solve_batched(
                _winner_problems(problems, select["best_lambda"]), x0=x0,
                cfg=cfg)
            x_best = r.x.cpu().numpy()
            resolve_led = _batch_ledger(item, np.asarray(r.iters))
        return _finish_cv(item, folds, self.name, x_best, select,
                          meta={"mode": "lockstep"},
                          ledger=_cv_ledger(folds, resolve_led))
