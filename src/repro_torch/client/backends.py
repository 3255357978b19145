"""Execution backends behind the client front door (a port of
``repro.client.backends``).

A backend is *how* a normalized :class:`~repro_torch.client.specs.WorkItem`
is executed, never what it computes; every backend runs on the client's
device:

* ``inline``     — in-process: the method registry for solos, the
  lockstep batched engine for batches, the homotopy driver for paths and
  CV sweeps; a problem built elsewhere is moved to the device first;
* ``wave``       — :class:`~repro_torch.serve.engine.SolverServeEngine`:
  buffered submissions are packed into padded power-of-two buckets and
  run as waves; paths and CV run the :class:`~repro_torch.serve.
  pathstate.PathState` protocol, one wave per λ-point across every
  in-flight path;
* ``continuous`` — :class:`~repro_torch.serve.continuous.
  ContinuousSolverEngine`: slot-slab continuous batching with eviction
  and backfill; paths and CV ride the engine's point-by-point admission;
* ``remote``     — :class:`~repro_torch.remote.backend.RemoteBackend`: a
  solver service over HTTP (registered on first use, so the client core
  never imports the networking code).

The serving backends construct their engines under
:func:`repro_torch.deprecation.internal_use`, so the client never
triggers the engines' legacy warnings.  The reference's ``mesh`` backend
is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch.client.errors import (NotPortedError, UnknownBackendError,
                                       UnsupportedWorkloadError)
from repro_torch.client.specs import (SERVE_PATH_FAMILIES, BatchResult,
                                      CVResult, SoloResult, WorkItem,
                                      _host, mse_score, solve_request_of)
from repro_torch.config.base import ClientConfig, SolverConfig
from repro_torch.deprecation import internal_use
from repro_torch.device import resolve_device
from repro_torch.obs.ledger import CostLedger
from repro_torch.path.driver import (PathResult, _problem_at, _solve_path,
                                     _solve_path_batched)
from repro_torch.path.grid import geometric_grid, lambda_max, validate_grid
from repro_torch.path.screening import ScreenReport
from repro_torch.problems.families import get_family, infer_family, problem_on
from repro_torch.serve.metrics import ServeTelemetry
from repro_torch.solvers.batched import _solve_batched

#: Backends of the reference that this port does not have yet.
NOT_YET_PORTED = ("mesh",)


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


def _solver_batch_result(r, item: WorkItem, backend: str) -> BatchResult:
    """The client contract of a batched :class:`SolverResult`."""
    iters = np.asarray(r.iters)
    return BatchResult(
        x=r.x.cpu().numpy(), iters=iters,
        converged=np.asarray(r.converged),
        stat=r.state.stat.cpu().numpy(), backend=backend, raw=r,
        ledger=_batch_ledger(item, iters))


def _solo_result(resp, backend: str, problem=None) -> SoloResult:
    """A serve ``SolveResponse`` on the client contract."""
    led = (None if problem is None
           else _request_ledger([resp.iters], [problem]))
    return SoloResult(x=np.asarray(resp.x), iters=int(resp.iters),
                      converged=bool(resp.converged),
                      stat=float(resp.stat), backend=backend, raw=resp,
                      ledger=led, status=str(resp.status))


def _batch_result(resps, backend: str, problems=None) -> BatchResult:
    """B serve responses on the client contract."""
    led = (None if problems is None
           else _request_ledger([r.iters for r in resps], problems))
    return BatchResult(
        x=np.stack([np.asarray(r.x) for r in resps]),
        iters=np.asarray([int(r.iters) for r in resps], np.int64),
        converged=np.asarray([bool(r.converged) for r in resps], bool),
        stat=np.asarray([float(r.stat) for r in resps]),
        backend=backend, raw=list(resps), ledger=led,
        status=[str(r.status) for r in resps])


def _path_result_from_serve(problem, d: dict, backend: str) -> PathResult:
    """The shared :class:`PathResult` from the serve path protocol's
    progress dict (``PathState.result()``); V on the problem's device."""
    lambdas = np.asarray(d["lambdas"], np.float64)
    xs = np.asarray(d["x"], np.float32)
    P = lambdas.shape[0]
    n_blocks, bs = problem.n_blocks, problem.block_size
    V = np.array([float(_problem_at(problem, float(lambdas[k])).v(
        torch.from_numpy(xs[k]).to(problem.device))) for k in range(P)])
    support = np.array([
        int(np.count_nonzero(np.linalg.norm(
            xs[k].reshape(n_blocks, bs), axis=-1)))
        for k in range(P)], np.int64)
    screened_out = np.asarray(d["screened_out"], np.int64)
    kkt_rounds = np.asarray(d["kkt_rounds"], np.int64)
    iters = np.asarray(d["iters"], np.int64)
    led = _request_ledger([int(iters.sum())], [problem])
    return PathResult(
        lambdas=lambdas, x=xs, V=V, iters=iters,
        converged=np.asarray(d["converged"], bool),
        support=support,
        active_blocks=n_blocks - screened_out,
        screened=[ScreenReport(n_blocks=n_blocks,
                               screened_out=int(screened_out[k]),
                               kkt_rounds=int(kkt_rounds[k]))
                  for k in range(P)],
        # Per-request iteration total; slab / bucket waste lives in the
        # session telemetry.
        row_iters=int(iters.sum()),
        device_flops=led.device_flops,
        lam_max=float(d["lam_max"]),
        meta={"backend": backend, "source": "serve"},
        ledger=led)


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


def _resolve_cv_grid(item: WorkItem) -> np.ndarray:
    """The shared fold grid (anchored at the largest fold λ_max), the
    lockstep driver's rule."""
    spec = item.spec
    if spec.lambdas is not None:
        return validate_grid(spec.lambdas)
    lam = max(lambda_max(p) for p in item.problems)
    return geometric_grid(lam, n_points=spec.n_points,
                          lam_min_ratio=spec.lam_min_ratio)


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


def _cv_ledger(folds: list, resolve_led: CostLedger | None,
               shared: bool = False) -> CostLedger:
    """Sweep cost + (optional) winner re-solve cost.  Serve-side folds
    each carry their own per-request ledger (summed); the lockstep sweep
    attaches one sweep-wide ledger copy to every fold (``shared=True``:
    one copy is the sweep's, summing would count it K times)."""
    leds = [f.ledger for f in folds if f.ledger is not None]
    led = CostLedger()
    if shared and leds:
        led = leds[0].copy()
    else:
        for fold_led in leds:
            led.merge(fold_led)
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

    # -- shared serve-side helpers --------------------------------- #
    def _sweep_cfg(self, item: WorkItem) -> SolverConfig:
        """Solver config of a CV sweep (``tol_coarse`` continuation)."""
        tc = getattr(item.spec, "tol_coarse", None)
        return (self.config.solver if tc is None
                else dataclasses.replace(self.config.solver, tol=tc))

    @staticmethod
    def _path_request(spec, problem, grid, tol=None, priority=0,
                      deadline=None):
        """The serve path protocol's request for one instance (one
        construction for both serve backends).  ``tol`` is the
        per-request tolerance of a coarse CV sweep — honoured by the
        continuous engine; the wave backend reaches it through a
        per-config engine instead."""
        from repro_torch.serve.pathstate import PathRequest
        return PathRequest(
            A=_host(problem.data["A"]).astype(np.float32),
            b=_host(problem.data["b"]).astype(np.float32),
            lambdas=grid, n_points=spec.n_points,
            lam_min_ratio=spec.lam_min_ratio,
            block_size=int(problem.block_size), warm=spec.warm,
            screen=spec.screen, kkt_slack=spec.kkt_slack, tol=tol,
            priority=priority, deadline=deadline)

    # -- shared validation helpers --------------------------------- #
    def _require_registry_family(self, item: WorkItem) -> None:
        if item.family is None:
            raise UnsupportedWorkloadError(
                f"the {self.name!r} backend serves registered problem "
                "families only (its payload is the raw family data "
                "arrays); ad-hoc or mixed-family problems run on the "
                "'inline' backend")

    def _require_flexa_solo(self, item: WorkItem) -> None:
        spec = item.spec
        if spec.method != "flexa" or spec.options:
            raise UnsupportedWorkloadError(
                f"the {self.name!r} backend executes the paper's FLEXA "
                f"solver; method={spec.method!r} with options="
                f"{spec.options!r} runs on the 'inline' backend")

    def _require_serveable_path(self, item: WorkItem) -> None:
        self._require_registry_family(item)
        if item.family not in SERVE_PATH_FAMILIES:
            raise UnsupportedWorkloadError(
                f"the serve-side path protocol covers the quadratic "
                f"screenable families {SERVE_PATH_FAMILIES}; family "
                f"{item.family!r} paths run on the 'inline' backend")
        spec = item.spec
        if getattr(spec, "lam_batch", 1) != 1:
            raise UnsupportedWorkloadError(
                "lam_batch chunking is an inline-backend feature (the "
                "serving engines admit paths point by point)")
        if spec.tol_schedule is not None:
            raise UnsupportedWorkloadError(
                "per-point tol_schedule is an inline-backend feature; "
                "serve backends support the tol_coarse continuation "
                "(CVSpec) instead")
        if getattr(spec, "compact", False):
            raise UnsupportedWorkloadError(
                "compact active-set packing is an inline-backend path "
                "feature (the serve engines compact at the slab level "
                "via ServeConfig.compact_drain instead)")


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
            f"backend {config.backend!r} is not yet ported to repro_torch "
            f"(ROADMAP Queue 1 step 12); available: "
            f"{available_backends()}")
    if config.backend == "remote" and "remote" not in _BACKENDS:
        # The remote backend lives in its own package (repro_torch.remote)
        # so the client core never imports networking code; load it on
        # first use — the import registers the backend.
        import repro_torch.remote.backend  # noqa: F401
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
            res = _solver_batch_result(r, item, self.name)
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
                          ledger=_cv_ledger(folds, resolve_led,
                                            shared=True))


# ------------------------------------------------------------------ #
# Serve-side path jobs (wave backend)                                #
# ------------------------------------------------------------------ #
class _PathJob:
    """One path/cv ticket driven through wave submissions: one
    :class:`PathState` per fold; each wave round submits the live folds'
    current requests together (one signature, one bucket) and feeds the
    responses back until every fold is done."""

    def __init__(self, item: WorkItem, grid, device):
        from repro_torch.serve.pathstate import PathState
        self.item = item
        self.states = [
            PathState(i, Backend._path_request(item.spec, p, grid),
                      device=device)
            for i, p in enumerate(item.problems)]
        self.pending_req = [st.next_request() for st in self.states]
        self.resolving = False          # cv winner re-solve in flight
        self.winner_resps: list = []
        self.folds = None
        self.select = None

    @property
    def done(self) -> bool:
        return all(st.done for st in self.states)


@register_backend
class WaveBackend(Backend):
    """Buffered wave dispatch over :class:`SolverServeEngine`.

    ``submit`` only buffers; each ``step`` packs everything admissible —
    buffered solos and batches plus every in-flight path's current
    λ-point — into one engine wave per solver config.  ``run`` /
    ``result`` step until the ticket completes.
    """

    name = "wave"

    def __init__(self, config, telemetry):
        super().__init__(config, telemetry)
        self._engines: dict[SolverConfig, object] = {}
        self._queue: list[tuple[WorkItem, object]] = []
        self._jobs: dict[int, _PathJob] = {}
        self._ticket_rids: dict[int, list[int]] = {}

    def request_ids(self, ticket: int) -> list[int]:
        return list(self._ticket_rids.get(ticket, []))

    def _engine(self, cfg: SolverConfig):
        eng = self._engines.get(cfg)
        if eng is None:
            from repro_torch.serve.engine import SolverServeEngine
            with internal_use():
                eng = SolverServeEngine(cfg, self.config.serve,
                                        telemetry=self.telemetry,
                                        device=self.device)
            self._engines[cfg] = eng
        return eng

    def validate(self, item: WorkItem) -> None:
        if item.kind == "solo":
            self._require_flexa_solo(item)
            self._require_registry_family(item)
        elif item.kind == "batch":
            self._require_registry_family(item)
            if item.spec.record_history:
                raise UnsupportedWorkloadError(
                    "record_history is an inline-backend feature (the "
                    "serving engines never sync per iteration)")
        else:
            self._require_serveable_path(item)

    def submit(self, item: WorkItem, arrival=None) -> list[int]:
        if item.kind in ("solo", "batch"):
            self._queue.append((item, arrival))
        else:
            grid = (_resolve_cv_grid(item) if item.kind == "cv"
                    else item.spec.lambdas)
            self._jobs[item.ticket] = _PathJob(item, grid, self.device)
        return []

    @property
    def pending(self) -> int:
        return len(self._queue) + len(self._jobs)

    def step(self) -> list[int]:
        """One wave round: everything admissible rides one submission
        per solver config (a coarse-tol sweep and full-tol work each have
        their own engine)."""
        waves: dict[SolverConfig, list] = {}

        def enqueue(cfg, req, arrival, route):
            waves.setdefault(cfg, []).append((req, arrival, route))

        queue, self._queue = self._queue, []
        for item, arrival in queue:
            if item.kind == "solo":
                enqueue(self.config.solver,
                        solve_request_of(item.problems[0],
                                         x0=item.spec.x0),
                        arrival, ("solo", item, 0))
            else:
                x0, act = item.spec.x0, item.spec.active
                for i, p in enumerate(item.problems):
                    enqueue(self.config.solver, solve_request_of(
                        p, x0=None if x0 is None else x0[i],
                        active=None if act is None else act[i]),
                        arrival, ("batch", item, i))
        for job in self._jobs.values():
            cfg = (self.config.solver if job.resolving
                   else self._sweep_cfg(job.item))
            for i, req in enumerate(job.pending_req):
                if req is not None:
                    enqueue(cfg, req, None, ("path", job, i))

        done = []
        partial: dict[int, dict] = {}       # batch ticket -> responses
        for cfg, entries in waves.items():
            reqs = [e[0] for e in entries]
            now = self.telemetry.now()
            arrivals = [now if e[1] is None else e[1] for e in entries]
            eng = self._engine(cfg)
            resps = eng.submit(reqs, arrivals=arrivals)
            for (req, _, route), resp, rid in zip(entries, resps,
                                                  eng.last_request_ids):
                kind, obj, i = route
                tkt = obj.item.ticket if kind == "path" else obj.ticket
                self._ticket_rids.setdefault(tkt, []).append(int(rid))
                if kind == "solo":
                    self._results[obj.ticket] = _solo_result(
                        resp, self.name, obj.problems[0])
                    done.append(obj.ticket)
                elif kind == "batch":
                    partial.setdefault(obj.ticket,
                                       {"item": obj, "resps": {}})[
                        "resps"][i] = resp
                elif obj.resolving:
                    obj.winner_resps[i] = resp
                    obj.pending_req[i] = None
                else:
                    obj.pending_req[i] = obj.states[i].on_completion(resp)

        for ticket, rec in partial.items():
            item, resps = rec["item"], rec["resps"]
            self._results[ticket] = _batch_result(
                [resps[i] for i in range(len(item.problems))], self.name,
                item.problems)
            done.append(ticket)

        for ticket in list(self._jobs):
            job = self._jobs[ticket]
            if job.resolving:
                if all(r is not None for r in job.winner_resps):
                    x_best = np.stack([np.asarray(r.x)
                                       for r in job.winner_resps])
                    self._results[ticket] = _finish_cv(
                        job.item, job.folds, self.name, x_best, job.select,
                        meta={"mode": "wave"},
                        ledger=_cv_ledger(job.folds, _request_ledger(
                            [r.iters for r in job.winner_resps],
                            job.item.problems)))
                    del self._jobs[ticket]
                    done.append(ticket)
                continue
            if not job.done:
                continue
            folds = [_path_result_from_serve(job.item.problems[i],
                                             st.result(), self.name)
                     for i, st in enumerate(job.states)]
            if job.item.kind == "path":
                self._results[ticket] = folds[0]
                del self._jobs[ticket]
                done.append(ticket)
                continue
            select = _cv_select(job.item, folds)
            if select["best_index"] is not None \
                    and job.item.spec.tol_coarse is not None:
                # Phase 2: the full-tol winner re-solve as one more wave.
                job.resolving = True
                job.folds, job.select = folds, select
                best = select["best_index"]
                probs = _winner_problems(job.item.problems,
                                         select["best_lambda"])
                job.pending_req = [
                    solve_request_of(p, x0=folds[i].x[best])
                    for i, p in enumerate(probs)]
                job.winner_resps = [None] * len(probs)
            else:
                self._results[ticket] = _finish_cv(
                    job.item, folds, self.name, None, select,
                    meta={"mode": "wave"},
                    ledger=_cv_ledger(folds, None))
                del self._jobs[ticket]
                done.append(ticket)
        return done

    def stats(self) -> dict:
        return {**super().stats(),
                "engines": [dict(eng.stats)
                            for eng in self._engines.values()]}


# ------------------------------------------------------------------ #
# Continuous backend                                                 #
# ------------------------------------------------------------------ #
class _ContTicket:
    """Per-ticket progress over the continuous engine."""

    def __init__(self, item: WorkItem):
        self.item = item
        self.req_ids: list[int] = []        # solo/batch requests
        self.path_ids: list[int] = []       # path/cv paths
        self.phase = "run"                  # "run" | "resolve"
        self.folds = None
        self.select = None
        self.resolve_ids: list[int] = []


@register_backend
class ContinuousBackend(Backend):
    """Slot-slab continuous batching over :class:`ContinuousSolverEngine`
    — admit on submit, advance on ``step``, results as slots finish.

    One engine serves everything this backend runs: a CV coarse sweep
    submits its path requests with ``tol=tol_coarse`` and shares slots
    with full-accuracy traffic (slabs carry a per-slot tolerance).
    """

    name = "continuous"

    def __init__(self, config, telemetry):
        super().__init__(config, telemetry)
        self._eng = None
        self._live: dict[int, _ContTicket] = {}
        self._done: dict[int, _ContTicket] = {}     # diagnostics feed

    def _engine(self):
        if self._eng is None:
            from repro_torch.serve.continuous import ContinuousSolverEngine
            with internal_use():
                self._eng = ContinuousSolverEngine(
                    self.config.solver, self.config.serve,
                    telemetry=self.telemetry, device=self.device)
        return self._eng

    validate = WaveBackend.validate

    def submit(self, item: WorkItem, arrival=None) -> list[int]:
        rec = _ContTicket(item)
        eng = self._engine()
        pr, dl = item.priority, item.deadline
        if item.kind == "solo":
            rec.req_ids = [eng.submit(
                solve_request_of(item.problems[0], x0=item.spec.x0,
                                 priority=pr, deadline=dl),
                arrival=arrival)]
        elif item.kind == "batch":
            x0, act = item.spec.x0, item.spec.active
            rec.req_ids = [eng.submit(solve_request_of(
                p, x0=None if x0 is None else x0[i],
                active=None if act is None else act[i],
                priority=pr, deadline=dl),
                arrival=arrival) for i, p in enumerate(item.problems)]
        else:
            spec = item.spec
            grid = (_resolve_cv_grid(item) if item.kind == "cv"
                    else spec.lambdas)
            tol = getattr(spec, "tol_coarse", None)
            rec.path_ids = [eng.submit_path(
                self._path_request(spec, p, grid, tol=tol,
                                   priority=pr, deadline=dl),
                arrival=arrival)
                for p in item.problems]
        self._live[item.ticket] = rec
        return []

    @property
    def pending(self) -> int:
        return len(self._live)

    def step(self) -> list[int]:
        if self._eng is not None and self._eng.pending:
            self._eng.step()
        done = []
        for ticket in list(self._live):
            result = self._advance(self._live[ticket])
            if result is not None:
                self._results[ticket] = result
                self._done[ticket] = self._live.pop(ticket)
                done.append(ticket)
        return done

    def expire_overdue(self, now: float | None = None) -> list[int]:
        """The engine's deadline sweep; returns the expired request ids.
        Their tickets complete (with ``status="timeout"`` entries) on the
        next :meth:`step`."""
        if self._eng is None:
            return []
        return self._eng.expire_overdue(now)

    def request_ids(self, ticket: int) -> list[int]:
        rec = self._live.get(ticket) or self._done.get(ticket)
        if rec is None:
            return []
        ids = list(rec.req_ids)
        for pid in rec.path_ids:
            ids.extend(self._engine().path_result(pid)["req_ids"])
        ids.extend(rec.resolve_ids)
        return ids

    def _advance(self, rec: _ContTicket):
        item = rec.item
        eng = self._engine()
        if item.kind in ("solo", "batch"):
            resps = [eng.responses.get(r) for r in rec.req_ids]
            if any(r is None for r in resps):
                return None
            if item.kind == "solo":
                return _solo_result(resps[0], self.name, item.problems[0])
            return _batch_result(resps, self.name, item.problems)

        if rec.phase == "run":
            results = [eng.path_result(pid) for pid in rec.path_ids]
            if not all(r["done"] for r in results):
                return None
            folds = [_path_result_from_serve(item.problems[i],
                                             results[i], self.name)
                     for i in range(len(results))]
            if item.kind == "path":
                return folds[0]
            select = _cv_select(item, folds)
            if select["best_index"] is None \
                    or item.spec.tol_coarse is None:
                return _finish_cv(item, folds, self.name, None, select,
                                  meta={"mode": "continuous"},
                                  ledger=_cv_ledger(folds, None))
            # Phase 2: the winner re-solve at the engine's (full)
            # tolerance — same engine, the requests just omit tol.
            rec.phase, rec.folds, rec.select = "resolve", folds, select
            best = select["best_index"]
            probs = _winner_problems(item.problems, select["best_lambda"])
            rec.resolve_ids = [eng.submit(solve_request_of(
                p, x0=folds[i].x[best])) for i, p in enumerate(probs)]
            return None
        resps = [eng.responses.get(r) for r in rec.resolve_ids]
        if any(r is None for r in resps):
            return None
        x_best = np.stack([np.asarray(r.x) for r in resps])
        return _finish_cv(item, rec.folds, self.name, x_best,
                          rec.select, meta={"mode": "continuous"},
                          ledger=_cv_ledger(rec.folds, _request_ledger(
                              [r.iters for r in resps], item.problems)))

    def stats(self) -> dict:
        return {**super().stats(), "pending": self.pending,
                "queued": 0 if self._eng is None else self._eng.queued}
