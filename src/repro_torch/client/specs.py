"""Typed workload specs and the one internal :class:`WorkItem` they
normalize onto (a port of ``repro.client.specs``).

Ported kinds, one spec each: :class:`SoloSpec` (one instance, any
registered method), :class:`BatchSpec` (B same-signature instances in
one lockstep solve), :class:`PathSpec` (a warm-started, screened λ-path,
optionally compacted) and :class:`CVSpec` (K folds down one λ-grid,
optionally scored and λ-selected, with coarse-to-fine tol continuation).
Results: :class:`SoloResult`, :class:`BatchResult`,
:class:`~repro_torch.path.driver.PathResult`, :class:`CVResult` —
identical fields whichever backend ran the work.  :func:`solve_request_of`
is the serving engines' payload of a problem.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.client.errors import SpecError
from repro_torch.obs.ledger import CostLedger
from repro_torch.path.screening import DEFAULT_KKT_SLACK
from repro_torch.problems.base import Problem
from repro_torch.problems.families import get_family, infer_family
from repro_torch.serve.engine import SolveRequest

KINDS = ("solo", "batch", "path", "cv")

#: Families the serve-side path protocol (``repro_torch.serve.pathstate``)
#: supports: the screenable quadratic ones with an (A, b) payload.
SERVE_PATH_FAMILIES = ("lasso", "group_lasso")


@dataclass
class SoloSpec:
    """One composite-minimization instance, any registered method."""
    problem: Problem
    method: str = "flexa"
    x0: np.ndarray | None = None
    options: dict = field(default_factory=dict)


@dataclass
class PathSpec:
    """A warm-started, strong-rule-screened regularization path."""
    problem: Problem
    lambdas: object = None              # explicit decreasing grid or None
    n_points: int = 20
    lam_min_ratio: float = 0.01
    warm: bool = True
    screen: bool = True
    kkt_slack: float = DEFAULT_KKT_SLACK
    lam_batch: int = 1                  # λ-chunking
    tol_schedule: object = None         # per-point stopping tolerances
    compact: bool = False               # capacity-bucketed active-set
                                        # packing (needs screen=True)


@dataclass
class BatchSpec:
    """B independent instances sharing one shape signature."""
    problems: Sequence[Problem] = ()
    x0: np.ndarray | None = None        # (B, n) warm starts
    active: np.ndarray | None = None    # (B, n) freeze masks
    record_history: bool = False        # host-stepped driver


@dataclass
class CVSpec:
    """K folds swept down one shared λ-grid, optionally scored.

    Scoring: ``score(fold_index, lambda_index, x) -> float`` (lower is
    better), or ``validation`` — a list of K ``(A_val, b_val)`` pairs
    scored by mean squared error (the quadratic-family default).  With
    neither, the result is a pure lockstep fold sweep (``best_*`` fields
    are ``None``).

    ``tol_coarse`` is the continuation knob: the sweep runs at this
    loose tolerance and only the *selected* λ is re-solved at the full
    ``SolverConfig.tol`` (warm-started from the coarse winner).  It needs
    scoring, and excludes an explicit ``tol_schedule``.
    """
    problems: Sequence[Problem] = ()
    lambdas: object = None
    n_points: int = 20
    lam_min_ratio: float = 0.01
    warm: bool = True
    screen: bool = True
    kkt_slack: float = DEFAULT_KKT_SLACK
    tol_schedule: object = None         # sweep schedule (advanced)
    tol_coarse: float | None = None     # coarse sweep + full-tol winner
    score: Callable | None = None       # (i_fold, i_lambda, x) -> float
    validation: Sequence | None = None  # K (A_val, b_val) pairs


def solve_request_of(problem: Problem, *, x0=None, active=None,
                     priority: int = 0,
                     deadline: float | None = None) -> SolveRequest:
    """The serve-engine payload of a registry-family :class:`Problem`:
    its data as host fp32 arrays (copied off the card if they live
    there).  The leading family array rides in ``SolveRequest.A``
    whatever the family calls it; quadratic families add ``b``."""
    family = infer_family(problem)
    keys = get_family(family).data_keys
    arrays = [_host(problem.data[k]).astype(np.float32, copy=False)
              for k in keys]
    return SolveRequest(
        A=arrays[0], b=arrays[1] if len(arrays) > 1 else None,
        c=float(problem.g_weight), block_size=int(problem.block_size),
        family=family,
        x0=None if x0 is None else _host(x0).astype(np.float32),
        active_mask=None if active is None
        else _host(active).astype(np.float32),
        priority=priority, deadline=deadline)


@dataclass
class SoloResult:
    """One solved instance, backend-independent fields first."""
    x: np.ndarray
    iters: int
    converged: bool
    stat: float | None              # final ‖x̂−x‖∞ (None: method w/o it)
    backend: str
    raw: object = None              # the SolverResult
    ledger: CostLedger | None = None
    status: str = "ok"

    @property
    def history(self):
        """Trajectory dict when the executing driver recorded one."""
        h = getattr(self.raw, "history", None)
        return h or {}


@dataclass
class BatchResult:
    """B solved instances (leading axis B everywhere)."""
    x: np.ndarray                   # (B, n)
    iters: np.ndarray               # (B,)
    converged: np.ndarray           # (B,)
    stat: np.ndarray | None         # (B,)
    backend: str
    raw: object = None              # the SolverResult
    ledger: CostLedger | None = None    # batch-wide accounting
    status: list | None = None      # per-instance status

    def __len__(self) -> int:
        return int(self.x.shape[0])


@dataclass
class CVResult:
    """K fold paths + (optionally) the selected λ and its solutions."""
    folds: list                     # K PathResult
    lambdas: np.ndarray             # (P,) shared grid
    backend: str
    scores: np.ndarray | None = None        # (K, P) per-fold scores
    scores_mean: np.ndarray | None = None   # (P,)
    best_index: int | None = None
    best_lambda: float | None = None
    x_best: np.ndarray | None = None        # (K, n) full-tol winners
    meta: dict = field(default_factory=dict)
    ledger: CostLedger | None = None        # sweep accounting


@dataclass
class TicketDiagnostics:
    """Per-request lifecycle view of one client ticket."""
    ticket: int
    kind: str
    backend: str
    done: bool
    requests: list = field(default_factory=list)

    def as_dict(self) -> dict:
        return {"ticket": self.ticket, "kind": self.kind,
                "backend": self.backend, "done": self.done,
                "requests": list(self.requests)}


@dataclass
class WorkItem:
    """What a backend executes: kind + validated spec + derived facts.

    ``priority`` / ``deadline`` are service-policy annotations: the
    continuous backend threads them into every engine request the item
    spawns; the inline and wave backends ignore them.
    """
    ticket: int
    kind: str                       # one of KINDS
    spec: object
    problems: list
    family: str | None              # registry family, None for ad-hoc F
    priority: int = 0
    deadline: float | None = None   # absolute telemetry-clock time


def _family_of(problem: Problem) -> str | None:
    try:
        family = infer_family(problem)
    except ValueError:
        return None
    missing = [k for k in get_family(family).data_keys
               if k not in problem.data]
    return None if missing else family


def _host(a) -> np.ndarray:
    """A host array of ``a`` (a tensor is copied off its device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def mse_score(validation: Sequence) -> Callable:
    """The quadratic-family default scorer: per-fold validation MSE."""
    def score(i_fold: int, i_lambda: int, x) -> float:
        Av, bv = (_host(a) for a in validation[i_fold])
        r = Av @ _host(x) - bv
        return float(r @ r) / Av.shape[0]
    return score


def _multi(spec, ticket: int, kind: str, what: str) -> WorkItem:
    probs = list(spec.problems)
    if not probs:
        raise SpecError(f"{type(spec).__name__} needs at least one {what}")
    fams = {_family_of(p) for p in probs}
    return WorkItem(ticket=ticket, kind=kind, spec=spec, problems=probs,
                    family=fams.pop() if len(fams) == 1 else None)


def normalize(spec, ticket: int) -> WorkItem:
    """Validate a user spec and fold it onto the internal representation
    (raises :class:`SpecError` before any device work)."""
    if isinstance(spec, (SoloSpec, PathSpec)):
        kind = "solo" if isinstance(spec, SoloSpec) else "path"
        if not isinstance(spec.problem, Problem):
            raise SpecError(f"{type(spec).__name__}.problem must be a "
                            f"Problem, got {type(spec.problem).__name__}")
        return WorkItem(ticket=ticket, kind=kind, spec=spec,
                        problems=[spec.problem],
                        family=_family_of(spec.problem))
    if isinstance(spec, BatchSpec):
        return _multi(spec, ticket, "batch", "problem")
    if isinstance(spec, CVSpec):
        if not list(spec.problems):
            raise SpecError("CVSpec needs at least one fold")
        if spec.validation is not None \
                and len(spec.validation) != len(spec.problems):
            raise SpecError(
                f"CVSpec.validation must align with the folds: "
                f"{len(spec.validation)} pairs for {len(spec.problems)} "
                "folds")
        if spec.score is not None and spec.validation is not None:
            raise SpecError("CVSpec.score and CVSpec.validation are "
                            "mutually exclusive scoring routes")
        if spec.tol_coarse is not None and spec.score is None \
                and spec.validation is None:
            raise SpecError(
                "CVSpec.tol_coarse needs a scoring route (score= or "
                "validation=): without a selected λ there is nothing "
                "to re-solve at full tolerance")
        if spec.tol_coarse is not None and spec.tol_schedule is not None:
            raise SpecError(
                "CVSpec.tol_coarse and CVSpec.tol_schedule are mutually "
                "exclusive: an explicit per-point schedule would "
                "silently override the coarse sweep tolerance")
        return _multi(spec, ticket, "cv", "fold")
    raise SpecError(
        f"unknown workload spec {type(spec).__name__!r}; expected one of "
        "SoloSpec / BatchSpec / PathSpec / CVSpec")
