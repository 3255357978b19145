"""Typed workload specs and the one internal :class:`WorkItem` they
normalize onto (a port of ``repro.client.specs``).

Ported kinds: :class:`SoloSpec` (one instance, any registered method)
and :class:`PathSpec` (a warm-started, screened λ-path, optionally
compacted).  :class:`BatchSpec`, :class:`CVSpec` and
:func:`solve_request_of` are not ported yet and raise
:class:`~repro_torch.client.errors.NotPortedError`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.client.errors import NotPortedError, SpecError
from repro_torch.obs.ledger import CostLedger
from repro_torch.path.screening import DEFAULT_KKT_SLACK
from repro_torch.problems.base import Problem
from repro_torch.problems.families import get_family, infer_family

KINDS = ("solo", "path")


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


class BatchSpec:
    """Not yet ported: B same-signature instances in one solve."""

    def __init__(self, *args, **kwargs):
        raise NotPortedError("BatchSpec is not yet ported to repro_torch")


class CVSpec:
    """Not yet ported: K folds swept down one λ-grid."""

    def __init__(self, *args, **kwargs):
        raise NotPortedError("CVSpec is not yet ported to repro_torch")


def solve_request_of(*args, **kwargs):
    """Not yet ported: the serve-engine payload of a problem."""
    raise NotPortedError("SolveRequest (the serving engines) is not yet "
                         "ported to repro_torch")


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
    """What a backend executes: kind + validated spec + derived facts."""
    ticket: int
    kind: str                       # one of KINDS
    spec: object
    problems: list
    family: str | None              # registry family, None for ad-hoc F


def _family_of(problem: Problem) -> str | None:
    try:
        family = infer_family(problem)
    except ValueError:
        return None
    missing = [k for k in get_family(family).data_keys
               if k not in problem.data]
    return None if missing else family


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
    raise SpecError(
        f"unknown workload spec {type(spec).__name__!r}; expected "
        "SoloSpec or PathSpec")
