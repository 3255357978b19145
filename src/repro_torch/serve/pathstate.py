"""Engine-agnostic regularization-path state machine for serving (a port
of ``repro.serve.pathstate``).

A :class:`PathRequest` describes a whole λ-path as one serve-level job;
:class:`PathState` turns it into a request generator: ``next_request``
emits the current point as an ordinary :class:`~repro_torch.serve.engine.
SolveRequest` (warm-started from the previous point, strong-rule screened
through ``active_mask``), and ``on_completion`` digests the point's
response — the KKT recheck — and emits either a re-solve of the same
point or the next λ, until the path is done.

The machine does not know which engine runs its requests: the continuous
runtime admits them into its slot slabs point by point, and the client's
wave backend runs them over ``SolverServeEngine`` waves.  The screening
scores are computed on ``device`` (the engine's).

Points at c ≥ λ_max are certified as x = 0 without a request, as the
inline driver (``repro_torch.path.driver``) certifies them.  The
reference's served protocol spends a request on them, and its one
iteration from 0 can leave a coordinate whose |∇F| sits at the threshold
at a rounding residue (2.7e-8 in the reference's CPU run), which the
warm start then carries down the path; certifying keeps a served path
equal to the inline one.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.path.driver import MAX_KKT_ROUNDS
from repro_torch.path.grid import geometric_grid, lambda_max, validate_grid
from repro_torch.path.screening import (DEFAULT_KKT_SLACK, block_scores,
                                        expand_blocks, kkt_violations,
                                        strong_rule_active)
from repro_torch.problems.families import build_problem, get_family
from repro_torch.serve.engine import SolveRequest, SolveResponse


@dataclass
class PathRequest:
    """A whole regularization path as ONE serve-level request.

    The engine admits the path point by point: each λ is a normal
    :class:`SolveRequest` warm-started from the previous point's solution,
    with the sequential strong rule frozen in via ``active_mask`` and a
    KKT recheck on every completion that re-admits violators before the
    path advances.  Between points the path holds no slot.

    ``lambdas`` may be ``None`` (a geometric ``n_points`` ×
    ``lam_min_ratio`` grid from the instance's λ_max) or an explicit
    strictly decreasing grid.  Quadratic families only (lasso /
    group_lasso, the screenable ones with a ``b`` payload).
    """
    A: np.ndarray
    b: np.ndarray
    lambdas: object = None      # explicit decreasing grid, or None
    n_points: int = 20
    lam_min_ratio: float = 0.01
    block_size: int = 1
    warm: bool = True           # warm-start each point from the previous
                                # solution (False: every point starts at
                                # zero; screening still references the
                                # previous solution)
    screen: bool = True
    kkt_slack: float = DEFAULT_KKT_SLACK
    priority: int = 0
    deadline: float | None = None
    #: Per-request stopping tolerance of every point (None = the engine's
    #: ``SolverConfig.tol``): how a coarse CV sweep shares one engine.
    tol: float | None = None

    @property
    def family(self) -> str:
        return "lasso" if self.block_size == 1 else "group_lasso"


class PathState:
    """Engine-side progress of one in-flight :class:`PathRequest`."""

    def __init__(self, path_id: int, preq: PathRequest,
                 device=DEFAULT_DEVICE):
        self.path_id = path_id
        self.preq = preq
        fam = get_family(preq.family)
        if preq.screen and not fam.screenable:
            raise ValueError(
                f"family {preq.family!r} has no screening hook")
        self.fam = fam
        n = int(preq.A.shape[1])
        self.n = n
        self.block_size = int(preq.block_size)
        self.n_blocks = n // self.block_size
        # Template problem at c = 1 (only ``grad_f`` / ``block_norms``
        # are used: λ_max and the screening scores).
        dev = resolve_device(device)
        self.problem = build_problem(
            preq.family,
            tuple(torch.from_numpy(np.array(a, np.float32)).to(dev)
                  for a in (preq.A, preq.b)),
            1.0, n=n, block_size=self.block_size,
            g_kind="l1" if self.block_size == 1 else "group_l2")
        self.lam_max = lambda_max(self.problem)
        if preq.lambdas is None:
            self.grid = geometric_grid(self.lam_max,
                                       n_points=preq.n_points,
                                       lam_min_ratio=preq.lam_min_ratio)
        else:
            self.grid = validate_grid(preq.lambdas)
        P = self.grid.shape[0]
        self.k = 0                              # next/current point index
        self.c_prev = self.lam_max
        self.x_prev = np.zeros(n, np.float32)
        self.scores_prev = block_scores(self.fam, self.problem,
                                        self.x_prev)
        self.active_b = np.ones(self.n_blocks, np.float64)
        self.kkt_rounds = 0
        self.x = np.zeros((P, n), np.float32)
        self.iters = np.zeros(P, np.int64)
        self.converged = np.zeros(P, bool)
        self.screened_out = np.zeros(P, np.int64)
        self.kkt_rounds_per_point = np.zeros(P, np.int64)
        self.req_ids: list[int] = []
        self.done = False

    def _request(self, c: float, x0, mask) -> SolveRequest:
        return SolveRequest(
            A=self.preq.A, b=self.preq.b, c=c, block_size=self.block_size,
            x0=x0, active_mask=mask, priority=self.preq.priority,
            deadline=self.preq.deadline, tol=self.preq.tol)

    def _certify_trivial(self) -> None:
        """Accept every leading point at c ≥ λ_max: its exact solution is
        0 (the definition of λ_max), at 0 iterations.  The scores at 0 do
        not depend on c, so ``scores_prev`` stays valid."""
        P = self.grid.shape[0]
        while self.k < P and \
                self.grid[self.k] >= self.lam_max * (1.0 - 1e-12):
            self.x[self.k] = 0.0
            self.converged[self.k] = True
            self.c_prev = float(self.grid[self.k])
            self.x_prev = np.zeros(self.n, np.float32)
            self.k += 1
        if self.k >= P:
            self.done = True

    def next_request(self) -> SolveRequest | None:
        """The SolveRequest of the current point (index ``k``), screened
        against and warm-started from the previous point's solution; None
        when every remaining point is certified (the path is done)."""
        self._certify_trivial()
        if self.done:
            return None
        ck = float(self.grid[self.k])
        if self.preq.screen and ck < self.c_prev:
            warm_norms = np.linalg.norm(
                self.x_prev.astype(np.float64).reshape(
                    self.n_blocks, self.block_size), axis=-1)
            self.active_b = strong_rule_active(
                self.scores_prev, ck, self.c_prev,
                warm_block_norms=warm_norms)
        else:
            self.active_b = np.ones(self.n_blocks, np.float64)
        self.kkt_rounds = 0
        mask = expand_blocks(self.active_b, self.block_size)
        x_start = (self.x_prev if self.preq.warm
                   else np.zeros(self.n, np.float32))
        return self._request(ck, (x_start * mask).astype(np.float32),
                             mask if self.preq.screen else None)

    def on_completion(self, resp: SolveResponse) -> SolveRequest | None:
        """Digest one finished point; return the follow-up request (a KKT
        re-solve of the same point, or the next λ), None when the path is
        complete."""
        ck = float(self.grid[self.k])
        x_hat = np.asarray(resp.x, np.float32)
        # Scores at the solution (∇F only, λ-independent) are the next
        # point's screening input and this point's KKT evidence.
        scores = block_scores(self.fam, self.problem, x_hat)
        if self.preq.screen:
            viol = kkt_violations(scores, self.active_b, ck,
                                  slack=self.preq.kkt_slack)
            if viol.any():
                self.kkt_rounds += 1
                if self.kkt_rounds >= MAX_KKT_ROUNDS:
                    self.active_b = np.ones(self.n_blocks, np.float64)
                else:
                    self.active_b = np.maximum(self.active_b, viol)
                self.kkt_rounds_per_point[self.k] = self.kkt_rounds
                mask = expand_blocks(self.active_b, self.block_size)
                self.iters[self.k] += int(resp.iters)
                return self._request(ck, (x_hat * mask).astype(np.float32),
                                     mask)
        # Point accepted.
        self.x[self.k] = x_hat
        self.iters[self.k] += int(resp.iters)
        self.converged[self.k] = bool(resp.converged)
        self.screened_out[self.k] = self.n_blocks - int(
            self.active_b.sum())
        self.c_prev = ck
        self.x_prev = x_hat
        self.scores_prev = scores
        self.k += 1
        return self.next_request()

    def result(self) -> dict:
        return {
            "path_id": self.path_id,
            "lambdas": self.grid.copy(),
            "lam_max": float(self.lam_max),
            "x": self.x.copy(),
            "iters": self.iters.copy(),
            "converged": self.converged.copy(),
            "screened_out": self.screened_out.copy(),
            "kkt_rounds": self.kkt_rounds_per_point.copy(),
            "req_ids": list(self.req_ids),
            "done": self.done,
        }
