"""Safe screening for the λ-path: sequential strong rules + KKT recheck.

Strong rules (Tibshirani et al., *Strong rules for discarding predictors
in lasso-type problems*, JRSS-B 2012) discard a block g at the new weight
c_new using only the solution at the previous weight c_prev:

    discard g   if   score_g(x(c_prev))  <  2·c_new − c_prev,

where ``score_g`` is the family's dual-correlation bound
(``ProblemFamily.screen_scores``: |∇_g F| for ℓ1, ‖∇_g F‖₂ for group-ℓ2).
The rule assumes the score is 1-Lipschitz in c (the "unit slope"
heuristic) — it is *almost* always right but not safe, so every screened
solve is followed by a **KKT recheck** over the discarded blocks:

    violated g  if   score_g(x̂_screened)  >  c·(1 + slack)

Violators are re-admitted to the active set and the point is re-solved
(warm-started from the screened solution); the loop repeats until no
violations remain, so the *final* solution of every path point is exact —
the strong rule only ever changes how much work convergence takes, never
the answer.  (A block that is nonzero in the warm start is never
discarded: by KKT its previous score equals c_prev > 2·c_new − c_prev on
a decreasing grid, but we also enforce it explicitly so fp32 rounding
cannot slip one through.)

Masks are per-*coordinate* {0,1} float arrays (what the solver's
freeze-mask injection consumes — ``flexa_iteration(active=...)``); blocks
expand with ``np.repeat``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.problems.base import Problem
from repro_torch.problems.families import ProblemFamily

#: Default relative KKT slack: scores are fp32 and the solver stops at
#: ‖x̂−x‖∞ ≤ tol, so exact-boundary scores land within a small band of c.
#: Too tight only costs a spurious re-admission round; too loose could
#: leave a genuinely active block frozen — so keep it small.
DEFAULT_KKT_SLACK = 1e-4


@dataclass
class ScreenReport:
    """What screening did at one path point (for PathResult bookkeeping)."""
    n_blocks: int
    screened_out: int           # blocks frozen by the strong rule
    kkt_rounds: int = 0         # re-solve rounds triggered by violations
    violations: int = 0         # total blocks re-admitted by the recheck


def block_scores(fam: ProblemFamily, problem: Problem,
                 x) -> np.ndarray:
    """Per-block screening scores of ``x`` under the family hook."""
    if fam.screen_scores is None:
        raise ValueError(
            f"family {fam.name!r} has no screening hook "
            "(ProblemFamily.screen_scores is None)")
    x = torch.as_tensor(x, dtype=torch.float32).to(problem.device)
    grad = problem.grad_f(x)
    return fam.screen_scores(grad, problem.block_size).cpu().numpy(
        ).astype(np.float64)


def strong_rule_active(scores_prev: np.ndarray, c_new: float,
                       c_prev: float,
                       warm_block_norms: np.ndarray | None = None
                       ) -> np.ndarray:
    """Per-block {0,1} active mask for c_new given scores at c_prev.

    Keeps block g iff ``scores_prev[g] ≥ 2·c_new − c_prev`` — plus every
    block that is nonzero in the warm start (``warm_block_norms``), which
    the rule provably keeps anyway on a decreasing grid but which we pin
    explicitly against fp32 rounding at the threshold.
    """
    if c_new >= c_prev:
        raise ValueError(
            f"sequential strong rule needs c_new < c_prev "
            f"(got {c_new} >= {c_prev})")
    keep = scores_prev >= (2.0 * c_new - c_prev)
    if warm_block_norms is not None:
        keep = keep | (np.asarray(warm_block_norms) > 0)
    return keep.astype(np.float64)


def kkt_violations(scores: np.ndarray, active_blocks: np.ndarray,
                   c: float, slack: float = DEFAULT_KKT_SLACK
                   ) -> np.ndarray:
    """Screened-out blocks whose score exceeds the KKT bound at weight c.

    Returns a {0,1} per-block mask of violators: blocks currently frozen
    (``active_blocks == 0``) with ``score > c·(1 + slack)``.  Active
    blocks are the solver's responsibility (it drove their stationarity
    below tol); frozen blocks are exactly what the recheck certifies.
    """
    frozen = np.asarray(active_blocks) == 0
    return (frozen & (scores > c * (1.0 + slack))).astype(np.float64)


def expand_blocks(mask_b: np.ndarray, block_size: int) -> np.ndarray:
    """Per-block {0,1} mask -> per-coordinate float32 mask."""
    m = np.asarray(mask_b, np.float32)
    if block_size == 1:
        return m
    return np.repeat(m, block_size)
