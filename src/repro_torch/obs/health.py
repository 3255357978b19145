"""Numerical-health watchdog contract + NaN-safe comparison helpers (a
host copy of ``repro.obs.health``).

The device-side watchdog lives in the chunk stepper
(``repro_torch.solvers.batched.make_chunk_stepper``); this module holds
its contract:

* per-slot **non-finite detection** — ``isfinite`` over the iterate
  ``x``, V and the termination stat ``‖x̂(x)−x‖∞`` at every chunk end;
* per-slot **stall detection** — a counter that increments each chunk
  the stat fails to decrease and quarantines after
  ``HealthConfig.stall_window`` consecutive non-decreasing chunks;
* one fused per-slot verdict that rides the one-per-tick ``(S,)``
  readback (the boolean stop mask widens to an int32 status vector).

The verdicts read the iteration's outputs and never feed back into its
arithmetic, so a healthy workload is bitwise the same with the watchdog
on or off.

The comparison helpers take numpy arrays or tensors (a tensor is copied
to the host first).  Host-side and numpy-only otherwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "STATUS_RUNNING", "STATUS_STOPPED", "STATUS_DIVERGED",
    "STATUS_STALLED", "STATUS_LABELS", "HealthConfig", "SolveFailure",
    "allclose_or_both_nonfinite", "assert_finite_close", "bitwise_equal",
]

#: Per-slot chunk verdict codes of the watchdog-enabled chunk stepper.
#: RUNNING/STOPPED mirror the boolean stop mask; DIVERGED/STALLED are the
#: quarantine verdicts.
STATUS_RUNNING = 0
STATUS_STOPPED = 1
STATUS_DIVERGED = 2
STATUS_STALLED = 3

#: Quarantine verdict code → the ``status`` string carried on
#: ``SolveResponse`` / client results / request traces.  Codes not in
#: this map are healthy completions (``status="ok"``).
STATUS_LABELS = {STATUS_DIVERGED: "diverged", STATUS_STALLED: "stalled"}


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Watchdog knobs (hashable)."""

    #: Stall patience H: a slot is quarantined as ``"stalled"`` once its
    #: termination stat has failed to decrease for H consecutive chunks.
    #: The first chunk after admission always counts as a decrease
    #: (previous stat +inf), so quarantine lands within H+1 chunks.
    stall_window: int = 10

    @classmethod
    def of(cls, serve) -> "HealthConfig | None":
        """Build from a ``ServeConfig``; ``None`` when the watchdog is
        off."""
        if not getattr(serve, "watchdog", False):
            return None
        return cls(stall_window=int(serve.stall_patience))


@dataclasses.dataclass(frozen=True)
class SolveFailure:
    """Typed quarantine (or timeout) outcome for one request, collected
    on ``ContinuousSolverEngine.failures``."""

    req_id: int
    status: str                 # "diverged" | "stalled" | "timeout"
    iters: int                  # iterations burned before eviction
    stat: float                 # final ‖x̂(x)−x‖∞ (NaN when diverged)
    tick: int | None = None     # engine tick of the eviction


def _host(a) -> np.ndarray:
    """``a`` as a numpy array (a tensor is copied off its device)."""
    if hasattr(a, "detach") and hasattr(a, "cpu"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def bitwise_equal(a, b) -> bool:
    """True iff two arrays are byte-identical (dtype, shape and every bit
    of every element — NaN payloads included)."""
    a = _host(a)
    b = _host(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def allclose_or_both_nonfinite(a, b, rtol: float = 1e-5,
                               atol: float = 1e-8) -> bool:
    """``np.allclose`` that treats matching non-finite entries as equal.

    Finite entries must agree to ``rtol``/``atol``; NaNs must sit at the
    same positions on both sides; infinities must match exactly
    (position and sign).  Shape mismatch is unequal, never an error.
    """
    a = _host(a)
    b = _host(b)
    if a.shape != b.shape:
        return False
    fa = np.isfinite(a)
    fb = np.isfinite(b)
    if not np.array_equal(fa, fb):
        return False
    na = np.isnan(a)
    if not np.array_equal(na, np.isnan(b)):
        return False
    inf = ~fa & ~na
    if inf.any() and not np.array_equal(a[inf], b[inf]):
        return False
    return bool(np.allclose(a[fa], b[fb], rtol=rtol, atol=atol))


def assert_finite_close(a, b, rtol: float = 1e-5, atol: float = 1e-8,
                        context: str = "") -> None:
    """Assert ``allclose_or_both_nonfinite`` with a diagnostic message
    (where the arrays disagree: non-finite pattern or finite drift)."""
    a = _host(a)
    b = _host(b)
    prefix = f"{context}: " if context else ""
    if a.shape != b.shape:
        raise AssertionError(
            f"{prefix}shape mismatch {a.shape} vs {b.shape}")
    fa = np.isfinite(a)
    fb = np.isfinite(b)
    if not np.array_equal(fa, fb):
        raise AssertionError(
            f"{prefix}non-finite pattern mismatch "
            f"({int((~fa).sum())} vs {int((~fb).sum())} non-finite "
            f"entries at differing positions)")
    na = np.isnan(a)
    if not np.array_equal(na, np.isnan(b)):
        raise AssertionError(f"{prefix}NaN/inf pattern mismatch")
    inf = ~fa & ~na
    if inf.any() and not np.array_equal(a[inf], b[inf]):
        raise AssertionError(f"{prefix}infinity sign mismatch")
    if not np.allclose(a[fa], b[fb], rtol=rtol, atol=atol):
        dev = np.abs(a[fa] - b[fb])
        raise AssertionError(
            f"{prefix}finite entries deviate: max |Δ|={dev.max():.3e} "
            f"(rtol={rtol}, atol={atol})")
