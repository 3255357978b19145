"""Sliding-window SLO aggregation over the injectable clock (a host copy
of ``repro.obs.windows``).

Each metric keeps the last ``horizon`` seconds of ``(t, value)`` samples
and reports count / rate / mean / p50 / p99 / max per window, with
``None`` percentiles on an empty window (the convention of
``repro_torch.serve.metrics.percentile``).

Windows are opt-in (``ServeTelemetry(window_s=...)``): feeding them
costs extra clock reads.  Wired metrics: ``latency`` and ``queue_wait``
(one sample per completion), ``occupancy`` (live/capacity, one per
chunk), ``completions`` (its ``rate`` is completions/s),
``health_events`` and ``timeouts``.
"""
from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["SlidingWindow", "MetricWindows"]


def _percentile(values, q: float):
    # The convention of repro_torch.serve.metrics.percentile, kept here
    # so this module stays a leaf.
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


class SlidingWindow:
    """Ring buffer of ``(t, value)`` samples pruned to a time horizon.

    ``maxlen`` bounds memory on pathological feed rates; the oldest
    samples drop first, as horizon pruning would.
    """

    def __init__(self, horizon: float, maxlen: int = 4096):
        if horizon <= 0:
            raise ValueError(f"horizon must be positive, got {horizon}")
        self.horizon = float(horizon)
        self._buf: deque = deque(maxlen=int(maxlen))

    def __len__(self) -> int:
        return len(self._buf)

    def add(self, t: float, value: float) -> None:
        self._buf.append((float(t), float(value)))
        self._prune(t)

    def _prune(self, now: float) -> None:
        cutoff = float(now) - self.horizon
        buf = self._buf
        while buf and buf[0][0] <= cutoff:
            buf.popleft()

    def values(self, now: float) -> list:
        self._prune(now)
        return [v for _, v in self._buf]

    def stats(self, now: float) -> dict:
        """Window summary at time ``now``.  Empty window → count 0,
        rate 0.0, and ``None`` for mean/percentiles/max."""
        vals = self.values(now)
        n = len(vals)
        return {
            "count": n,
            "rate": n / self.horizon,
            "mean": sum(vals) / n if n else None,
            "p50": _percentile(vals, 50.0),
            "p99": _percentile(vals, 99.0),
            "max": max(vals) if n else None,
        }


class MetricWindows:
    """A named family of :class:`SlidingWindow` s sharing one horizon."""

    def __init__(self, horizon: float, maxlen: int = 4096):
        self.horizon = float(horizon)
        self.maxlen = int(maxlen)
        self._windows: dict = {}

    def window(self, name: str) -> SlidingWindow:
        w = self._windows.get(name)
        if w is None:
            w = self._windows[name] = SlidingWindow(
                self.horizon, maxlen=self.maxlen)
        return w

    def add(self, name: str, t: float, value: float) -> None:
        self.window(name).add(t, value)

    def snapshot(self, now: float) -> dict:
        """``{"window_s": horizon, <metric>: stats, ...}`` for every
        metric that has received a sample."""
        out = {"window_s": self.horizon}
        for name in sorted(self._windows):
            out[name] = self._windows[name].stats(now)
        return out
