"""The one result/history contract every solver of the port returns.

Same fields as ``repro.core.result.SolverResult``: ``x`` (``(n,)`` or
``(B, n)`` tensor), ``iters``, ``converged``, a per-iteration ``history``
dict (``V``, ``stat``, ``time``, and FLEXA's ``E_max`` / ``sel_frac`` /
``gamma`` / ``tau_scale``; empty for drivers that never leave the
device), ``state``, ``method`` and ``meta``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class SolverResult:
    x: Any
    iters: Any
    converged: Any
    history: dict = field(default_factory=dict)
    state: Any = None
    method: str = ""
    meta: dict = field(default_factory=dict)
    status: str = "ok"

    def rel_error(self, v_star: float) -> float:
        """Relative objective error vs a known optimum (benchmark metric)."""
        if not self.history.get("V"):
            raise ValueError("no history recorded (compiled driver?)")
        return (self.history["V"][-1] - v_star) / v_star
