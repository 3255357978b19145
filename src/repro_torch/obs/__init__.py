"""Observability host copies, as in ``repro.obs``: the span tracer
(``trace``), the stack-wide cost ledger (``ledger``), the live ops view
(``dashboard``: ``python -m repro_torch.obs.dashboard``), the
numerical-health watchdog contract (``health``), sliding SLO windows
(``windows``) and the perf-history tracker (``history``:
``python -m repro_torch.obs.history``)."""
from repro_torch.obs.dashboard import (render_requests, render_snapshot,
                                       sparkline)
from repro_torch.obs.health import (HealthConfig, SolveFailure,
                                    allclose_or_both_nonfinite,
                                    assert_finite_close, bitwise_equal)
from repro_torch.obs.ledger import LEDGER_KEYS, CostLedger
from repro_torch.obs.trace import (Span, Tracer, get_tracer, instant,
                                   set_tracer, span, tracing)
from repro_torch.obs.windows import MetricWindows, SlidingWindow

__all__ = [
    "CostLedger",
    "HealthConfig",
    "LEDGER_KEYS",
    "MetricWindows",
    "SlidingWindow",
    "SolveFailure",
    "Span",
    "Tracer",
    "allclose_or_both_nonfinite",
    "assert_finite_close",
    "bitwise_equal",
    "get_tracer",
    "instant",
    "render_requests",
    "render_snapshot",
    "set_tracer",
    "span",
    "sparkline",
    "tracing",
]
