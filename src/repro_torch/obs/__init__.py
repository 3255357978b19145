"""Observability host copies: the span tracer (``trace``) and the
stack-wide cost ledger (``ledger``), as in ``repro.obs``."""
from repro_torch.obs.ledger import LEDGER_KEYS, CostLedger
from repro_torch.obs.trace import Tracer, get_tracer, set_tracer, tracing

__all__ = ["CostLedger", "LEDGER_KEYS", "Tracer", "get_tracer",
           "set_tracer", "tracing"]
