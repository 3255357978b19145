"""One-shot deprecation warnings for the legacy entry points (a host copy
of ``repro.deprecation``).

``repro_torch.client.FlexaClient`` is the front door to the solver stack;
constructing a serve engine directly still works, but announces itself
ONCE per process with a :class:`FutureWarning` that names the client
call replacing it.  A dependency leaf (stdlib only).

* :func:`warn_legacy` — the one-shot warning for a named entry point
  (no-op on repeat calls and inside :func:`internal_use`);
* :func:`internal_use` — context manager the client backends wrap
  around the engines they construct, so the delegation target never
  warns about itself;
* :func:`reset_warnings` — forget which warnings fired (tests of the
  once-per-process contract).
"""
from __future__ import annotations

import warnings
from contextlib import contextmanager

_warned: set[str] = set()
_suppress_depth: int = 0


def warn_legacy(entry_point: str, replacement: str) -> None:
    """FutureWarning for ``entry_point``, at most once per process.

    ``replacement`` is the client-call spelling (shown verbatim in the
    message).  Calls made under :func:`internal_use` never warn.
    """
    if _suppress_depth or entry_point in _warned:
        return
    _warned.add(entry_point)
    warnings.warn(
        f"{entry_point} is a legacy entry point; use {replacement} "
        "(see docs/client.md for the migration table). "
        "This shim keeps delegating, so behaviour is unchanged.",
        FutureWarning, stacklevel=3)


@contextmanager
def internal_use():
    """Suppress legacy warnings for calls made by the framework itself
    (client backends constructing engines)."""
    global _suppress_depth
    _suppress_depth += 1
    try:
        yield
    finally:
        _suppress_depth -= 1


def reset_warnings() -> None:
    """Forget fired warnings (tests of the once-per-process contract)."""
    _warned.clear()
