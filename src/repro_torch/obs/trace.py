"""Deterministic span tracing for the whole solver stack.

One ``Tracer`` records *host-side* spans and instant events with an
injectable clock — the device programs are never touched, so tracing off
is trivially bitwise-identical to an uninstrumented run, and tracing on
under a virtual clock (``TickClock``-style callables) is run-to-run
deterministic: span ids are sequence numbers, timestamps come from the
injected clock, and no wall-clock state leaks into the record.

Instrumentation sites call the module-level helpers::

    from repro_torch.obs import trace as obs

    with obs.span("serve.chunk", cat="continuous", live=live, cap=cap):
        ...device work...
    obs.instant("serve.admit", cat="continuous", req_id=rid, slot=slot)

Both are no-ops (a shared ``nullcontext`` / early return) unless a
tracer has been activated via ``set_tracer(t)`` or the scoped
``tracing(t)`` context manager, keeping the disabled-path overhead to a
single global read per call site.

Exports: ``Tracer.to_jsonl`` writes one JSON object per line;
``Tracer.to_chrome`` writes Chrome trace-event JSON (``ph: "X"``
complete events + ``ph: "i"`` instants, microsecond timestamps) that
loads directly in Perfetto / ``chrome://tracing``.
"""
from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

__all__ = [
    "Span",
    "Tracer",
    "get_tracer",
    "instant",
    "set_tracer",
    "span",
    "tracing",
]

#: Keys every exported span record carries (schema contract, see
#: tests/test_obs.py::test_trace_schema_stability).
SPAN_KEYS = ("ph", "id", "parent", "name", "cat", "t0", "t1", "args")
INSTANT_KEYS = ("ph", "id", "parent", "name", "cat", "t", "args")


@dataclass
class Span:
    """One closed span: ``[t0, t1]`` on the tracer's clock."""

    span_id: int
    parent_id: Optional[int]
    name: str
    cat: str
    t0: float
    t1: Optional[float] = None
    args: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "ph": "X",
            "id": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "cat": self.cat,
            "t0": self.t0,
            "t1": self.t1,
            "args": self.args,
        }


@dataclass
class _Instant:
    span_id: int
    parent_id: Optional[int]
    name: str
    cat: str
    t: float
    args: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "ph": "i",
            "id": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "cat": self.cat,
            "t": self.t,
            "args": self.args,
        }


class Tracer:
    """Deterministic span recorder with an injectable clock.

    ``clock`` is any zero-arg callable returning a float; the default is
    ``time.perf_counter``.  Inject a virtual clock (e.g. the serve
    bench's ``TickClock``) for bit-reproducible traces.  Ids are
    monotonically increasing ints shared between spans and instants, so
    the interleaved event order is recoverable from ids alone.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.spans: list[Span] = []
        self.instants: list[_Instant] = []
        self._stack: list[Span] = []
        self._next_id = 0

    # -- recording ---------------------------------------------------------
    def _take_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", **args: Any) -> Iterator[Span]:
        parent = self._stack[-1].span_id if self._stack else None
        s = Span(self._take_id(), parent, name, cat, float(self.clock()),
                 None, dict(args))
        self.spans.append(s)
        self._stack.append(s)
        try:
            yield s
        finally:
            self._stack.pop()
            s.t1 = float(self.clock())

    def instant(self, name: str, cat: str = "", **args: Any) -> None:
        parent = self._stack[-1].span_id if self._stack else None
        self.instants.append(
            _Instant(self._take_id(), parent, name, cat,
                     float(self.clock()), dict(args)))

    def clear(self) -> None:
        self.spans.clear()
        self.instants.clear()
        self._stack.clear()
        self._next_id = 0

    # -- views -------------------------------------------------------------
    def events(self) -> list[dict]:
        """All records (spans + instants) in id order, as plain dicts."""
        out = [s.as_dict() for s in self.spans]
        out += [i.as_dict() for i in self.instants]
        out.sort(key=lambda d: d["id"])
        return out

    def counts(self) -> dict:
        """Events per ``name`` — cheap summary for gates and tests."""
        c: dict[str, int] = {}
        for e in self.events():
            c[e["name"]] = c.get(e["name"], 0) + 1
        return c

    # -- export ------------------------------------------------------------
    def to_jsonl(self, path=None) -> str:
        """One compact JSON object per event, id order.

        Returns the serialized text; also writes it to ``path`` when
        given.  Byte-identical across runs under an injected clock.
        """
        text = "\n".join(
            json.dumps(e, sort_keys=True, separators=(",", ":"))
            for e in self.events())
        if text:
            text += "\n"
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def to_chrome(self, path=None) -> dict:
        """Chrome trace-event format dict (Perfetto-loadable).

        Spans become ``ph: "X"`` complete events, instants ``ph: "i"``;
        timestamps are scaled to microseconds as the format requires.
        """
        events = []
        for s in self.spans:
            t1 = s.t1 if s.t1 is not None else s.t0
            events.append({
                "ph": "X", "name": s.name, "cat": s.cat or "repro",
                "pid": 0, "tid": 0,
                "ts": s.t0 * 1e6, "dur": (t1 - s.t0) * 1e6,
                "args": dict(s.args, id=s.span_id, parent=s.parent_id),
            })
        for i in self.instants:
            events.append({
                "ph": "i", "name": i.name, "cat": i.cat or "repro",
                "pid": 0, "tid": 0, "ts": i.t * 1e6, "s": "t",
                "args": dict(i.args, id=i.span_id, parent=i.parent_id),
            })
        events.sort(key=lambda e: (e["ts"], e["args"]["id"]))
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, sort_keys=True)
        return doc


# -- module-level active tracer -------------------------------------------
_ACTIVE: Optional[Tracer] = None
_NULL_CM = contextlib.nullcontext()


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` as the active tracer; returns the previous one."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tracer
    return prev


def get_tracer() -> Optional[Tracer]:
    return _ACTIVE


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer]) -> Iterator[Optional[Tracer]]:
    """Scoped activation: restore the previous tracer on exit."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


def span(name: str, cat: str = "", **args: Any):
    """Span on the active tracer; shared no-op context when disabled."""
    t = _ACTIVE
    if t is None:
        return _NULL_CM
    return t.span(name, cat, **args)


def instant(name: str, cat: str = "", **args: Any) -> None:
    """Instant on the active tracer; no-op when disabled."""
    t = _ACTIVE
    if t is not None:
        t.instant(name, cat, **args)
