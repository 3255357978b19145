"""The client session (a port of ``repro.client.session``).

    from repro_torch.client import FlexaClient, SoloSpec, PathSpec

    client = FlexaClient()                        # inline, on the card
    r = client.run(SoloSpec(problem))             # submit + wait

The same ``run`` / ``submit`` take :class:`~repro_torch.client.specs.
BatchSpec`, :class:`~repro_torch.client.specs.PathSpec` and
:class:`~repro_torch.client.specs.CVSpec`.  The serving backends buffer
(``wave``) or admit (``continuous``) on ``submit``; ``step`` advances
them one scheduler round and ``stream`` yields ``(ticket, result)`` in
completion order::

    client = FlexaClient(backend="continuous",
                         solver=SolverConfig(tol=1e-7, tau_adapt=False),
                         serve=ServeConfig(slab_capacity=8))
    tickets = [client.submit(SoloSpec(p)) for p in problems]
    for ticket, result in client.stream():
        ...

``FlexaClient(device="cpu")`` runs on the host instead.  The default
device is ``"cuda"``; constructing a client for it where CUDA is missing
raises, before any work is accepted.
"""
from __future__ import annotations

import itertools
from typing import Iterator

from repro_torch.client.backends import Backend, make_backend
from repro_torch.client.errors import ClientError
from repro_torch.client.specs import TicketDiagnostics, WorkItem, normalize
from repro_torch.config.base import ClientConfig, ServeConfig, SolverConfig
from repro_torch.obs import trace as obs
from repro_torch.serve.metrics import ServeTelemetry


class FlexaClient:
    """One front door: typed specs in, backend-independent results out.

    Pass a full :class:`ClientConfig`, or any of the ``backend=`` /
    ``solver=`` / ``serve=`` / ``device=`` overrides (overrides win over
    the config object's fields).  A shared :class:`ServeTelemetry` may be
    injected for cross-engine latency accounting.
    """

    def __init__(self, config: ClientConfig | None = None, *,
                 backend: str | None = None,
                 solver: SolverConfig | None = None,
                 serve: ServeConfig | None = None,
                 device: str | None = None,
                 telemetry: ServeTelemetry | None = None):
        cfg = config or ClientConfig()
        if backend is not None:
            cfg = cfg.replace(backend=backend)
        if solver is not None:
            cfg = cfg.replace(solver=solver)
        if serve is not None:
            cfg = cfg.replace(serve=serve)
        if device is not None:
            cfg = cfg.replace(device=device)
        self.config = cfg
        self.telemetry = telemetry if telemetry is not None \
            else ServeTelemetry()
        self._backend: Backend = make_backend(cfg, self.telemetry)
        self._tickets = itertools.count()
        self._items: dict[int, WorkItem] = {}
        self._completed: list[int] = []     # completion order
        self._streamed = 0                  # stream() read cursor

    @property
    def backend(self) -> str:
        return self._backend.name

    @property
    def device(self):
        return self._backend.device

    @property
    def pending(self) -> int:
        return self._backend.pending

    def submit(self, spec, *, arrival: float | None = None) -> int:
        """Validate, normalize and hand one workload to the backend;
        returns the ticket for :meth:`result` / :meth:`stream`."""
        item = normalize(spec, next(self._tickets))
        self._backend.validate(item)
        with obs.span("client.submit", cat="client", ticket=item.ticket,
                      kind=item.kind, backend=self._backend.name):
            done = self._backend.submit(item, arrival=arrival)
        self._items[item.ticket] = item
        self._completed.extend(done)
        return item.ticket

    def step(self) -> list[int]:
        """Advance the backend one scheduler round (inline work completes
        at submit)."""
        with obs.span("client.step", cat="client",
                      backend=self._backend.name,
                      pending=self._backend.pending):
            done = self._backend.step()
        self._completed.extend(done)
        return done

    def result(self, ticket: int, *, wait: bool = True):
        """The completed result of ``ticket`` (``None`` if in flight and
        ``wait=False``)."""
        if ticket not in self._items:
            raise KeyError(f"unknown ticket {ticket!r}")
        r = self._backend.result(ticket)
        while r is None and wait:
            if not self._backend.pending:
                raise ClientError(
                    f"ticket {ticket} never completed and the backend "
                    "has no pending work — this is a bug")
            self.step()
            r = self._backend.result(ticket)
        return r

    def run(self, spec):
        """Submit one spec and wait for its result."""
        return self.result(self.submit(spec))

    def stream(self) -> Iterator[tuple]:
        """Yield ``(ticket, result)`` in completion order until every
        submitted workload has been yielded."""
        while True:
            while self._streamed < len(self._completed):
                t = self._completed[self._streamed]
                self._streamed += 1
                yield t, self._backend.result(t)
            if not self._backend.pending:
                return
            self.step()

    def drain(self) -> dict[int, object]:
        """Step until idle; {ticket: result} for everything completed."""
        while self._backend.pending:
            self.step()
        return {t: self._backend.result(t) for t in self._completed}

    def stats(self) -> dict:
        """Backend counters + the session telemetry snapshot."""
        return {**self._backend.stats(),
                "telemetry": self.telemetry.snapshot()}

    def diagnostics(self, ticket: int) -> TicketDiagnostics:
        """Per-request lifecycle view of one ticket."""
        if ticket not in self._items:
            raise KeyError(f"unknown ticket {ticket!r}")
        item = self._items[ticket]
        traces = [self.telemetry.requests[rid].as_dict()
                  for rid in self._backend.request_ids(ticket)
                  if rid in self.telemetry.requests]
        return TicketDiagnostics(
            ticket=ticket, kind=item.kind, backend=self._backend.name,
            done=self._backend.result(ticket) is not None,
            requests=traces)

    def close(self) -> None:
        self._backend.close()

    def __enter__(self) -> "FlexaClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
