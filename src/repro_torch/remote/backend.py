"""``backend="remote"`` — run client specs against a solver service (a
port of ``repro.remote.backend``).

Importing this module registers :class:`RemoteBackend` with the client
backend registry (``repro_torch.client.backends`` does so lazily the
first time ``ClientConfig.backend == "remote"`` is used), after which

    client = FlexaClient(backend="remote", device="cpu",
                         config=ClientConfig(
                             remote_url="http://127.0.0.1:8781"))
    r = client.run(SoloSpec(problem))

behaves like any other backend: same specs, same typed results, same
error taxonomy — a server-side quota rejection surfaces as the typed
:class:`~repro_torch.remote.policy.QuotaExceeded` at ``submit`` time,
spec rejections as :class:`SpecError`/:class:`UnsupportedWorkloadError`,
exactly as if the validating backend ran in-process.  The server may be
a ``repro_torch.remote.server`` or a ``repro.remote.server`` process: the
wire is the same.  The client computes nothing; its ``device`` is
resolved as every backend's is (``"cuda"`` raises without CUDA), and its
results are host arrays as every backend's are.

Transport is stdlib ``urllib`` over the JSON wire protocol
(:mod:`repro_torch.remote.protocol`); ``step`` long-polls
``/v1/result/<ticket>`` so the session's ``stream``/``drain`` loops
behave like the other asynchronous backends.  The backend synthesizes
one local request trace per ticket (arrival at submit, completion when
the result lands), so ``FlexaClient.diagnostics()`` works unchanged;
the server keeps the authoritative per-engine-request traces, reachable
through :meth:`RemoteBackend.stats` / ``GET /stats`` / ``/snapshot``.
"""
from __future__ import annotations

import time
import urllib.error
import urllib.request

import numpy as np

from repro_torch.client.backends import (Backend, WaveBackend,
                                         register_backend)
from repro_torch.client.errors import ClientError, UnsupportedWorkloadError
from repro_torch.client.specs import WorkItem
from repro_torch.remote import protocol
from repro_torch.remote.policy import QuotaExceeded

#: Long-poll budget per `step` round (ms).  Short enough that a
#: multi-ticket session round-robins its in-flight tickets responsively.
_STEP_WAIT_MS = 200
#: Socket timeout on every HTTP call (s) — generous because a result
#: long-poll rides the same call.
_HTTP_TIMEOUT_S = 60.0


class RemoteTransportError(ClientError):
    """The server is unreachable or answered outside the protocol."""


def _http(method: str, url: str, body: bytes | None = None,
          timeout: float = _HTTP_TIMEOUT_S) -> tuple[int, dict]:
    req = urllib.request.Request(
        url, data=body, method=method,
        headers={"Content-Type": "application/json"} if body else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, protocol.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            payload = protocol.loads(e.read())
        except protocol.ProtocolError:
            payload = {"error": "http", "message": str(e)}
        return e.code, payload
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise RemoteTransportError(
            f"solver service unreachable at {url}: {e}") from None


@register_backend
class RemoteBackend(Backend):
    """Execute work items on a solver service process."""

    name = "remote"

    def __init__(self, config, telemetry):
        super().__init__(config, telemetry)
        url = (config.remote_url or "").rstrip("/")
        if not url:
            raise ClientError(
                'backend="remote" needs ClientConfig.remote_url '
                '(e.g. "http://127.0.0.1:8781")')
        self.url = url
        self.tenant = config.remote_tenant or ""
        self.slo = config.remote_slo or ""
        self._remote: dict[int, int] = {}       # local -> server ticket
        self._rids: dict[int, int] = {}         # local trace ids
        self._inflight: list[int] = []
        #: Per ticket: the request's JSON bytes, the seconds spent
        #: encoding it, and the seconds of its POST (upload, the server's
        #: decode and admission, the answer).
        self.wire_log: dict[int, dict] = {}

    # -- protocol -------------------------------------------------- #
    def validate(self, item: WorkItem) -> None:
        # The server executes a continuous backend, so the serve-side
        # capability envelope applies verbatim...
        WaveBackend.validate(self, item)
        # ...plus wire-only restrictions: closures cannot cross it.
        if item.kind == "cv" and item.spec.score is not None:
            raise UnsupportedWorkloadError(
                "custom score callables cannot cross the wire; pass "
                "validation=(A_val, b_val) pairs (MSE scoring) or run "
                "on an in-process backend")

    def submit(self, item: WorkItem, arrival=None) -> list[int]:
        t0 = time.perf_counter()
        msg = protocol.encode_item(item)
        if self.tenant:
            msg["tenant"] = self.tenant
        if self.slo:
            msg["slo"] = self.slo
        body = protocol.dumps(msg)
        t1 = time.perf_counter()
        status, payload = _http("POST", f"{self.url}/v1/submit", body)
        self.wire_log[item.ticket] = {
            "bytes": len(body), "encode_s": t1 - t0,
            "post_s": time.perf_counter() - t1}
        if status == 429:
            raise QuotaExceeded(payload.get("tenant", self.tenant),
                                payload.get("reason", "?"),
                                payload.get("message", "quota exceeded"))
        if status == 503:
            raise ClientError(
                f"solver service at {self.url} is draining; "
                "no new admissions")
        if status != 200:
            raise ClientError(
                f"submit rejected ({status}): "
                f"{payload.get('message', payload)}")
        self._remote[item.ticket] = int(payload["ticket"])
        self._inflight.append(item.ticket)
        # Local lifecycle trace so diagnostics() has a row per ticket.
        rid = self.telemetry.next_request_id()
        t = self.telemetry.now() if arrival is None else arrival
        self.telemetry.record_arrival(rid, item.family or "adhoc",
                                      self.name, t=t)
        self.telemetry.record_admit(rid)
        self._rids[item.ticket] = rid
        return []

    @property
    def pending(self) -> int:
        return len(self._inflight)

    def step(self) -> list[int]:
        done = []
        for ticket in list(self._inflight):
            remote = self._remote[ticket]
            status, payload = _http(
                "GET", f"{self.url}/v1/result/{remote}"
                       f"?wait_ms={_STEP_WAIT_MS}")
            if status == 202:
                continue
            if status != 200:
                raise RemoteTransportError(
                    f"result fetch for ticket {ticket} failed "
                    f"({status}): {payload.get('message', payload)}")
            res = protocol.decode_result(payload, backend=self.name)
            self._results[ticket] = res
            self._inflight.remove(ticket)
            done.append(ticket)
            self._finish_trace(ticket, res)
        return done

    def _finish_trace(self, ticket: int, res) -> None:
        rid = self._rids.get(ticket)
        if rid is None:
            return
        iters = getattr(res, "iters", 0)
        conv = getattr(res, "converged", False)
        status = getattr(res, "status", "ok")
        if isinstance(status, list):
            bad = [s for s in status if s != "ok"]
            status = bad[0] if bad else "ok"
        self.telemetry.record_completion(
            rid, iters=int(np.sum(np.asarray(iters))),
            converged=bool(np.asarray(conv).all()),
            status=str(status or "ok"))

    def request_ids(self, ticket: int) -> list[int]:
        rid = self._rids.get(ticket)
        return [] if rid is None else [rid]

    def stats(self) -> dict:
        """Local counters + the server's live ``/stats`` view (quota
        state, rejections, failures) — how a quota rejection stays
        observable after the fact."""
        out = {**super().stats(), "url": self.url, "pending": self.pending}
        try:
            _, server = _http("GET", f"{self.url}/stats", timeout=5.0)
            out["server"] = server
        except RemoteTransportError as e:
            out["server_error"] = str(e)
        return out
