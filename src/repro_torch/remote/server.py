"""The solver service process: ``python -m repro_torch.remote.server`` (a
port of ``repro.remote.server``, the same wire and routes).

One asyncio event loop owns everything — the minimal HTTP front door
and the engine tick task — so no locks guard the backend: every request
handler and every scheduler tick runs on the same thread, and the
device chunk dispatches (which do block the loop) are the same slab
chunks the in-process backends run.  The service wraps an ordinary
:class:`~repro_torch.client.backends.ContinuousBackend` on its device
(``--device``, default ``cuda``; ``--device cpu`` runs on the host):
specs arrive wire-encoded, are decoded onto that device and normalized
by the *same* ``normalize``/``validate`` path a local client uses, get
stamped with the tenant's SLO class (``priority`` + absolute
``deadline``), and ride the continuous engine's slot slabs next to every
other tenant's work — per-request tolerances included, which is what
lets one engine mix a tenant's coarse CV sweep with another's
full-accuracy solves.  ``--backend mesh`` raises
:class:`~repro_torch.client.errors.NotPortedError` (ROADMAP Queue 1 step
12).

On the card the server loads the CUDA library of the slab's kernels
(``batched_best_response``, ``batched_apply_update``) before it answers,
from the build directory :mod:`repro_torch.kernels.build` fills (built
there if missing; a failed build or load raises).

Endpoints (all JSON):

* ``POST /v1/submit``            — one work item; 200 ``{"ticket": n}``,
  429 typed quota rejection, 400 spec/protocol error, 503 draining.
* ``GET /v1/result/<t>?wait_ms=`` — long-poll one ticket; 200 result,
  202 still pending, 404 unknown.
* ``GET /snapshot``              — live ``ServeTelemetry.snapshot()``
  (schema-versioned; ``repro_torch.obs.dashboard --follow URL`` renders
  it).
* ``GET /stats``                 — quotas, queue depths, failures, and
  the launch counts of the port's solver kernels in this process.
* ``GET /healthz``               — liveness + drain state.
* ``POST /v1/drain``             — begin graceful drain (same path as
  SIGTERM): stop admitting, finish in-flight, keep answering result
  polls until each completed ticket was fetched once (at most
  ``_DRAIN_GRACE_S``), flush telemetry, exit.

Deadlines are enforced by calling the engine's ``expire_overdue``
sweep every tick, so a past-deadline request is evicted as
``status="timeout"`` through the normal eviction path (audit closed,
telemetry counted) whether it was still queued or already in a slot.

On startup the server prints ``READY port=<N>`` on stdout — the
subprocess handshake clients and tests wait for.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import signal
import sys

from repro_torch.client.errors import ClientError
from repro_torch.client.specs import normalize
from repro_torch.config.base import ClientConfig, ServeConfig, SolverConfig
from repro_torch.remote import protocol
from repro_torch.remote.policy import (SLO_CLASSES, QuotaExceeded,
                                       QuotaPolicy, TenantQuota,
                                       resolve_slo)

_MAX_BODY = 512 * 1024 * 1024       # refuse absurd payloads outright
#: After a drain, how long the listener stays open for clients to fetch
#: results completed during the drain (s).
_DRAIN_GRACE_S = 10.0
#: While a request body is arriving the tick task holds the engine for
#: at most this long (s) a body, so an upload is not read between chunks.
_UPLOAD_HOLD_S = 5.0
#: The wrappers whose launch counts ``/stats`` reports.
_KERNELS = ("batched_best_response", "batched_apply_update")


class SolverService:
    """Service state: one backend, one policy, one ticket namespace."""

    def __init__(self, config: ClientConfig, policy: QuotaPolicy, *,
                 default_slo: str = "standard",
                 tick_idle_s: float = 0.02):
        from repro_torch.client.backends import make_backend
        from repro_torch.serve.metrics import ServeTelemetry
        if default_slo not in SLO_CLASSES:
            raise ValueError(f"unknown default SLO class {default_slo!r}")
        self.config = config
        self.policy = policy
        self.default_slo = default_slo
        self.tick_idle_s = float(tick_idle_s)
        self.telemetry = ServeTelemetry()
        self.backend = make_backend(config, self.telemetry)
        self.device = self.backend.device
        self.kernels_built_s: dict[str, float] = {}
        if self.device.type == "cuda":
            self._load_kernels()
        self._tickets = iter(range(1, 1 << 62))
        self._kind: dict[int, str] = {}
        self._tenant: dict[int, str] = {}
        self._done: dict[int, asyncio.Event] = {}
        self._encoded: dict[int, bytes] = {}
        self._fetched: set[int] = set()
        self.receiving = 0              # request bodies being read
        self._hold_until = 0.0          # loop time the hold ends
        self.draining = False
        self.drained = asyncio.Event()

    def _load_kernels(self) -> None:
        """Load the slab kernels' library now, not inside the first
        request (nvcc runs only when the build directory lacks it)."""
        from repro_torch.kernels import build
        from repro_torch.kernels import flexa_prox as fp
        fp.br_library()
        self.kernels_built_s = dict(build.build_seconds)

    # -- admission ------------------------------------------------- #
    def submit(self, msg: dict) -> int:
        """Decode, police and admit one work item; returns the ticket.

        Raises :class:`ProtocolError` (malformed message),
        :class:`ClientError` (spec/backend rejection — includes the
        typed :class:`QuotaExceeded`), in that order: a request that
        cannot even be decoded never costs quota."""
        spec = protocol.decode_spec(msg, self.device)
        tenant = str(msg.get("tenant") or "")
        slo = str(msg.get("slo") or self.default_slo)
        now = self.telemetry.now()
        priority, deadline = resolve_slo(slo, now,
                                         msg.get("deadline_s"))
        ticket = next(self._tickets)
        item = normalize(spec, ticket)
        self.backend.validate(item)
        # Policy last: only a request the backend would accept can
        # consume quota.
        self.policy.admit(tenant, now)
        item = dataclasses.replace(item, priority=priority,
                                   deadline=deadline)
        self.backend.submit(item)
        self._kind[ticket] = item.kind
        self._tenant[ticket] = tenant
        self._done[ticket] = asyncio.Event()
        return ticket

    def _complete(self, ticket: int) -> None:
        res = self.backend.result(ticket)
        payload = protocol.encode_result(self._kind[ticket], res)
        self._encoded[ticket] = protocol.dumps(payload)
        self.policy.release(self._tenant[ticket])
        self._done[ticket].set()

    # -- the scheduler tick task ----------------------------------- #
    def hold_for_upload(self, start: bool) -> None:
        """Count a request body starting (``start``) or done being read;
        a start holds the tick task for up to ``_UPLOAD_HOLD_S``."""
        self.receiving += 1 if start else -1
        if start:
            loop = asyncio.get_running_loop()
            self._hold_until = loop.time() + _UPLOAD_HOLD_S

    async def tick_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            if self.receiving and loop.time() < self._hold_until:
                # A chunk blocks the loop: let the upload in first.
                await asyncio.sleep(0.001)
                continue
            if self.backend.pending:
                # Expire first so a request whose deadline passed while
                # queued never costs a device chunk.
                self.backend.expire_overdue()
                for ticket in self.backend.step():
                    self._complete(ticket)
                # Yield so request handlers interleave between chunks.
                await asyncio.sleep(0)
                continue
            if self.draining:
                self.drained.set()
                return
            await asyncio.sleep(self.tick_idle_s)

    def begin_drain(self) -> None:
        self.draining = True

    # -- views ----------------------------------------------------- #
    def stats(self) -> dict:
        from repro_torch.kernels import flexa_prox as fp
        eng = getattr(self.backend, "_eng", None)
        return {
            "schema": protocol.SCHEMA,
            "backend": self.config.backend,
            "device": str(self.device),
            "draining": self.draining,
            "pending": self.backend.pending,
            "queued": 0 if eng is None else eng.queued,
            "tickets": {"issued": len(self._kind),
                        "completed": len(self._encoded)},
            "tenants": self.policy.stats(),
            "failures": [] if eng is None else
            [{"req_id": f.req_id, "status": f.status,
              "iters": f.iters, "tick": f.tick}
             for f in eng.failures],
            "kernels": {"launches": {k: getattr(fp, k).launches
                                     for k in _KERNELS},
                        "built_here_s": self.kernels_built_s},
        }

    def snapshot(self) -> dict:
        return {"schema": protocol.SCHEMA,
                "telemetry": self.telemetry.snapshot()}


# ------------------------------------------------------------------ #
# Minimal HTTP plumbing (stdlib only)                                #
# ------------------------------------------------------------------ #
_STATUS = {200: "OK", 202: "Accepted", 400: "Bad Request",
           404: "Not Found", 405: "Method Not Allowed",
           413: "Payload Too Large", 429: "Too Many Requests",
           500: "Internal Server Error", 503: "Service Unavailable"}


def _response(status: int, body: bytes) -> bytes:
    head = (f"HTTP/1.1 {status} {_STATUS.get(status, '?')}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n")
    return head.encode("ascii") + body


async def _read_request(reader, svc=None) -> tuple[str, str, bytes]:
    """(method, target, body) of one HTTP/1.1 request (``svc`` holds its
    tick task while the body arrives)."""
    line = await reader.readline()
    if not line:
        raise ConnectionError("empty request")
    try:
        method, target, _ = line.decode("ascii").split(" ", 2)
    except ValueError:
        raise protocol.ProtocolError("malformed request line") from None
    length = 0
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin-1").partition(":")
        if name.strip().lower() == "content-length":
            length = int(value.strip())
    if length > _MAX_BODY:
        raise protocol.ProtocolError(f"body of {length} bytes exceeds "
                                     f"the {_MAX_BODY} limit")
    if not length:
        return method.upper(), target, b""
    if svc is not None:
        svc.hold_for_upload(True)
    try:
        body = await reader.readexactly(length)
    finally:
        if svc is not None:
            svc.hold_for_upload(False)
    return method.upper(), target, body


def _query(target: str) -> tuple[str, dict]:
    path, _, q = target.partition("?")
    params = {}
    for part in q.split("&"):
        if part:
            k, _, v = part.partition("=")
            params[k] = v
    return path, params


class _HTTPFront:
    def __init__(self, service: SolverService):
        self.service = service

    async def handle(self, reader, writer) -> None:
        try:
            method, target, body = await _read_request(reader, self.service)
            status, payload = await self.route(method, target, body)
        except (protocol.ProtocolError, ConnectionError,
                asyncio.IncompleteReadError) as e:
            status = 400
            payload = {"error": "protocol", "message": str(e)}
        except Exception as e:      # noqa: BLE001 — the front door
            status = 500            # must answer, not die
            payload = {"error": "internal",
                       "message": f"{type(e).__name__}: {e}"}
        try:
            writer.write(_response(status, protocol.dumps(payload)))
            await writer.drain()
        except ConnectionError:
            pass
        finally:
            writer.close()

    async def route(self, method: str, target: str,
                    body: bytes) -> tuple[int, dict]:
        svc = self.service
        path, params = _query(target)
        if path == "/healthz" and method == "GET":
            return 200, {"ok": True, "draining": svc.draining}
        if path == "/snapshot" and method == "GET":
            return 200, svc.snapshot()
        if path == "/stats" and method == "GET":
            return 200, svc.stats()
        if path == "/v1/submit" and method == "POST":
            if svc.draining:
                return 503, {"error": "draining",
                             "message": "server is draining; no new "
                                        "admissions"}
            try:
                ticket = svc.submit(protocol.loads(body))
            except QuotaExceeded as e:
                return 429, {"error": "quota", "reason": e.reason,
                             "tenant": e.tenant, "message": str(e)}
            except protocol.ProtocolError as e:
                return 400, {"error": "protocol", "message": str(e)}
            except (ClientError, ValueError) as e:
                return 400, {"error": "spec",
                             "message": f"{type(e).__name__}: {e}"}
            return 200, {"schema": protocol.SCHEMA, "ticket": ticket}
        if path.startswith("/v1/result/") and method == "GET":
            try:
                ticket = int(path.rsplit("/", 1)[1])
            except ValueError:
                return 400, {"error": "protocol",
                             "message": "ticket must be an integer"}
            ev = svc._done.get(ticket)
            if ev is None:
                return 404, {"error": "unknown_ticket",
                             "message": f"no ticket {ticket}"}
            wait_ms = min(int(params.get("wait_ms", 0) or 0), 30_000)
            if not ev.is_set() and wait_ms:
                try:
                    await asyncio.wait_for(ev.wait(), wait_ms / 1000.0)
                except asyncio.TimeoutError:
                    pass
            if not ev.is_set():
                return 202, {"status": "pending"}
            # Pre-encoded at completion; re-parse to wrap (cheap
            # relative to a solve, and keeps one canonical encoding).
            svc._fetched.add(ticket)
            return 200, json.loads(svc._encoded[ticket])
        if path == "/v1/drain" and method == "POST":
            svc.begin_drain()
            return 200, {"draining": True,
                         "pending": svc.backend.pending}
        return 405 if path in ("/v1/submit", "/v1/drain",
                               "/healthz", "/snapshot", "/stats") \
            else 404, {"error": "no_route",
                       "message": f"{method} {path}"}


# ------------------------------------------------------------------ #
# Entry point                                                        #
# ------------------------------------------------------------------ #
def build_service(args) -> SolverService:
    solver = SolverConfig(tol=args.tol, max_iters=args.max_iters,
                          tau_adapt=args.tau_adapt)
    serve = ServeConfig(slab_capacity=args.slab_capacity,
                        chunk_iters=args.chunk_iters,
                        policy=args.queue_policy)
    config = ClientConfig(solver=solver, serve=serve,
                          backend=args.backend, device=args.device)
    policy = QuotaPolicy(TenantQuota(max_in_flight=args.max_in_flight,
                                     rate=args.rate, burst=args.burst))
    return SolverService(config, policy, default_slo=args.default_slo,
                         tick_idle_s=args.tick_idle)


async def serve(args) -> int:
    service = build_service(args)
    front = _HTTPFront(service)
    server = await asyncio.start_server(front.handle, args.host,
                                        args.port)
    port = server.sockets[0].getsockname()[1]
    print(f"READY port={port}", flush=True)

    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, service.begin_drain)

    tick = asyncio.create_task(service.tick_loop())
    # Wait for a drain request, then for in-flight work to finish.
    while not service.draining:
        await asyncio.sleep(0.05)
    await service.drained.wait()
    await tick
    # Drained work is answered: keep listening until every completed
    # ticket was fetched once (or the grace period ends).
    grace_end = loop.time() + _DRAIN_GRACE_S
    while (set(service._encoded) - service._fetched
           and loop.time() < grace_end):
        await asyncio.sleep(0.02)
    server.close()
    await server.wait_closed()
    if args.telemetry_out:
        with open(args.telemetry_out, "w", encoding="utf-8") as f:
            f.write(protocol.dumps(service.snapshot()).decode("utf-8"))
    print("DRAINED", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.remote.server",
        description="FLEXA solver service (HTTP/JSON front door over "
                    "the continuous-batching engine)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = pick a free port (printed in the READY "
                         "handshake)")
    ap.add_argument("--backend", default="continuous",
                    choices=("continuous", "mesh"),
                    help="mesh is not ported yet and raises")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (the default; "
                         "raises without CUDA) or cpu")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iters", type=int, default=2000)
    ap.add_argument("--tau-adapt", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="--no-tau-adapt pins the fixed-τ configuration "
                         "whose cross-driver agreement the equivalence "
                         "matrix is calibrated against")
    ap.add_argument("--slab-capacity", type=int, default=8)
    ap.add_argument("--chunk-iters", type=int, default=16)
    ap.add_argument("--queue-policy", default="priority",
                    help="admission-queue policy (fifo | priority | "
                         "deadline)")
    ap.add_argument("--max-in-flight", type=int, default=8,
                    help="per-tenant in-flight ticket quota")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="per-tenant admissions per second")
    ap.add_argument("--burst", type=float, default=50.0)
    ap.add_argument("--default-slo", default="standard",
                    choices=tuple(sorted(SLO_CLASSES)))
    ap.add_argument("--tick-idle", type=float, default=0.02,
                    help="idle sleep between scheduler ticks (s)")
    ap.add_argument("--telemetry-out", default="",
                    help="write the final telemetry snapshot JSON "
                         "here on drain")
    args = ap.parse_args(argv)
    try:
        return asyncio.run(serve(args))
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
