"""Live ops view: render telemetry snapshots as a terminal dashboard (a
port of ``repro.obs.dashboard``: the same panels, character for
character).

Pure rendering lives in ``render_snapshot``/``sparkline`` (plain dicts
in, string out — no engine imports, so dashboard consumers and tests
never pay a torch import).  The module entry point drives them::

    python -m repro_torch.obs.dashboard --snapshot results/snap.json
    python -m repro_torch.obs.dashboard --demo --ticks 30
    python -m repro_torch.obs.dashboard --follow http://127.0.0.1:8781

``--snapshot`` renders a saved ``ServeTelemetry.snapshot()`` JSON once;
``--demo`` runs a small continuous-backend workload through
``FlexaClient`` with progress sampling on and redraws the view every
tick, on the card unless ``--device cpu`` is given; ``--follow URL``
polls a live solver service's ``/snapshot`` endpoint (a
``repro_torch.remote`` or ``repro.remote`` server: the wire is the same;
only ``urllib`` is needed) and redraws the same panel per poll — the ops
view for a server you did not start.

Snapshots are schema-versioned (``ServeTelemetry.SNAPSHOT_SCHEMA``):
both file and follow modes reject a snapshot whose declared schema this
dashboard does not understand, instead of mis-rendering it.  Snapshots
with no ``"schema"`` key (pre-versioning captures) still render.

Sections rendered (each skipped when its source keys are absent):
queue depth + slab occupancy, request/latency percentiles, watchdog
health counters (quarantined/diverged/stalled), sliding-window SLO
panels (per-window count/rate/p50/p99, see ``ServeTelemetry.window_s``),
the unified cost ledger, the per-device mesh rollup, compile-cache
counters, and per-request convergence sparklines from sampled residual
trajectories (see ``ServeTelemetry.sample_progress`` and
``FlexaClient.diagnostics``).
"""
from __future__ import annotations

import argparse
import json

__all__ = ["SNAPSHOT_SCHEMA", "check_snapshot_schema", "render_requests",
           "render_snapshot", "sparkline"]

#: Highest snapshot schema this renderer understands.  Mirrors
#: ``repro_torch.serve.metrics.SNAPSHOT_SCHEMA`` (pinned equal by test) —
#: duplicated here so the dashboard never imports the serve stack.
SNAPSHOT_SCHEMA = 1

_BLOCKS = "▁▂▃▄▅▆▇█"


def check_snapshot_schema(snap: dict, *, where: str = "snapshot") -> dict:
    """Validate ``snap``'s declared schema; returns ``snap``.

    Missing ``"schema"`` is accepted (pre-versioning captures render
    fine); a present-but-unknown value raises ``ValueError`` with the
    supported version, so a newer server fails loudly instead of
    rendering garbage.
    """
    v = snap.get("schema")
    if v is not None and int(v) != SNAPSHOT_SCHEMA:
        raise ValueError(
            f"{where} declares schema {v}, but this dashboard only "
            f"understands schema {SNAPSHOT_SCHEMA}; upgrade the "
            "dashboard (or re-capture with a matching server)")
    return snap


def sparkline(values, width: int = 32) -> str:
    """Unicode sparkline of ``values`` resampled to ``width`` columns."""
    vals = [float(v) for v in values if v is not None]
    if not vals:
        return ""
    if len(vals) > width:
        # Even resampling keeps first and last points.
        step = (len(vals) - 1) / (width - 1) if width > 1 else 0.0
        vals = [vals[round(i * step)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _BLOCKS[0] * len(vals)
    return "".join(
        _BLOCKS[min(len(_BLOCKS) - 1,
                    int((v - lo) / span * len(_BLOCKS)))] for v in vals)


def _fmt(v, nd: int = 4) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def _bar(frac: float, width: int = 20) -> str:
    frac = min(1.0, max(0.0, float(frac)))
    n = int(round(frac * width))
    return "[" + "#" * n + "." * (width - n) + f"] {frac * 100:5.1f}%"


def render_snapshot(snap: dict, *, queue_depth=None, title: str = "repro.obs",
                    width: int = 72) -> str:
    """Render one telemetry snapshot dict as a fixed-width text panel."""
    rule = "─" * width
    lines = [rule, title.center(width), rule]

    done = snap.get("completed", 0)
    total = snap.get("requests", 0)
    in_flight = snap.get("in_flight", total - done)
    lines.append(
        f"requests  {done}/{total} done   in-flight {in_flight}   "
        f"converged {snap.get('converged', 0)}   "
        f"iters {snap.get('iters_total', 0)}")
    if queue_depth is not None:
        lines.append(f"queue     depth {queue_depth}")
    lines.append(
        "latency   p50 "
        f"{_fmt(snap.get('latency_p50'))}  p99 {_fmt(snap.get('latency_p99'))}"
        f"  mean {_fmt(snap.get('latency_mean'))}"
        f"   queue-wait p50 {_fmt(snap.get('queue_wait_p50'))}"
        f"  p99 {_fmt(snap.get('queue_wait_p99'))}")

    health = snap.get("health")
    if health:
        lines.append(rule)
        lines.append(
            f"health    quarantined {health.get('quarantined', 0)}   "
            f"diverged {health.get('diverged', 0)}   "
            f"stalled {health.get('stalled', 0)}   "
            f"timeouts {health.get('timeouts', 0)}")

    win = snap.get("windows")
    if win:
        lines.append(rule)
        lines.append(f"windows   horizon {_fmt(win.get('window_s'))}s  "
                     "(rate = events/s over window)")
        for name in sorted(win):
            if name == "window_s":
                continue
            w = win[name]
            lines.append(
                f"  {name:<13} n {w.get('count', 0):>5}  "
                f"rate {_fmt(w.get('rate'))}  "
                f"p50 {_fmt(w.get('p50'))}  p99 {_fmt(w.get('p99'))}  "
                f"max {_fmt(w.get('max'))}")

    led = snap.get("ledger")
    if led:
        lines.append(rule)
        lines.append(
            f"ledger    row {led.get('row_iters', 0)}   "
            f"live {led.get('live_iters', 0)}   "
            f"flops {led.get('device_flops', 0):.3g}")
        lines.append(
            f"          padding {led.get('padding_iters', 0)}   "
            f"freeze {led.get('freeze_iters', 0)}   "
            f"compiles {led.get('compiles', 0)}   "
            f"util {_bar(led.get('utilization', 1.0))}")

    cont = snap.get("continuous")
    if cont:
        lines.append(rule)
        lines.append(
            f"slab      occupancy {_bar(cont.get('occupancy_mean') or 0.0)}"
            f"   chunks {cont.get('chunks', 0)}"
            f"   migrations {cont.get('migrations', 0)}")
        lines.append(
            f"          row-iters {cont.get('row_iters', 0)}   "
            f"live {cont.get('live_iters', 0)}   "
            f"iters/s {_fmt(cont.get('iters_per_s'))}")

    wav = snap.get("wave")
    if wav:
        lines.append(rule)
        lines.append(
            f"waves     {wav.get('waves', 0)} dispatched   "
            f"row-iters {wav.get('row_iters', 0)}   "
            f"padding-waste {_fmt(wav.get('padding_waste'))}")

    mesh = snap.get("mesh")
    if mesh:
        lines.append(rule)
        lines.append(
            f"mesh      {mesh.get('devices', 0)} devices   "
            f"routed {mesh.get('routed', 0)}   steals {mesh.get('steals', 0)}")
        for dev, d in enumerate(mesh.get("per_device") or []):
            lines.append(
                f"  dev[{dev}]  chunks {d.get('chunks', 0):>4}  "
                f"row {d.get('row_iters', 0):>8}  "
                f"live {d.get('live_iters', 0):>8}  "
                f"flops {d.get('device_flops', 0):.3g}  "
                f"occ {_fmt(d.get('occupancy_mean'))}")

    cache = snap.get("compile_cache")
    if cache:
        lines.append(rule)
        for name in sorted(cache):
            c = cache[name]
            lines.append(
                f"cache     {name}: size {c.get('size', 0)}  "
                f"hits {c.get('hits', 0)}  misses {c.get('misses', 0)}  "
                f"evictions {c.get('evictions', 0)}")

    lines.append(rule)
    return "\n".join(lines)


def render_requests(diags, *, width: int = 72, spark_width: int = 28) -> str:
    """Per-request convergence sparklines from ticket diagnostics.

    ``diags`` is an iterable of ``TicketDiagnostics`` (or equivalent
    dicts).  Each sampled request renders one line: residual trajectory
    sparkline + latest iter count + state.
    """
    lines = []
    for diag in diags:
        d = diag if isinstance(diag, dict) else diag.as_dict()
        for req in d.get("requests", []):
            samples = req.get("samples") or []
            stats = [s[2] for s in samples]
            state = ("done" if req.get("completed") is not None
                     else "running")
            mark = "✓" if req.get("converged") else " "
            spark = sparkline(stats, width=spark_width) or "·" * 3
            lines.append(
                f"req[{req.get('req_id')}] t{d.get('ticket')} "
                f"{req.get('family', '?'):<11} {spark:<{spark_width}} "
                f"it={req.get('iters', 0):>5} {state}{mark}")
    if not lines:
        return "(no sampled requests — enable telemetry.sample_progress)"
    return "\n".join(lines[: max(1, width // 2)])


# -- entry point -----------------------------------------------------------

def _follow(url: str, *, interval: float, ticks: int) -> int:
    """Poll a solver service's ``/snapshot`` endpoint and redraw.

    ``ticks <= 0`` follows until interrupted or the server goes away
    (a draining server closing its listener ends the loop cleanly).
    """
    import time
    import urllib.error
    import urllib.request

    base = url.rstrip("/")
    tick = 0
    while ticks <= 0 or tick < ticks:
        try:
            with urllib.request.urlopen(f"{base}/snapshot",
                                        timeout=10.0) as resp:
                snap = json.loads(resp.read())
        except (urllib.error.URLError, OSError) as e:
            print(f"server at {base} gone ({e}); stopping")
            return 0 if tick else 1
        check_snapshot_schema(snap, where=f"{base}/snapshot")
        tele = snap.get("telemetry", snap)
        check_snapshot_schema(tele, where=f"{base}/snapshot telemetry")
        print(render_snapshot(tele, title=f"{base} · poll {tick}"))
        tick += 1
        if ticks <= 0 or tick < ticks:
            time.sleep(interval)
    return 0


def _run_demo(ticks: int, n_requests: int, seed: int,
              device: str = "cuda") -> str:
    """Small continuous-backend workload on ``device``, redrawing the view
    per tick."""
    from repro_torch.client import BatchSpec, FlexaClient
    from repro_torch.config.base import (ClientConfig, ServeConfig,
                                         SolverConfig)
    from repro_torch.obs.trace import Tracer, tracing
    from repro_torch.problems.lasso import nesterov_instance

    problems = [nesterov_instance(m=24, n=64, nnz_frac=0.1, c=1.0,
                                  seed=seed + i, device=device)
                for i in range(n_requests)]

    cfg = ClientConfig(
        solver=SolverConfig(max_iters=600, tol=1e-5),
        serve=ServeConfig(slab_capacity=8, chunk_iters=24),
        backend="continuous", device=device)
    out = []
    with tracing(Tracer()):
        with FlexaClient(cfg) as client:
            client.telemetry.sample_progress = True
            ticket = client.submit(BatchSpec(problems=problems))
            for tick in range(ticks):
                if not client.pending:
                    break
                client.step()
                stats = client.stats()
                panel = render_snapshot(
                    stats.get("telemetry", {}),
                    queue_depth=stats.get("queued"),
                    title=f"repro_torch.obs demo · tick {tick}")
                reqs = render_requests([client.diagnostics(ticket)])
                out.append(panel + "\n" + reqs)
                print(panel)
                print(reqs)
            client.result(ticket)
            stats = client.stats()
            final = render_snapshot(stats.get("telemetry", {}),
                                    title="repro_torch.obs demo · final")
            final += "\n" + render_requests([client.diagnostics(ticket)])
            out.append(final)
            print(final)
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.dashboard",
        description="Render ServeTelemetry snapshots as a live ops view.")
    ap.add_argument("--snapshot", metavar="FILE",
                    help="render a saved snapshot JSON file once")
    ap.add_argument("--demo", action="store_true",
                    help="run a small continuous workload and redraw "
                         "the view every tick")
    ap.add_argument("--follow", metavar="URL",
                    help="poll a live solver service's /snapshot "
                         "endpoint and redraw per poll")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="seconds between --follow polls")
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where --demo runs (cuda, the default, raises "
                         "without CUDA; or cpu)")
    args = ap.parse_args(argv)

    if args.snapshot:
        with open(args.snapshot) as f:
            snap = json.load(f)
        # Accept either a bare snapshot or a client stats() /
        # server /snapshot payload (telemetry nested one level down).
        tele = snap.get("telemetry", snap)
        try:
            check_snapshot_schema(snap, where=args.snapshot)
            check_snapshot_schema(tele, where=args.snapshot)
        except ValueError as e:
            print(f"error: {e}")
            return 2
        print(render_snapshot(tele))
        return 0
    if args.follow:
        try:
            return _follow(args.follow, interval=args.interval,
                           ticks=args.ticks)
        except ValueError as e:
            print(f"error: {e}")
            return 2
        except KeyboardInterrupt:
            return 0
    if args.demo:
        _run_demo(args.ticks, args.requests, args.seed, args.device)
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
