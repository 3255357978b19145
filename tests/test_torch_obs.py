"""The port's ops dashboard and perf-history tool against the JAX
package's.

* ``render_snapshot``, ``render_requests`` and ``sparkline`` of
  ``repro_torch.obs.dashboard`` give the reference's string, character
  for character, on the same snapshot dicts: hand-made ones that reach
  every panel (health, windows, ledger, slab, waves, mesh, compile
  cache) and one taken from a port ``ServeTelemetry.snapshot()`` after a
  continuous run with progress sampling (its per-request sparklines
  too).  ``SNAPSHOT_SCHEMA`` is pinned to the port's serve metrics, and
  an unknown schema is rejected (the module entry point exits 2).
* ``--follow`` renders the live panel of a ``repro_torch.remote.server
  --device cpu`` process, as the reference's dashboard renders it.
* ``history.collect`` / ``append`` / ``load_history`` / ``compare`` and
  the ``main`` CLI give the reference's records, verdicts and exit codes
  on the same ``BENCH_*.json`` fixtures written to ``tmp_path``.
"""
import copy
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from repro.obs import dashboard as jdash
from repro.obs import history as jhist
from repro_torch.client import BatchSpec, FlexaClient, SoloSpec
from repro_torch.config.base import ServeConfig, SolverConfig
from repro_torch.obs import dashboard, history
from repro_torch.problems.lasso import nesterov_instance
from repro_torch.serve.metrics import SNAPSHOT_SCHEMA

ROOT = Path(__file__).resolve().parents[1]

#: A snapshot that reaches every panel of the view.
FULL = {
    "schema": 1, "requests": 12, "completed": 9, "in_flight": 3,
    "converged": 8, "iters_total": 4321, "latency_p50": 0.123456,
    "latency_p99": 2.5, "latency_mean": 0.75, "queue_wait_p50": 1e-4,
    "queue_wait_p99": None,
    "health": {"quarantined": 2, "diverged": 1, "stalled": 1,
               "timeouts": 3},
    "windows": {"window_s": 10.0,
                "latency": {"count": 5, "rate": 0.5, "p50": 0.1,
                            "p99": 0.9, "max": 1.2},
                "completions": {"count": 9, "rate": 0.9, "p50": None,
                                "p99": None, "max": None}},
    "ledger": {"row_iters": 1000, "live_iters": 700, "padding_iters": 200,
               "freeze_iters": 100, "device_flops": 123456789,
               "compiles": 0, "utilization": 0.7},
    "continuous": {"occupancy_mean": 0.625, "chunks": 40, "migrations": 1,
                   "row_iters": 1000, "live_iters": 700,
                   "iters_per_s": 1234.5},
    "wave": {"waves": 3, "row_iters": 96, "padding_waste": 0.25},
    "mesh": {"devices": 2, "routed": 5, "steals": 1,
             "per_device": [{"chunks": 3, "row_iters": 10,
                             "live_iters": 8, "device_flops": 1e6,
                             "occupancy_mean": 0.5},
                            {"chunks": 1}]},
    "compile_cache": {"chunk": {"size": 2, "hits": 7, "misses": 2,
                                "evictions": 0},
                      "alpha": {"size": 1}},
}


def _variants():
    empty = {}
    bare = {k: v for k, v in FULL.items() if k in (
        "requests", "completed", "converged", "iters_total")}
    over = copy.deepcopy(FULL)
    over["ledger"]["utilization"] = 1.7           # the bar clamps
    over["continuous"]["occupancy_mean"] = None
    return {"full": FULL, "empty": empty, "bare": bare, "over": over}


@pytest.mark.parametrize("name", sorted(_variants()))
def test_render_snapshot_matches_reference(name):
    snap = _variants()[name]
    assert dashboard.render_snapshot(snap) == jdash.render_snapshot(snap)
    kw = dict(queue_depth=4, title="ops", width=60)
    assert dashboard.render_snapshot(snap, **kw) == \
        jdash.render_snapshot(snap, **kw)


@pytest.mark.parametrize("values,width", [
    ([], 32), ([None, None], 8), ([3.0], 32), ([1, 1, 1], 4),
    ([5, 4, 3, 2, 1, 0.5, None, 0.1], 32),
    ([float(i % 7) for i in range(100)], 16),
    ([float(i) for i in range(40)], 1)])
def test_sparkline_matches_reference(values, width):
    assert dashboard.sparkline(values, width) == \
        jdash.sparkline(values, width)


@pytest.fixture(scope="module")
def port_run():
    """A continuous run of 5 small Lassos in a capacity-2 slab with
    progress sampling on: the client's telemetry snapshot and the
    ticket's diagnostics."""
    ps = [nesterov_instance(m=20, n=48, nnz_frac=0.15, seed=s,
                            device="cpu") for s in range(5)]
    client = FlexaClient(backend="continuous", device="cpu",
                         solver=SolverConfig(max_iters=600, tol=1e-5),
                         serve=ServeConfig(slab_capacity=2, chunk_iters=24))
    client.telemetry.sample_progress = True
    ticket = client.submit(BatchSpec(problems=ps[:4]))
    solo = client.submit(SoloSpec(problem=ps[4]))
    client.drain()
    return (client.stats()["telemetry"],
            [client.diagnostics(ticket), client.diagnostics(solo)])


def test_port_snapshot_renders_as_the_reference_renders_it(port_run):
    snap, diags = port_run
    assert snap["schema"] == SNAPSHOT_SCHEMA == dashboard.SNAPSHOT_SCHEMA
    assert snap["continuous"]["chunks"] > 0
    text = dashboard.render_snapshot(snap, queue_depth=0)
    assert text == jdash.render_snapshot(snap, queue_depth=0)
    assert "slab      occupancy" in text and "ledger    row" in text
    wire = json.loads(json.dumps(snap))          # as a server sends it
    assert dashboard.render_snapshot(wire) == jdash.render_snapshot(wire)
    reqs = dashboard.render_requests(diags)
    assert reqs == jdash.render_requests([d.as_dict() for d in diags])
    assert reqs.count("done✓") == 5
    assert dashboard.render_requests([]) == jdash.render_requests([])


def test_unknown_snapshot_schema_rejected(tmp_path, capsys):
    for m in (dashboard, jdash):
        m.check_snapshot_schema({"requests": 1})      # pre-versioning
        m.check_snapshot_schema({"schema": 1})
        with pytest.raises(ValueError, match="only\\s+understands schema"):
            m.check_snapshot_schema({"schema": 99})
    bad = tmp_path / "snap.json"
    bad.write_text(json.dumps({"schema": 1,
                               "telemetry": {**FULL, "schema": 99}}))
    assert dashboard.main(["--snapshot", str(bad)]) == 2
    assert "only understands schema 1" in capsys.readouterr().out
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"schema": 1, "telemetry": FULL}))
    assert dashboard.main(["--snapshot", str(good)]) == 0
    assert capsys.readouterr().out.strip() == \
        jdash.render_snapshot(FULL).strip()


def test_follow_renders_the_live_server(capsys):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.remote.server", "--port", "0",
         "--device", "cpu", "--tol", "1e-7", "--no-tau-adapt"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
    try:
        url = None
        for line in proc.stdout:
            if line.startswith("READY port="):
                url = f"http://127.0.0.1:{int(line.split('=')[1])}"
                break
        assert url is not None, proc.stderr.read()
        from repro_torch.client import ClientConfig
        client = FlexaClient(config=ClientConfig(backend="remote",
                                                 remote_url=url),
                             device="cpu")
        client.run(SoloSpec(problem=nesterov_instance(
            m=20, n=48, nnz_frac=0.15, seed=0, device="cpu")))
        assert dashboard.main(["--follow", url, "--ticks", "1"]) == 0
        mine = capsys.readouterr().out
        assert jdash.main(["--follow", url, "--ticks", "1"]) == 0
        assert mine == capsys.readouterr().out
        assert f"{url} · poll 0" in mine
        assert "requests  1/1 done" in mine and "slab      occupancy" in mine
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    # a server that is gone ends the follow loop
    assert dashboard.main(["--follow", url, "--ticks", "1"]) == 1


# ------------------------------------------------------------------ #
# The perf-history tool                                              #
# ------------------------------------------------------------------ #
ARTIFACTS = {
    "BENCH_obs.json": {"row_iters": 5000, "overhead_frac": 0.031,
                       "smoke": True,
                       "ledger": {"row_iters": 5000, "live_iters": 4100},
                       "solver_cfg": {"tol": 1e-6}, "serve_cfg": {"S": 8}},
    "BENCH_serve.json": {
        "traces": {"poisson": {"speedup": {"row_iters": 2.5,
                                           "makespan": 1.9}},
                   "bursty": {"speedup": {"row_iters": 2.1}},
                   "heavy_tail": {"speedup": {"row_iters": 3.0,
                                              "p99_latency": 1.4}}},
        "solver_cfg": {"tol": 1e-6}, "serve_cfg": {"S": 8}},
    "BENCH_remote.json": {"accept": {"cells_ok": 4, "max_dev": 3e-6},
                          "drain": {"completed": 1}},
    "BENCH_path.json": {"path": {"accept": {}}},
}


def _bench_dir(tmp_path, artifacts=ARTIFACTS):
    d = tmp_path / "bench"
    d.mkdir()
    for name, art in artifacts.items():
        (d / name).write_text(json.dumps(art))
    return d


def test_history_schema_and_metrics_match_reference():
    assert history.SCHEMA_VERSION == jhist.SCHEMA_VERSION
    assert [(s.name, s.artifact, s.path, s.direction, s.rtol)
            for s in history.METRICS] == \
        [(s.name, s.artifact, s.path, s.direction, s.rtol)
         for s in jhist.METRICS]


def test_history_collect_append_load_match_reference(tmp_path):
    d = _bench_dir(tmp_path)
    mine, ref = history.collect(d, t=1.0), jhist.collect(d, t=1.0)
    assert mine == ref
    assert mine["metrics"]["remote.cells_ok"] == 4 and mine["smoke"]
    assert "path.ratio_vs_cold_batched" not in mine["metrics"]
    assert history.collect(d, smoke=False, t=2.0) == \
        jhist.collect(d, smoke=False, t=2.0)
    h = tmp_path / "deep" / "history.jsonl"
    history.append(mine, h)
    jhist.append(ref, h)
    assert h.read_text().splitlines()[0] == h.read_text().splitlines()[1]
    assert history.load_history(h) == jhist.load_history(h) == [mine, ref]
    assert history.load_history(tmp_path / "none.jsonl") == []


def _edits():
    """(name, edit of the current record) pairs of the compare cases."""
    def metric(name, value):
        def f(r):
            if value is None:
                del r["metrics"][name]
            else:
                r["metrics"][name] = value
        return f

    def key(name, value):
        return lambda r: r.__setitem__(name, value)

    return {
        "same": lambda r: None,
        "exact_changed": metric("obs.row_iters", 5001),
        "higher_within_rtol": metric("serve.poisson.row_iters_x", 2.4),
        "higher_regressed": metric("serve.poisson.row_iters_x", 2.3),
        "higher_improved": metric("serve.bursty.row_iters_x", 9.0),
        "record_only_moves": metric("obs.overhead_frac", 0.9),
        "missing_metric": metric("remote.cells_ok", None),
        "schema_mismatch": key("schema", 2),
        "smoke_mismatch": key("smoke", False),
        "digest_mismatch": key("config_digest", "0" * 16),
    }


@pytest.mark.parametrize("case", sorted(_edits()))
def test_history_compare_matches_reference(case, tmp_path):
    base = jhist.collect(_bench_dir(tmp_path), t=1.0)
    cur = copy.deepcopy(base)
    _edits()[case](cur)
    mine = history.compare(cur, base)
    assert mine == jhist.compare(cur, base)
    regressions, warnings = mine
    want_bad = case in ("exact_changed", "higher_regressed",
                        "missing_metric")
    assert bool(regressions) == want_bad
    assert bool(warnings) == case.endswith("_mismatch")


@pytest.mark.parametrize("case", ["same", "higher_regressed"])
def test_history_cli_matches_reference(case, tmp_path, capsys):
    d = _bench_dir(tmp_path)
    h = tmp_path / "history.jsonl"
    codes, outs = [], []
    for m in (history, jhist):
        if h.exists():
            h.unlink()
        rc = [m.main(["compare", "--history", str(h)])]     # missing
        rc.append(m.main(["append", "--bench-dir", str(d),
                          "--history", str(h)]))
        rc.append(m.main(["compare", "--history", str(h)]))  # one record
        rec = json.loads(h.read_text())
        _edits()[case](rec)
        h.write_text(h.read_text() + json.dumps(rec) + "\n")
        rc.append(m.main(["compare", "--history", str(h)]))
        codes.append(rc)
        out = capsys.readouterr()
        outs.append([ln for ln in (out.out + out.err).splitlines()
                     if "appended" not in ln])
    assert codes[0] == codes[1] == [1, 0, 0,
                                    1 if case == "higher_regressed" else 0]
    assert outs[0] == outs[1]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert history.main(["append", "--bench-dir", str(empty)]) == \
        jhist.main(["append", "--bench-dir", str(empty)]) == 1
