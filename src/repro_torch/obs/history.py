"""Persistent perf-history tracker: append-only bench records + compare
(a port of ``repro.obs.history``: the same record layout, schema and
gates, so records of either package compare).

Host code over the ``BENCH_*.json`` artifacts a benchmark run writes:
``append`` adds one schema-versioned JSON line to ``results/bench/history.jsonl``: the
key metrics of each ``BENCH_*.json`` artifact present, the unified
cost-ledger totals, the git SHA, and a digest of the solver/serve
configuration the run used.  The compare tool then flags regressions
between any two records::

    python -m repro_torch.obs.history append   --bench-dir results/bench
    python -m repro_torch.obs.history compare  --history results/bench/history.jsonl
    python -m repro_torch.obs.history compare  --baseline results/bench/history_baseline.json

Gating is deterministic-only (CI never compares wall clock):
metrics whose spec carries a direction + tolerance are gated — row-iter
counts and iteration-ratio speedups are bitwise-reproducible for a
fixed config, so ``exact`` metrics must match and ratio metrics may not
regress beyond ``rtol``.  Wall-clock metrics (``rtol=None``) are
recorded for trend inspection but never fail the compare.  Records from
runs with different ``smoke`` flags or config digests measure different
workloads; compare skips those pairs with a warning instead of raising.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = [
    "SCHEMA_VERSION",
    "METRICS",
    "MetricSpec",
    "collect",
    "append",
    "load_history",
    "compare",
    "main",
]

SCHEMA_VERSION = 1

DEFAULT_BENCH_DIR = Path("results/bench")
DEFAULT_HISTORY = DEFAULT_BENCH_DIR / "history.jsonl"


@dataclass(frozen=True)
class MetricSpec:
    """One tracked metric: where it lives and how it gates.

    ``path`` is a dotted key path inside the ``artifact`` JSON.
    ``direction`` is ``"exact"`` (deterministic counter — any change is
    a regression), ``"higher"`` (bigger is better) or ``"lower"``
    (smaller is better).  ``rtol`` is the relative slack for ratio
    metrics; ``None`` means record-only — the metric is written to the
    history but never gates (wall clock stays out of CI).
    """
    name: str
    artifact: str
    path: str
    direction: str = "exact"
    rtol: float | None = None


METRICS: tuple[MetricSpec, ...] = (
    # Deterministic row-iteration counts / ratios — gate these.
    MetricSpec("obs.row_iters", "BENCH_obs.json", "row_iters", "exact", 0.0),
    MetricSpec("serve.poisson.row_iters_x", "BENCH_serve.json",
               "traces.poisson.speedup.row_iters", "higher", 0.05),
    MetricSpec("serve.bursty.row_iters_x", "BENCH_serve.json",
               "traces.bursty.speedup.row_iters", "higher", 0.05),
    MetricSpec("serve.heavy_tail.row_iters_x", "BENCH_serve.json",
               "traces.heavy_tail.speedup.row_iters", "higher", 0.05),
    MetricSpec("compaction.flop_ratio", "BENCH_compaction.json",
               "path.accept.flop_ratio", "higher", 0.05),
    MetricSpec("path.ratio_vs_cold_batched", "BENCH_path.json",
               "path.accept.ratio_vs_cold_batched", "higher", 0.05),
    MetricSpec("health.quarantine_ticks_nan", "BENCH_health.json",
               "nan.quarantine_tick", "lower", 0.0),
    MetricSpec("health.quarantine_ticks_stall", "BENCH_health.json",
               "stall.quarantine_tick", "lower", 0.0),
    MetricSpec("remote.cells_ok", "BENCH_remote.json",
               "accept.cells_ok", "exact", 0.0),
    MetricSpec("remote.drain_completed", "BENCH_remote.json",
               "drain.completed", "exact", 0.0),
    # Wall-clock / machine-dependent — record-only (rtol None).
    MetricSpec("obs.overhead_frac", "BENCH_obs.json", "overhead_frac",
               "lower", None),
    MetricSpec("serve.poisson.makespan_x", "BENCH_serve.json",
               "traces.poisson.speedup.makespan", "higher", None),
    MetricSpec("serve.heavy_tail.p99_x", "BENCH_serve.json",
               "traces.heavy_tail.speedup.p99_latency", "higher", None),
    MetricSpec("remote.max_dev", "BENCH_remote.json",
               "accept.max_dev", "lower", None),
)

# Cost-ledger totals copied verbatim into each record (BENCH_obs.json).
_LEDGER_ARTIFACT = "BENCH_obs.json"

# Config sections whose sha256 identifies "same workload" for compare.
_CONFIG_SOURCES = (
    ("BENCH_obs.json", ("solver_cfg", "serve_cfg")),
    ("BENCH_serve.json", ("solver_cfg", "serve_cfg")),
)


def _dig(obj, path: str):
    for key in path.split("."):
        if not isinstance(obj, dict) or key not in obj:
            return None
        obj = obj[key]
    return obj


def _git_sha(cwd: Path) -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except OSError:
        pass
    return "unknown"


def _config_digest(artifacts: dict[str, dict]) -> str:
    sections = {}
    for name, keys in _CONFIG_SOURCES:
        art = artifacts.get(name)
        if art:
            for k in keys:
                if k in art:
                    sections[f"{name}:{k}"] = art[k]
    blob = json.dumps(sections, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def collect(bench_dir: Path | str = DEFAULT_BENCH_DIR, *,
            smoke: bool | None = None,
            t: float | None = None) -> dict:
    """Build one history record from the ``BENCH_*.json`` artifacts.

    Missing artifacts simply omit their metrics — a ``--skip-serve``
    run still records what it measured.  ``smoke`` defaults to the
    ``smoke`` flag of the obs artifact when present.
    """
    bench_dir = Path(bench_dir)
    artifacts: dict[str, dict] = {}
    for spec in METRICS:
        if spec.artifact not in artifacts:
            p = bench_dir / spec.artifact
            if p.exists():
                artifacts[spec.artifact] = json.loads(p.read_text())

    metrics = {}
    for spec in METRICS:
        art = artifacts.get(spec.artifact)
        if art is None:
            continue
        v = _dig(art, spec.path)
        if v is not None:
            metrics[spec.name] = v

    if smoke is None:
        obs = artifacts.get(_LEDGER_ARTIFACT) or {}
        smoke = bool(obs.get("smoke", False))

    record = {
        "schema": SCHEMA_VERSION,
        "t": time.time() if t is None else float(t),
        "git_sha": _git_sha(bench_dir),
        "config_digest": _config_digest(artifacts),
        "smoke": bool(smoke),
        "metrics": metrics,
    }
    ledger = (artifacts.get(_LEDGER_ARTIFACT) or {}).get("ledger")
    if ledger:
        record["ledger"] = dict(ledger)
    return record


def append(record: dict, history_path: Path | str = DEFAULT_HISTORY) -> Path:
    """Append one record as a JSON line (parents created as needed)."""
    path = Path(history_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")
    return path


def load_history(history_path: Path | str = DEFAULT_HISTORY) -> list[dict]:
    path = Path(history_path)
    if not path.exists():
        return []
    records = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if line:
            records.append(json.loads(line))
    return records


def _spec_by_name() -> dict[str, MetricSpec]:
    return {s.name: s for s in METRICS}


def compare(current: dict, baseline: dict) -> tuple[list[dict], list[str]]:
    """Gate ``current`` against ``baseline``.

    Returns ``(regressions, warnings)``.  A regression dict carries the
    metric name, both values, and the reason.  Pairs that measure
    different workloads (schema / smoke flag / config digest mismatch)
    yield a warning and no regressions — comparing them would be noise,
    not signal.
    """
    warnings: list[str] = []
    if baseline.get("schema") != current.get("schema"):
        warnings.append(
            f"schema mismatch (baseline {baseline.get('schema')} vs "
            f"current {current.get('schema')}): skipping compare")
        return [], warnings
    if bool(baseline.get("smoke")) != bool(current.get("smoke")):
        warnings.append(
            "smoke flag mismatch (baseline vs current measure different "
            "workloads): skipping compare")
        return [], warnings
    if (baseline.get("config_digest") and current.get("config_digest")
            and baseline["config_digest"] != current["config_digest"]):
        warnings.append(
            "config digest mismatch (workload changed): skipping compare")
        return [], warnings

    specs = _spec_by_name()
    regressions: list[dict] = []
    base_m = baseline.get("metrics", {})
    cur_m = current.get("metrics", {})
    for name, base in base_m.items():
        spec = specs.get(name)
        if spec is None or spec.rtol is None:
            continue                      # unknown or record-only metric
        cur = cur_m.get(name)
        if cur is None:
            regressions.append({
                "metric": name, "baseline": base, "current": None,
                "reason": "metric missing from current record"})
            continue
        bad, reason = _gate(spec, float(base), float(cur))
        if bad:
            regressions.append({
                "metric": name, "baseline": base, "current": cur,
                "reason": reason})
    return regressions, warnings


def _gate(spec: MetricSpec, base: float, cur: float) -> tuple[bool, str]:
    rtol = spec.rtol or 0.0
    if spec.direction == "exact":
        if cur != base:
            return True, f"deterministic metric changed ({base} -> {cur})"
        return False, ""
    if spec.direction == "higher":
        floor = base * (1.0 - rtol)
        if cur < floor:
            return True, (f"regressed below {floor:.6g} "
                          f"(baseline {base}, rtol {rtol})")
        return False, ""
    if spec.direction == "lower":
        ceil = base * (1.0 + rtol)
        if cur > ceil:
            return True, (f"regressed above {ceil:.6g} "
                          f"(baseline {base}, rtol {rtol})")
        return False, ""
    return False, ""


# -- CLI -------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.history",
        description="Append / compare persistent bench-history records.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ap_append = sub.add_parser(
        "append", help="collect BENCH_*.json metrics into history.jsonl")
    ap_append.add_argument("--bench-dir", default=str(DEFAULT_BENCH_DIR))
    ap_append.add_argument("--history", default=None,
                           help="history file (default <bench-dir>/"
                                "history.jsonl)")

    ap_cmp = sub.add_parser(
        "compare", help="gate the newest record against a baseline")
    ap_cmp.add_argument("--history", default=str(DEFAULT_HISTORY))
    ap_cmp.add_argument("--baseline", default=None,
                        help="baseline record JSON file; default: the "
                             "previous record in the history")
    args = ap.parse_args(argv)

    if args.cmd == "append":
        bench_dir = Path(args.bench_dir)
        history = (Path(args.history) if args.history
                   else bench_dir / "history.jsonl")
        record = collect(bench_dir)
        if not record["metrics"]:
            print("history: no BENCH_*.json artifacts found, nothing to "
                  "append", file=sys.stderr)
            return 1
        append(record, history)
        print(f"history: appended {len(record['metrics'])} metrics "
              f"(sha {record['git_sha'][:12]}) to {history}")
        return 0

    records = load_history(args.history)
    if not records:
        print(f"history: {args.history} is empty or missing",
              file=sys.stderr)
        return 1
    current = records[-1]
    if args.baseline:
        baseline = json.loads(Path(args.baseline).read_text())
        if isinstance(baseline, list):
            baseline = baseline[-1]
    else:
        if len(records) < 2:
            print("history: only one record — nothing to compare against")
            return 0
        baseline = records[-2]

    regressions, warnings = compare(current, baseline)
    for w in warnings:
        print(f"history: warning: {w}")
    for r in regressions:
        print(f"history: REGRESSION {r['metric']}: "
              f"{r['baseline']} -> {r['current']} ({r['reason']})")
    if regressions:
        return 1
    n = sum(1 for name in baseline.get("metrics", {})
            if _spec_by_name().get(name)
            and _spec_by_name()[name].rtol is not None)
    print(f"history: OK — {n} gated metrics within tolerance")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
