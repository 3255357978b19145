#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card, ``nvcc`` and
``nvidia-smi``, and exits non-zero (printing no result) when CUDA is
unavailable or the port's sources are missing.  Phases, each one line,
each failing the run when its check fails:

1. setup    — the card's name and power limit, torch/CUDA versions, and
               the build of the CUDA kernels from ``csrc/`` (seconds).
2. kernels  — ``gather_rows`` / ``scatter_rows`` against their plain torch
               versions on the card (exact equality: pure data movement)
               over a sweep that includes the fig1d shapes, ragged C,
               all-padding, K = 1 and bf16/fp16 sources.
3. goldens  — ``tests/golden/flexa_lasso_V.json`` and
               ``path_lasso_compact_V.json`` on the card, at the tests'
               tolerances.
4. solo     — the paper's fig1d Lasso (m=5000, n=100000, 5% nnz) through
               ``FlexaClient().run(SoloSpec(...))``, methods ``flexa`` and
               ``flexa_compiled``, 1000 iterations each; ms per iteration
               beside the two-GEMV bound.
5. path     — the main path: ``FlexaClient().run(PathSpec(..., compact=
               True))`` at fig1d, with the kernels' launch counters set to
               0 just before and read just after (both must be > 0), and
               their CUDA-event time as a share of the path.
6. compact  — the compacted path against the masked-dense path at fig1b
               (m=2000, n=10000, 10% nnz) on the golden grid.

Then a ``{"kernels": [...]}`` line (device time, plain time, library
time and bound of each kernel at the path's shapes) and, last, the
device line.
"""
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "golden"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FIG1D = dict(m=5000, n=100_000, nnz_frac=0.05, c=1.0, seed=0)
FIG1B = dict(m=2000, n=10_000, nnz_frac=0.10, c=1.0, seed=0)
SOLO_ITERS = 1000
GATHER_KS = (4096, 16384, 65536)   # capacity buckets timed on Aᵀ at fig1d
VECTOR_K = 65536                   # bucket of the (n, 1) vector gathers
PADDED_K_VALID = 35926             # active rows in the 65536 bucket on the path
REPLACES = {"gather_rows": "src/repro/kernels/flexa_prox.py:278",
            "scatter_rows": "src/repro/kernels/flexa_prox.py:308"}
SOURCE = "src/repro_torch/kernels/csrc/compact_rows.cu"


class PhaseError(Exception):
    pass


def check(ok, what):
    if not ok:
        raise PhaseError(what)


def say(phase, **fields):
    print(f"{phase}: " + json.dumps(fields, sort_keys=False), flush=True)


def cuda_ms(torch, fn, reps=20):
    """Mean CUDA-event time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(torch, fn, reps=20, replays=5):
    """Device time of one ``fn`` call: ``reps`` calls captured in one CUDA
    graph and replayed, so the host's launch overhead is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(torch, graph.replay, reps=replays) / reps
    del graph
    return ms


def bytes_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------- phases
def phase_setup(torch, fp):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    fp.build(verbose=True)
    fp.library()
    say("setup", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        build_s=round(fp.build_seconds, 3))
    return card


def _plan(torch, n_rows, k_valid, cap, seed, dev):
    """Sorted distinct active rows (k_valid of them) padded with −1 to
    ``cap``, and the inverse permutation; int32 on ``dev``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    act = torch.randperm(n_rows, generator=g)[:k_valid].sort().values
    idx = torch.full((cap,), -1, dtype=torch.int32)
    idx[:k_valid] = act.to(torch.int32)
    inv = torch.full((n_rows,), -1, dtype=torch.int32)
    inv[act] = torch.arange(k_valid, dtype=torch.int32)
    return idx.to(dev), inv.to(dev)


def phase_kernels(torch, fp, dev):
    err = {"gather_rows": 0.0, "scatter_rows": 0.0}
    times = {}

    def compare(name, got, want):
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{name}: {got.dtype}{tuple(got.shape)} vs "
              f"{want.dtype}{tuple(want.shape)}")
        e = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        err[name] = max(err[name], e)
        check(torch.equal(got, want), f"{name} differs from its plain "
              f"version (max abs err {e})")

    def case(n_rows, C, k_valid, cap, dtype, seed, timed=False):
        src = torch.randn((n_rows, C), device=dev).to(dtype)
        idx, inv = _plan(torch, n_rows, k_valid, cap, seed, dev)
        got = fp.gather_rows(src, idx)
        compare("gather_rows", got, fp.gather_rows.plain(src, idx))
        vals = torch.randn((cap, C), device=dev)
        base = torch.randn((n_rows, C), device=dev).to(dtype)
        compare("scatter_rows", fp.scatter_rows(vals, inv, base),
                fp.scatter_rows.plain(vals, inv, base))
        if timed:
            key = f"gather {n_rows}x{C} K={cap} valid={k_valid}"
            times[key] = round(graph_ms(
                torch, lambda: fp.gather_rows(src, idx)), 4)
        del src, vals, base, got

    n, m = FIG1D["n"], FIG1D["m"]
    for K in GATHER_KS:                     # pack_columns on Aᵀ at fig1d
        case(n, m, K, K, torch.float32, K, timed=True)
    # a padded bucket, as the path packs it (zero rows past the support)
    case(n, m, PADDED_K_VALID, GATHER_KS[-1], torch.float32, 9, timed=True)
    case(n, 1, VECTOR_K, VECTOR_K, torch.float32, 1)   # the (n, 1) vectors
    case(n, 1, VECTOR_K * 5 // 8, VECTOR_K, torch.float32, 2)   # padding
    for C in (37, 300, 4999):                     # ragged C
        case(1000, C, 300, 512, torch.float32, C)
    case(1000, 300, 0, 64, torch.float32, 3)      # every slot −1
    case(1000, 300, 1, 1, torch.float32, 4)       # K = 1
    case(1000, 1, 1, 1, torch.float32, 5)
    for dt in (torch.bfloat16, torch.float16):
        case(2000, 520, 700, 1024, dt, 6)
        case(2000, 1, 700, 1024, dt, 7)
    # mixed value/base dtypes of the scatter
    vals = torch.randn((64, 40), device=dev).to(torch.bfloat16)
    idx, inv = _plan(torch, 300, 50, 64, 8, dev)
    for bdt in (torch.float32, torch.float16):
        base = torch.randn((300, 40), device=dev).to(bdt)
        compare("scatter_rows", fp.scatter_rows(vals, inv, base),
                fp.scatter_rows.plain(vals, inv, base))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say("kernels", max_abs_err=err, gather_ms=times)
    return err


def phase_goldens(torch, dev):
    from repro_torch.client import FlexaClient, PathSpec, SoloSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.problems.lasso import nesterov_instance

    gold = json.loads((GOLDEN / "flexa_lasso_V.json").read_text())
    p = nesterov_instance(**gold["instance"], device=dev)
    r = FlexaClient(solver=SolverConfig(**gold["budget"],
                                        **gold["cfg_overrides"])).run(
        SoloSpec(problem=p))
    V = r.history["V"]
    check(len(V) == len(gold["V"]), "flexa golden: iteration count")
    rel_v = max(abs(a - b) / abs(b) for a, b in zip(V, gold["V"]))
    check(rel_v <= 5e-4, f"flexa golden: V rel err {rel_v}")

    gold = json.loads((GOLDEN / "path_lasso_compact_V.json").read_text())
    p = nesterov_instance(**gold["instance"], device=dev)
    r = FlexaClient(solver=SolverConfig(**gold["cfg"])).run(
        PathSpec(problem=p, compact=True, **gold["grid"]))
    rel_p = max(abs(a - b) / abs(b) for a, b in zip(r.V, gold["V"]))
    check(rel_p <= 5e-4, f"path golden: V rel err {rel_p}")
    check(abs(r.lam_max - gold["lam_max"]) <= 1e-6 * gold["lam_max"],
          "path golden: lam_max")
    check([int(s) for s in r.support] == gold["support"],
          f"path golden: support {list(r.support)}")
    check(r.meta["program_widths"] == gold["program_widths"],
          f"path golden: widths {r.meta['program_widths']}")
    flops_rel = abs(r.device_flops - gold["device_flops"]) \
        / gold["device_flops"]
    check(flops_rel <= 0.02, f"path golden: device_flops {r.device_flops}")
    say("goldens", flexa_V_rel_err=rel_v, path_V_rel_err=rel_p,
        support=[int(s) for s in r.support],
        program_widths=r.meta["program_widths"],
        device_flops=r.device_flops, golden_device_flops=gold[
            "device_flops"])


def phase_solo(torch, dev):
    from repro_torch.client import FlexaClient, SoloSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.core import flexa
    from repro_torch.problems.lasso import nesterov_instance

    t0 = time.perf_counter()
    p = nesterov_instance(**FIG1D, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    A, b = p.data["A"], p.data["b"]
    x = torch.zeros(p.n, device=dev)

    def two_gemv():
        A.T @ (A @ x - b)

    gemv_ms = graph_ms(torch, two_gemv)
    bound_ms = bytes_ms(2 * A.numel() * 4)
    # Device time of one iteration (captured in a CUDA graph): what the
    # card spends when the host is not in the way.
    cfg = SolverConfig(max_iters=SOLO_ITERS, tol=-1.0)
    tau = flexa._base_tau(p, cfg)
    state = flexa.init_state(p, x, cfg)
    iter_device_ms = graph_ms(
        torch, lambda: flexa.flexa_iteration(p, cfg, tau, state), reps=10)
    client = FlexaClient(solver=cfg)
    v0 = float(p.v(x))
    out, xs = {}, {}
    for method in ("flexa", "flexa_compiled"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = client.run(SoloSpec(problem=p, method=method))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(r.iters == SOLO_ITERS and r.x.shape == (p.n,), method)
        v = float(p.v(torch.as_tensor(r.x, device=dev)))
        check(math.isfinite(v), f"{method}: V {v} (V at x=0: {v0})")
        xs[method] = r.x
        out[method] = {"ms_per_iter": round(wall / SOLO_ITERS * 1e3, 4),
                       "V_rel_err": (v - p.v_star) / p.v_star}
    dx = float(abs(xs["flexa"] - xs["flexa_compiled"]).max())
    check(dx <= 1e-5, f"flexa vs flexa_compiled: max |dx| {dx}")
    say("solo", instance="fig1d", gen_s=round(gen_s, 2),
        two_gemv_ms=round(gemv_ms, 4), two_gemv_bound_ms=round(bound_ms, 4),
        iter_device_ms=round(iter_device_ms, 4),
        max_dx_methods=dx, **out)
    return p


def phase_path(torch, fp, p):
    """The main path, with each kernel launch and pack_columns call timed
    by CUDA events recorded around it (the wrappers count launches).

    The timing shims stand in for the dispatch's reference to the
    kernel module (``ops._fp``): the wrappers look their own names up in
    that module to count launches, so the module's attributes stay."""
    from repro_torch.client import FlexaClient, PathSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.kernels import ops
    from repro_torch.obs import trace as obs
    from repro_torch.path.driver import _problem_at
    from repro_torch.path.screening import block_scores
    from repro_torch.problems.families import get_family
    from repro_torch.solvers import compaction

    events = {"gather_rows": [], "gather_rows_wide": [],
              "scatter_rows": [], "pack_columns": []}

    def timed(key, fn):
        def wrapper(*args):
            t0, t1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            t0.record()
            out = fn(*args)
            t1.record()
            events[key].append((t0, t1))
            return out
        return wrapper

    gather, scatter = fp.gather_rows, fp.scatter_rows
    pack_columns = compaction.CompactPlan.pack_columns
    dispatch_fp = ops._fp

    def gather_shim(src, idx):
        key = "gather_rows_wide" if src.shape[1] > 1 else "gather_rows"
        return timed(key, gather)(src, idx)

    def scatter_shim(vals, inv, base):
        return timed("scatter_rows", scatter)(vals, inv, base)

    ops._fp = types.SimpleNamespace(gather_rows=gather_shim,
                                    scatter_rows=scatter_shim)
    compaction.CompactPlan.pack_columns = timed("pack_columns",
                                                pack_columns)
    client = FlexaClient(solver=SolverConfig(tol=1e-6, max_iters=20000))
    spec = PathSpec(problem=p, n_points=10, lam_min_ratio=0.1, compact=True)
    tracer = obs.Tracer()
    try:
        gather.launches = scatter.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        with obs.tracing(tracer):
            r = client.run(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {"gather_rows": gather.launches,
                    "scatter_rows": scatter.launches}
    finally:
        ops._fp = dispatch_fp
        compaction.CompactPlan.pack_columns = pack_columns
    check(launches["gather_rows"] > 0 and launches["scatter_rows"] > 0,
          f"kernel not launched on the path: {launches}")
    check(bool(r.converged.all()), f"path not converged: {r.converged}")
    check(bool((r.x[0] == 0).all()) and r.support[-1] > 0, "path support")
    fam = get_family("lasso")
    kkt = 0.0
    for k, lam in enumerate(r.lambdas):
        pk = _problem_at(p, float(lam))
        s = block_scores(fam, pk, r.x[k])
        zero = r.x[k] == 0
        if zero.any():
            kkt = max(kkt, float((s[zero] - lam).max() / lam))
    check(kkt <= 1e-3, f"KKT violated on zero blocks: {kkt}")
    spans = {k: [a.elapsed_time(b) for a, b in v] for k, v in events.items()}
    ms = {k: sum(v) for k, v in spans.items()}
    # host wall time of each solved point (the driver reads every point's
    # result back, so its span ends after the device work)
    point_s = [0.0] * len(r.lambdas)
    for sp in tracer.spans:
        if sp.name == "path.point":
            point_s[sp.args["k"]] = round(sp.t1 - sp.t0, 3)
    gather_wide_ms = ms["gather_rows_wide"]
    kernel_ms = ms["gather_rows"] + gather_wide_ms + ms["scatter_rows"]
    say("path", instance="fig1d", wall_s=round(wall, 3),
        point_wall_s=point_s,
        iters=[int(i) for i in r.iters],
        support=[int(s) for s in r.support],
        active_blocks=[int(a) for a in r.active_blocks],
        program_widths=r.meta["program_widths"],
        device_flops=r.device_flops,
        # every iteration reads its (m × width) matrix twice, fp32
        gemv_bound_s=round(bytes_ms(8 * r.device_flops) / 1e3, 3),
        launches=launches,
        kernel_event_ms=round(kernel_ms, 3),
        # per wrapper: calls, summed and longest event span (ms)
        event_ms={k: [len(v), round(sum(v), 3), round(max(v, default=0), 3)]
                  for k, v in spans.items()},
        kernel_share=kernel_ms / (wall * 1e3),
        transposed_copy_ms=round(ms["pack_columns"] - gather_wide_ms, 3),
        pack_columns_calls=len(events["pack_columns"]),
        max_zero_block_kkt=kkt)
    return r, launches


def phase_compact_vs_dense(torch, dev):
    from repro_torch.client import FlexaClient, PathSpec
    from repro_torch.config.base import SolverConfig
    from repro_torch.problems.lasso import nesterov_instance

    p = nesterov_instance(**FIG1B, device=dev)
    client = FlexaClient(solver=SolverConfig(tol=1e-7, max_iters=20000,
                                             tau_adapt=False))
    runs, secs = {}, {}
    for compact in (True, False):
        t = time.perf_counter()
        runs[compact] = client.run(PathSpec(problem=p, n_points=10,
                                            lam_min_ratio=0.05,
                                            compact=compact))
        torch.cuda.synchronize()
        secs[compact] = round(time.perf_counter() - t, 3)
    c, d = runs[True], runs[False]
    dx = float(abs(c.x - d.x).max())
    one_only = (c.x != 0) != (d.x != 0)
    worst = float(max(abs(c.x[one_only]).max(initial=0.0),
                      abs(d.x[one_only]).max(initial=0.0)))
    check(dx <= 1e-5, f"compact vs dense: max |dx| {dx}")
    check(worst <= 1e-5, f"block nonzero in one path only: |x| {worst}")
    check(c.device_flops < d.device_flops, "compaction saved no FLOPs")
    say("compact", instance="fig1b", max_abs_dx=dx,
        iters_compact=[int(i) for i in c.iters],
        iters_dense=[int(i) for i in d.iters],
        converged_compact=[bool(v) for v in c.converged],
        converged_dense=[bool(v) for v in d.converged],
        blocks_in_one_path_only=int(one_only.sum()),
        max_abs_x_in_one_path_only=worst,
        supports_equal=bool((c.support == d.support).all()),
        flops_ratio=d.device_flops / c.device_flops,
        compact_s=secs[True], dense_s=secs[False])


def kernel_line(torch, fp, r, launches, err, dev):
    """Each kernel timed at the path's largest shapes: the gather of Aᵀ
    at the widest bucket K (a full bucket, so ``index_select`` computes
    the same function), and the scatter of K values into (n, 1).

    ``ms``, ``plain_ms`` and ``library_ms`` are device times (calls
    replayed from a CUDA graph); ``eager_ms`` is the kernel's time per
    call when launched from Python back to back, host overhead
    included."""
    n, m = FIG1D["n"], FIG1D["m"]
    K = max(r.meta["program_widths"])
    src = torch.randn((n, m), device=dev)
    idx, inv = _plan(torch, n, K, K, 11, dev)
    idx64 = idx.to(torch.int64)
    g = {"ms": graph_ms(torch, lambda: fp.gather_rows(src, idx)),
         "eager_ms": cuda_ms(torch, lambda: fp.gather_rows(src, idx)),
         "plain_ms": graph_ms(torch, lambda: fp.gather_rows.plain(src, idx)),
         "library_ms": graph_ms(torch,
                                lambda: torch.index_select(src, 0, idx64)),
         "bound_ms": bytes_ms(2 * K * m * 4 + K * 4)}
    del src
    vals = torch.randn((K, 1), device=dev)
    base = torch.randn((n, 1), device=dev)
    s = {"ms": graph_ms(torch, lambda: fp.scatter_rows(vals, inv, base)),
         "eager_ms": cuda_ms(torch,
                             lambda: fp.scatter_rows(vals, inv, base)),
         "plain_ms": graph_ms(torch,
                              lambda: fp.scatter_rows.plain(vals, inv, base)),
         "library_ms": graph_ms(torch, lambda: torch.index_copy(
             base, 0, idx64, vals)),
         # inv, the K values and the n − K kept base rows in; n rows out
         "bound_ms": bytes_ms(n * 4 + K * 4 + (n - K) * 4 + n * 4)}
    rows = []
    for name, t, shape in (("gather_rows", g, f"src ({n}, {m}) K={K}"),
                           ("scatter_rows", s, f"base ({n}, 1) K={K}")):
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name],
                     "launches": launches[name],
                     "max_abs_err": err[name],
                     "ms": round(t["ms"], 5),
                     "plain_ms": round(t["plain_ms"], 5),
                     "bound_ms": round(t["bound_ms"], 5),
                     "bound_by": "bytes",
                     "library_ms": round(t["library_ms"], 5),
                     "eager_ms": round(t["eager_ms"], 5),
                     "shape": shape})
    return rows


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 3
    from repro_torch.kernels import flexa_prox as fp

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase = "setup"
    try:
        card = phase_setup(torch, fp)
        phase = "kernels"
        err = phase_kernels(torch, fp, dev)
        phase = "goldens"
        phase_goldens(torch, dev)
        phase = "solo"
        p = phase_solo(torch, dev)
        phase = "path"
        r, launches = phase_path(torch, fp, p)
        del p
        torch.cuda.empty_cache()
        phase = "compact"
        phase_compact_vs_dense(torch, dev)
        phase = "kernel timing"
        rows = kernel_line(torch, fp, r, launches, err, dev)
    except Exception as exc:                          # report and fail
        print(f"FAIL {phase}: {type(exc).__name__}: {exc}", flush=True)
        raise
    say("done", total_s=round(time.perf_counter() - t_start, 2))
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
