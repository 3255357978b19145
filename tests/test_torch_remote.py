"""The port's solver service against the JAX package's, and live.

Three layers:

1. **The wire** (no server): the port's codecs against
   ``repro.remote.protocol``.  The same instance, spec or array encodes
   to the same message in both packages, and a message encoded by one
   decodes in the other with arrays bit for bit and ``SCHEMA`` 1: arrays
   of four dtypes (and a tensor), the problems of all four families, the
   four spec kinds, and the four result kinds (each package's inline
   result decoded by the other).
2. **Policy** (no server, no clock): ``repro_torch.remote.policy``
   against ``repro.remote.policy`` — the cases of
   ``tests/test_remote_policy.py`` replayed through both, plus seeded
   random event sequences; the same admits, rejections, tokens and
   stats.
3. **The live server** (``python -m repro_torch.remote.server --device
   cpu``, one module-scoped process at the calibrated equivalence config
   ``--tol 1e-7 --max-iters 4000 --no-tau-adapt``): remote ≡ inline
   within 1e-5 for Lasso and logreg solos and a group-Lasso path, the
   ``remote_url`` requirement, the remote modules imported only by the
   first remote client, a score callable refused, the typed
   in-flight quota rejection, a past deadline answered as
   ``status="timeout"``, and SIGTERM with a ticket in flight draining
   with exit 0.
"""
import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.client import (BatchSpec as JBatchSpec, CVSpec as JCVSpec,
                          FlexaClient as JClient, PathSpec as JPathSpec,
                          SoloSpec as JSoloSpec, normalize as jnormalize)
from repro.config.base import SolverConfig as JSolverConfig
from repro.problems.group_lasso import nesterov_group_instance as jgroup
from repro.problems.lasso import nesterov_instance as jnesterov
from repro.problems.logreg import random_logreg_instance as jlogreg
from repro.problems.svm import random_svm_instance as jsvm
from repro.remote import policy as jpolicy
from repro.remote import protocol as jprotocol
from repro.serve.continuous import AdmissionQueue as JQueue
from repro.serve.continuous import QueueEntry as JEntry
from repro_torch.client import (BatchSpec, ClientError, CVSpec, FlexaClient,
                                PathSpec, SoloSpec, UnsupportedWorkloadError,
                                normalize)
from repro_torch.config.base import ClientConfig, SolverConfig
from repro_torch.problems.families import problem_from_arrays
from repro_torch.remote import policy, protocol
from repro_torch.serve.continuous import AdmissionQueue, QueueEntry

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(tol=1e-7, max_iters=4000, tau_adapt=False)
SERVER_ARGS = ["--tol", "1e-7", "--max-iters", "4000", "--no-tau-adapt"]

#: The reference instance of each family (the shapes of
#: tests/test_remote.py and tests/test_client.py).
JINSTANCES = {
    "lasso": lambda s: jnesterov(m=24, n=64, nnz_frac=0.1, c=1.0, seed=s),
    "group_lasso": lambda s: jgroup(m=24, n_blocks=16, block_size=4,
                                    nnz_frac=0.25, c=1.0, seed=s),
    "logreg": lambda s: jlogreg(m=24, n=48, nnz_frac=0.15, c=0.5, seed=s),
    "svm": lambda s: jsvm(m=24, n=40, nnz_frac=0.2, c=0.5, seed=s),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small eager solves: one intra-op thread keeps them off the other
    workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(pj):
    return problem_from_arrays(
        pj.family, {k: np.asarray(v) for k, v in pj.data.items()},
        pj.g_weight, block_size=pj.block_size, device="cpu")


def _wire(msg):
    """A message as the other end reads it (through JSON text)."""
    return json.loads(protocol.dumps(msg))


# ------------------------------------------------------------------ #
# 1a. Arrays                                                         #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "bool"])
def test_array_codec_matches_reference(dtype):
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((3, 5)) * 10).astype(dtype)
    mine, ref = protocol.encode_array(a), jprotocol.encode_array(a)
    assert mine == ref
    for out in (jprotocol.decode_array(_wire(mine)),
                protocol.decode_array(_wire(ref))):
        assert out.dtype == a.dtype and out.shape == a.shape
        assert out.tobytes() == a.tobytes()
    # a tensor encodes as its host array
    assert protocol.encode_array(torch.from_numpy(a)) == ref
    out = protocol.decode_array(ref)
    out[0, 0] = out[0, 1]                   # decoded arrays are writable
    assert protocol.encode_array(None) is None
    assert protocol.decode_array(None) is None
    with pytest.raises(protocol.ProtocolError, match="not an encoded"):
        protocol.decode_array({"dtype": "float32"})


def test_dumps_coerces_numpy_and_torch_scalars():
    obj = {"a": np.float64(0.5), "b": np.int32(3), "c": np.bool_(True),
           "d": torch.tensor(2.5), "e": torch.tensor([1, 2]),
           "f": np.arange(3)}
    assert json.loads(protocol.dumps(obj)) == {
        "a": 0.5, "b": 3, "c": True, "d": 2.5, "e": [1, 2], "f": [0, 1, 2]}
    with pytest.raises(TypeError):
        protocol.dumps({"x": object()})
    with pytest.raises(protocol.ProtocolError, match="JSON object"):
        protocol.loads(b"[1]")


# ------------------------------------------------------------------ #
# 1b. Problems and specs                                             #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("family", sorted(JINSTANCES))
def test_problem_codec_matches_reference(family):
    pj = JINSTANCES[family](0)
    pt = _port(pj)
    mine, ref = protocol.encode_problem(pt), jprotocol.encode_problem(pj)
    assert mine == ref                       # one message, byte for byte
    q = protocol.decode_problem(_wire(ref), "cpu")
    qj = jprotocol.decode_problem(_wire(mine))
    assert (q.family, q.n, q.block_size, q.g_kind, float(q.g_weight)) == \
        (qj.family, qj.n, qj.block_size, qj.g_kind, float(qj.g_weight))
    assert set(q.data) == set(ref["data"])
    for k in ref["data"]:
        assert q.data[k].device.type == "cpu"
        assert q.data[k].numpy().tobytes() == np.asarray(
            qj.data[k]).tobytes() == np.asarray(pj.data[k],
                                                np.float32).tobytes()
    # the rebuilt port problem computes what the original does
    x = torch.linspace(-1, 1, pt.n)
    assert float(q.f(x)) == float(pt.f(x))


def _specs(family):
    """(port spec, reference spec) of each kind on one family's data."""
    pjs = [JINSTANCES[family](s) for s in range(2)]
    pts = [_port(p) for p in pjs]
    n = pts[0].n
    x0 = np.linspace(-1e-3, 1e-3, n).astype(np.float32)
    val = [(np.full((4, n), 0.5, np.float32), np.ones(4, np.float32))
           for _ in pjs]
    lam = np.array([1.0, 0.5, 0.25])
    path = dict(lambdas=lam, warm=False, screen=True, kkt_slack=1e-3)
    return {
        "solo": (SoloSpec(problem=pts[0], x0=x0),
                 JSoloSpec(problem=pjs[0], x0=x0)),
        "batch": (BatchSpec(problems=pts, x0=np.stack([x0, x0]),
                            active=np.ones((2, n), np.float32)),
                  JBatchSpec(problems=pjs, x0=np.stack([x0, x0]),
                             active=np.ones((2, n), np.float32))),
        "path": (PathSpec(problem=pts[0], n_points=4, lam_min_ratio=0.2),
                 JPathSpec(problem=pjs[0], n_points=4, lam_min_ratio=0.2)),
        "cv": (CVSpec(problems=pts, validation=val, tol_coarse=1e-3,
                      n_points=3, **path),
               JCVSpec(problems=pjs, validation=val, tol_coarse=1e-3,
                       n_points=3, **path)),
    }


@pytest.mark.parametrize("kind", ["solo", "batch", "path", "cv"])
def test_spec_codec_matches_reference(kind):
    family = "lasso" if kind in ("path", "cv") else "logreg"
    spec, jspec = _specs(family)[kind]
    mine = protocol.encode_item(normalize(spec, 0))
    ref = jprotocol.encode_item(jnormalize(jspec, 0))
    assert mine == ref and mine["schema"] == 1
    back = protocol.decode_spec(_wire(ref), "cpu")
    jback = jprotocol.decode_spec(_wire(mine))
    assert type(back).__name__ == type(jback).__name__ == type(spec).__name__
    assert protocol.encode_item(normalize(back, 0)) == \
        jprotocol.encode_item(jnormalize(jback, 0)) == ref


def test_unknown_schema_rejected_both_ways():
    spec, jspec = _specs("lasso")["solo"]
    for enc, dec in ((protocol.encode_item(normalize(spec, 0)),
                      jprotocol.decode_spec),
                     (jprotocol.encode_item(jnormalize(jspec, 0)),
                      protocol.decode_spec)):
        enc["schema"] = 2
        with pytest.raises(ValueError, match="schema"):
            dec(enc)
    with pytest.raises(protocol.ProtocolError, match="schema"):
        protocol.decode_result({"schema": 2, "kind": "solo", "result": {}})
    with pytest.raises(protocol.ProtocolError, match="unknown work kind"):
        protocol.decode_spec({"schema": 1, "kind": "nope"}, "cpu")


# ------------------------------------------------------------------ #
# 1c. Results                                                        #
# ------------------------------------------------------------------ #
def _shape(obj):
    """The key structure of a message (dict keys, recursively; list
    elements by their first; arrays by dtype and rank)."""
    if isinstance(obj, dict):
        if obj.get("__nd__") == 1:
            return ("nd", obj["dtype"], len(obj["shape"]))
        return {k: _shape(v) for k, v in obj.items() if k != "meta"}
    if isinstance(obj, list):
        return [_shape(obj[0])] if obj else []
    return type(obj).__name__


def _arrays(obj, out=None):
    """Every array payload of a message, in order."""
    out = [] if out is None else out
    if isinstance(obj, dict):
        if obj.get("__nd__") == 1:
            out.append(protocol.decode_array(obj))
        else:
            for k in sorted(obj):
                _arrays(obj[k], out)
    elif isinstance(obj, list):
        for v in obj:
            _arrays(v, out)
    return out


@pytest.fixture(scope="module")
def inline_results():
    """Each kind's result from both packages' inline clients."""
    client = FlexaClient(device="cpu", solver=SolverConfig(**CFG))
    jclient = JClient(solver=JSolverConfig(**CFG))
    out = {}
    for kind in ("solo", "batch", "path", "cv"):
        spec, jspec = _specs("lasso")[kind]
        if kind == "cv":
            val = [(np.asarray(JINSTANCES["lasso"](9 + s).data["A"]),
                    np.asarray(JINSTANCES["lasso"](9 + s).data["b"]))
                   for s in range(2)]
            spec.validation, jspec.validation = val, val
        out[kind] = (client.run(spec), jclient.run(jspec))
    return out


@pytest.mark.parametrize("kind", ["solo", "batch", "path", "cv"])
def test_result_codec_matches_reference(kind, inline_results):
    res, jres = inline_results[kind]
    mine = _wire(protocol.encode_result(kind, res))
    ref = _wire(jprotocol.encode_result(kind, jres))
    assert _shape(mine) == _shape(ref) and mine["schema"] == 1
    # each package decodes the other's message, arrays bit for bit
    for msg, dec, src in ((mine, jprotocol.decode_result, res),
                          (ref, protocol.decode_result, jres)):
        out = dec(msg, backend="remote")
        again = _wire((jprotocol if dec is protocol.decode_result
                       else protocol).encode_result(kind, out))
        assert [a.tobytes() for a in _arrays(again["result"])] == \
            [a.tobytes() for a in _arrays(msg["result"])]
        assert getattr(out, "raw", None) is None
        if kind in ("path", "cv"):
            paths = [out] if kind == "path" else out.folds
            assert all(p.meta["backend"] == "remote" for p in paths)
        else:
            assert out.backend == "remote"
        if kind == "cv":
            assert (out.best_index, out.best_lambda) == \
                (src.best_index, src.best_lambda)
        if src.ledger is not None:
            assert out.ledger.as_dict() == src.ledger.as_dict()
    # the port's decoded result is the port's class, x on the host
    out = protocol.decode_result(ref)
    assert type(out).__module__.startswith("repro_torch")
    x = out.x_best if kind == "cv" else out.x
    assert isinstance(x, np.ndarray)


# ------------------------------------------------------------------ #
# 2. Policy against the reference                                    #
# ------------------------------------------------------------------ #
def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:                  # noqa: BLE001 — compared
        return (type(e).__name__, getattr(e, "reason", None),
                getattr(e, "tenant", None), str(e))


def _bucket_events(m):
    b = m.TokenBucket(rate=2.0, burst=3.0)
    log = [b.tokens]
    for t in (0.0, 0.0, 0.0, 0.0, 0.4, 1.5, 1.5, 1.5, 1.5, 5.0, 1e9, 2.0,
              2.0, 1e9 + 0.2):
        log.append((b.try_take(t), b.tokens))
    b.refill(1e12)
    log.append(b.tokens)
    log.append(_outcome(lambda: m.TokenBucket(rate=0.0, burst=1.0)))
    log.append(_outcome(lambda: m.TokenBucket(rate=1.0, burst=-1.0)))
    return log


def _quota_events(quota, per_tenant, events):
    def run(m):
        conv = (lambda q: m.TenantQuota(**q))
        pol = m.QuotaPolicy(conv(quota) if quota else None,
                            {t: conv(q) for t, q in per_tenant.items()})
        log = []
        for ev in events:
            if ev[0] == "admit":
                log.append(_outcome(lambda: pol.admit(ev[1], ev[2])))
            else:
                log.append(_outcome(lambda: pol.release(ev[1], *ev[2:])))
        log.append(pol.stats())
        return log
    return run


A, R = "admit", "release"
#: The cases of tests/test_remote_policy.py as event sequences.
POLICY_CASES = {
    "token_bucket": _bucket_events,
    "in_flight_rejection_and_release": _quota_events(
        dict(max_in_flight=2, rate=1e9, burst=1e9), {},
        [(A, "t", 0.0), (A, "t", 0.0), (A, "t", 0.0), (R, "t"),
         (A, "t", 0.0)]),
    "rate_rejection": _quota_events(
        dict(max_in_flight=100, rate=1.0, burst=2.0), {},
        [(A, "t", 0.0), (A, "t", 0.0), (A, "t", 0.0), (R, "t", 2),
         (A, "t", 1.0)]),
    "rejection_is_atomic": _quota_events(
        dict(max_in_flight=1, rate=1.0, burst=1.0), {},
        [(A, "t", 0.0)] + [(A, "t", 1e9)] * 5 + [(R, "t"), (A, "t", 1e9)]),
    "tenants_are_isolated": _quota_events(
        dict(max_in_flight=1, rate=1e9, burst=1e9), {},
        [(A, "a", 0.0), (A, "b", 0.0), (A, "a", 0.0)]),
    "per_tenant_override": _quota_events(
        dict(max_in_flight=1), {"vip": dict(max_in_flight=3)},
        [(A, "vip", 0.0)] * 4 + [(A, "anon", 0.0), (A, "anon", 0.0)]),
    "stats_counters": _quota_events(
        dict(max_in_flight=1, rate=1.0, burst=1.0), {},
        [(A, "t", 0.0), (A, "t", 0.0), (R, "t"), (A, "t", 0.0)]),
    "release_clamps_at_zero": _quota_events(None, {}, [(R, "t", 100)]),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_matches_reference(case):
    run = POLICY_CASES[case]
    got, want = run(policy), run(jpolicy)
    assert got == want
    assert any(o[0] == "QuotaExceeded" for o in want
               if isinstance(o, tuple)) or case in (
        "token_bucket", "release_clamps_at_zero")


@pytest.mark.parametrize("seed", range(4))
def test_policy_random_sequences_match_reference(seed):
    """Seeded random admit / release / clock sequences over three
    tenants (one with its own quota): the same outcomes and stats, and
    0 ≤ tokens ≤ burst throughout."""
    rng = np.random.default_rng(seed)
    t, events = 0.0, []
    for _ in range(200):
        t += float(rng.choice([0.0, 0.01, 0.3, 2.0, -0.5]))
        tenant = str(rng.choice(["a", "b", "vip"]))
        if rng.random() < 0.7:
            events.append((A, tenant, t))
        else:
            events.append((R, tenant, int(rng.integers(1, 3))))
    run = _quota_events(dict(max_in_flight=3, rate=2.0, burst=4.0),
                        {"vip": dict(max_in_flight=6, rate=5.0, burst=2.0)},
                        events)
    got = run(policy)
    assert got == run(jpolicy)
    assert {o[1] for o in got[:-1] if o[0] == "QuotaExceeded"} == \
        {"in_flight", "rate"}
    bucket = policy.TokenBucket(rate=3.0, burst=7.0)
    for ev in events:
        if ev[0] == A:
            bucket.try_take(ev[2])
        assert 0.0 <= bucket.tokens <= bucket.burst


def test_slo_classes_match_reference():
    assert {n: (c.name, c.priority, c.deadline_s, c.doc)
            for n, c in policy.SLO_CLASSES.items()} == \
        {n: (c.name, c.priority, c.deadline_s, c.doc)
         for n, c in jpolicy.SLO_CLASSES.items()}
    for name, now, budget in (("interactive", 100.0, None),
                              ("standard", 3.5, None),
                              ("batch", 100.0, None), ("batch", 10.0, 0.5),
                              ("interactive", 10.0, 0.5)):
        assert policy.resolve_slo(name, now, budget) == \
            jpolicy.resolve_slo(name, now, budget)
    for m in (policy, jpolicy):
        with pytest.raises(ValueError, match="unknown SLO class"):
            m.resolve_slo("platinum", now=0.0)
    entries = [("batch", None), ("standard", 120.0), ("interactive", 10.0),
               ("batch2", None), ("standard2", 120.0)]
    assert policy.deadline_order(entries) == \
        jpolicy.deadline_order(entries) == [
            ("interactive", 10.0), ("standard", 120.0),
            ("standard2", 120.0), ("batch", None), ("batch2", None)]


def test_admission_heap_agrees_with_policy_order():
    """The port's "deadline" queue serves the SLO classes in the pure
    EDF order, as the reference's does."""
    now = 1000.0
    names = ["batch", "interactive", "standard", "batch", "standard"]
    resolved = [(f"{n}{i}", policy.resolve_slo(n, now)[1])
                for i, n in enumerate(names)]
    served = []
    for Q, E in ((AdmissionQueue, QueueEntry), (JQueue, JEntry)):
        q = Q("deadline")
        for i, (_, dl) in enumerate(resolved):
            q.push(E(req_id=i, request=None, arrival=float(i), deadline=dl))
        served.append([q.pop().req_id for _ in resolved])
    ref = [resolved.index(e) for e in policy.deadline_order(resolved)]
    assert served == [ref, ref]


# ------------------------------------------------------------------ #
# 3. The live server                                                 #
# ------------------------------------------------------------------ #
def _spawn_server(extra_args=()):
    # one intra-op thread, as in this process: the solves are tiny, and
    # a thread per core fights the other test workers for the cores
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.remote.server", "--port", "0",
         "--device", "cpu", *SERVER_ARGS, *extra_args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
    port = None
    for line in proc.stdout:
        if line.startswith("READY port="):
            port = int(line.split("=")[1])
            break
    if port is None:
        err = proc.stderr.read()
        proc.kill()
        raise RuntimeError(f"server failed to start:\n{err}")
    return proc, f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def server():
    proc, url = _spawn_server()
    yield url
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()


def _remote(url, **kw):
    return FlexaClient(config=ClientConfig(
        backend="remote", remote_url=url, remote_tenant="pytest",
        solver=SolverConfig(**CFG), **kw), device="cpu")


def _inline():
    return FlexaClient(device="cpu", solver=SolverConfig(**CFG))


def test_remote_package_stays_lazy():
    """Importing the client (or the remote package) imports none of the
    remote modules; the first ``backend="remote"`` client loads the
    backend."""
    code = """
import sys
import repro_torch.client, repro_torch.remote
from repro_torch.client import ClientConfig, FlexaClient, available_backends
loaded = lambda: sorted(m for m in sys.modules
                        if m.startswith("repro_torch.remote."))
assert loaded() == [] and "remote" not in available_backends(), loaded()
FlexaClient(config=ClientConfig(backend="remote",
                                remote_url="http://127.0.0.1:1"),
            device="cpu")
assert "repro_torch.remote.backend" in loaded(), loaded()
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_remote_requires_url_and_a_device():
    with pytest.raises(ClientError, match="remote_url"):
        FlexaClient(config=ClientConfig(backend="remote"), device="cpu")
    assert ClientConfig(backend="remote").device == "cuda"


def test_remote_rejects_score_callable(server):
    with pytest.raises(UnsupportedWorkloadError, match="wire"):
        _remote(server).submit(CVSpec(
            problems=[_port(JINSTANCES["lasso"](s)) for s in range(2)],
            score=lambda i, k, x: 0.0))


@pytest.mark.parametrize("family", ["lasso", "logreg"])
def test_remote_solo_matches_inline(server, family):
    p = _port(JINSTANCES[family](0))
    ref = _inline().run(SoloSpec(problem=p))
    client = _remote(server)
    got = client.run(SoloSpec(problem=p))
    assert got.backend == "remote" and got.converged and got.status == "ok"
    np.testing.assert_allclose(got.x, ref.x, atol=1e-5)
    assert got.ledger.conserved()
    diag = client.diagnostics(0)
    assert diag.done and diag.requests[0]["iters"] == got.iters


def test_remote_group_path_matches_inline(server):
    p = _port(JINSTANCES["group_lasso"](0))
    spec = PathSpec(problem=p, n_points=4, lam_min_ratio=0.2)
    ref = _inline().run(spec)
    got = _remote(server).run(spec)
    np.testing.assert_allclose(got.lambdas, ref.lambdas, rtol=1e-12)
    np.testing.assert_allclose(got.x, ref.x, atol=1e-5)
    np.testing.assert_array_equal(got.support, ref.support)
    assert got.meta["backend"] == "remote" and got.converged.all()


def test_remote_past_deadline_times_out(server):
    """deadline_s=0 expires before the first chunk: the server answers
    through the normal eviction path with status="timeout"."""
    p = _port(JINSTANCES["lasso"](0))
    msg = protocol.encode_item(normalize(SoloSpec(problem=p), 0))
    msg.update(tenant="pytest", slo="interactive", deadline_s=0.0)
    req = urllib.request.Request(f"{server}/v1/submit",
                                 data=protocol.dumps(msg), method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        ticket = json.loads(resp.read())["ticket"]
    with urllib.request.urlopen(
            f"{server}/v1/result/{ticket}?wait_ms=20000",
            timeout=60) as resp:
        out = protocol.decode_result(json.loads(resp.read()))
    assert out.status == "timeout"
    assert not out.converged and out.iters == 0
    with urllib.request.urlopen(f"{server}/stats", timeout=30) as resp:
        stats = json.loads(resp.read())
    assert stats["device"] == "cpu"
    assert any(f["status"] == "timeout" for f in stats["failures"])


def test_remote_quota_then_sigterm_drain(tmp_path):
    """A 1-slot server: the second concurrent submit raises the typed
    QuotaExceeded, visible in /stats; then SIGTERM with a ticket in
    flight — it is answered, telemetry is flushed, DRAINED, exit 0.

    ``tol=-1`` runs each request's full budget in chunks of 4, so it is
    still in flight when the next call arrives."""
    out_file = tmp_path / "final_snapshot.json"
    proc, url = _spawn_server(["--max-in-flight", "1", "--tol", "-1",
                               "--max-iters", "600", "--chunk-iters", "4",
                               "--telemetry-out", str(out_file)])
    try:
        c = _remote(url)
        ps = [_port(JINSTANCES["lasso"](s)) for s in range(3)]
        t1 = c.submit(SoloSpec(problem=ps[0]))
        with pytest.raises(policy.QuotaExceeded) as ei:
            c.submit(SoloSpec(problem=ps[1]))
        assert (ei.value.reason, ei.value.tenant) == ("in_flight", "pytest")
        assert c.result(t1).iters == 600     # first ticket unharmed
        ten = c.stats()["server"]["tenants"]["pytest"]
        assert ten["rejected"]["in_flight"] == 1
        assert ten["in_flight"] == 0         # released on completion
        t2 = c.submit(SoloSpec(problem=ps[2]))
        proc.send_signal(signal.SIGTERM)
        res = c.result(t2)                   # draining, not dead
        assert res.iters == 600 and res.status == "ok"
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "DRAINED" in out
        snap = json.loads(out_file.read_text())
        assert snap["schema"] == 1 and snap["telemetry"]["completed"] == 2
        with pytest.raises(ClientError):
            c.submit(SoloSpec(problem=ps[1]))
    finally:
        if proc.poll() is None:
            proc.kill()
