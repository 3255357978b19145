"""Solver serving in the port against the JAX package's, and its own
properties.

Against the reference (same seeded numpy instances, the CPU):

* continuous ≡ the reference's solo ``solve`` within 1e-5, capacity 2
  for 5 requests (eviction and backfill run): group Lasso, logreg and
  svm at the fixed budget of ``tests/test_serve_continuous.py:51-70``
  (``max_iters=150, tol=-1, tau_adapt=False``).  At that budget the
  Lasso's greedy mask flips on last-bit differences: the reference's own
  continuous run is 7.0e-5 from its solo run on request 4 on the CPU
  (so its own test fails there), the port's 2.0e-5 on request 3.  The
  Lasso is therefore held at the reference's tol-stopping contract
  (``tests/test_serve_continuous.py:72-89``: ``tol=1e-7``, 1500
  iterations, chunks of 32), where the noise stays inside 1e-5; at the
  fixed budget each of its rows equals the port's own solo run bit for
  bit, as every family's does;
* the port's wave engine ≡ the reference's ``SolverServeEngine`` within
  1e-5, with equal iterations, convergence flags and ``stats``;
* a ``PathRequest`` served by the port ≡ the reference's served path
  within 1e-5, with the supports of the reference's path driver at every
  point, and of its served path past the first point, λ_max (there the
  reference's served protocol runs one iteration from 0, which leaves one
  coordinate at 2.7e-8, a threshold rounding; the port certifies x = 0
  without a solve, as both packages' path drivers do);
* ``AdmissionQueue`` pops the reference's order for each policy (exact);
* ``validate_request`` rejects the same malformed requests with the same
  messages.

The port's own properties (exact unless stated): a slab row equals its
solo run bit for bit whatever the chunk size; the exactly-once audit;
determinism under a fixed seed and trace; randomized streams keyed by
request id (alone, beside a neighbour, in another slot, across a
migration); per-request tolerance on one slab; ``expire_overdue``;
drain-tail migration and growth; the watchdog; ``warm_from``, ``x0``
splices and ``active_mask``; paths sharing a slab; the
``slabs_per_tick`` rotation; and ``FlexaClient(backend="wave" |
"continuous")`` on every spec kind against ``backend="inline"``.
"""
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from repro.config.base import ServeConfig as JServeConfig
from repro.config.base import SolverConfig as JSolverConfig
from repro.path.driver import _solve_path as j_solve_path
from repro.problems.group_lasso import nesterov_group_instance as jgroup
from repro.problems.lasso import nesterov_instance as jnesterov
from repro.problems.logreg import random_logreg_instance as jlogreg
from repro.problems.svm import random_svm_instance as jsvm
from repro.serve import AdmissionQueue as JQueue
from repro.serve import ContinuousSolverEngine as JContinuous
from repro.serve import PathRequest as JPathRequest
from repro.serve import QueueEntry as JEntry
from repro.serve import SolveRequest as JRequest
from repro.serve import SolverServeEngine as JWave
from repro.serve.engine import validate_request as jvalidate
from repro.solvers.api import _solve as jsolve
from repro_torch.client import (BatchSpec, CVSpec, FlexaClient, PathSpec,
                                SoloSpec, solve_request_of)
from repro_torch.config.base import ServeConfig, SolverConfig
from repro_torch.obs.health import bitwise_equal
from repro_torch.problems.families import problem_from_arrays
from repro_torch.problems.lasso import make_lasso, nesterov_instance
from repro_torch.serve import (AdmissionQueue, ContinuousSolverEngine,
                               PathRequest, QueueEntry, SolveRequest,
                               SolverServeEngine)
from repro_torch.serve.engine import validate_request
from repro_torch.solvers import batched as B
from repro_torch.solvers.api import _solve


#: Constructing an engine directly warns once (the legacy entry point).
pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many tiny eager steps: one intra-op thread keeps them off the
    other workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FAMILY_BATCHES = {
    "lasso": lambda: [jnesterov(m=20, n=64, nnz_frac=0.15, c=1.0, seed=s)
                      for s in range(5)],
    "group_lasso": lambda: [jgroup(m=24, n_blocks=16, block_size=4,
                                   nnz_frac=0.25, c=1.0, seed=s)
                            for s in range(5)],
    "logreg": lambda: [jlogreg(m=30, n=48, nnz_frac=0.2, c=0.5, seed=s)
                       for s in range(5)],
    "svm": lambda: [jsvm(m=30, n=40, nnz_frac=0.2, c=0.5, seed=s)
                    for s in range(5)],
}
BUDGET = dict(max_iters=150, tol=-1.0, tau_adapt=False)
TOLCFG = dict(tol=1e-7, max_iters=3000, tau_adapt=False)


def _port(pj):
    return problem_from_arrays(
        pj.family, {k: np.asarray(v) for k, v in pj.data.items()},
        pj.g_weight, block_size=pj.block_size, device="cpu")


def _jreq(pj, **kw):
    if pj.family in ("lasso", "group_lasso"):
        return JRequest(A=np.asarray(pj.data["A"]),
                        b=np.asarray(pj.data["b"]), c=float(pj.g_weight),
                        block_size=pj.block_size, **kw)
    return JRequest(A=np.asarray(pj.data["Z"]), c=float(pj.g_weight),
                    family=pj.family, **kw)


def _preq(pj, **kw):
    """The port's SolveRequest from the reference problem's arrays."""
    r = _jreq(pj)
    return SolveRequest(A=r.A, b=r.b, c=r.c, block_size=r.block_size,
                        family=r.family, **kw)


def _lasso(seed, m=20, n=64, **kw):
    return nesterov_instance(m=m, n=n, nnz_frac=0.15, c=1.0, seed=seed,
                             device="cpu", **kw)


def _req(p, tol=None, **kw):
    r = solve_request_of(p, **kw)
    return r if tol is None else dataclasses.replace(r, tol=tol)


def _cont(cfg, device="cpu", **serve):
    return ContinuousSolverEngine(cfg, ServeConfig(**serve), device=device)


# ------------------------------------------------------------------ #
# Against the reference                                              #
# ------------------------------------------------------------------ #
#: (solver config, chunk size) of each family's comparison (see above).
CONTRACT = {"lasso": (dict(max_iters=1500, tol=1e-7, tau_adapt=False), 32),
            "group_lasso": (BUDGET, 16), "logreg": (BUDGET, 16),
            "svm": (BUDGET, 16)}


@pytest.mark.parametrize("family", sorted(FAMILY_BATCHES))
def test_continuous_matches_reference_solve(family):
    """Each request served through a capacity-2 slab matches the
    reference's solo solve within 1e-5."""
    kw, K = CONTRACT[family]
    jprobs = FAMILY_BATCHES[family]()
    eng = _cont(SolverConfig(**kw), slab_capacity=2, chunk_iters=K)
    ids = [eng.submit(_preq(pj)) for pj in jprobs]
    resps = eng.drain()
    assert sorted(resps) == sorted(ids)
    jcfg = JSolverConfig(**kw)
    for i, pj in zip(ids, jprobs):
        ref = jsolve(pj, method="flexa", cfg=jcfg)
        assert resps[i].status == "ok"
        assert resps[i].converged == bool(ref.converged)
        np.testing.assert_allclose(resps[i].x, np.asarray(ref.x),
                                   atol=1e-5,
                                   err_msg=f"{family} request {i}")


@pytest.mark.parametrize("family", sorted(FAMILY_BATCHES))
def test_continuous_rows_equal_port_solo_at_fixed_budget(family):
    """The fixed budget of the reference's contract: every row runs 150
    iterations and equals the port's own solo run bit for bit."""
    jprobs = FAMILY_BATCHES[family]()
    cfg = SolverConfig(**BUDGET)
    eng = _cont(cfg, slab_capacity=2, chunk_iters=16)
    ids = [eng.submit(_preq(pj)) for pj in jprobs]
    resps = eng.drain()
    for i, pj in zip(ids, jprobs):
        solo = _solve(_port(pj), method="flexa", cfg=cfg)
        assert resps[i].iters == solo.iters == 150
        assert bitwise_equal(resps[i].x, solo.x), f"{family} request {i}"


def test_wave_matches_reference_engine():
    """A bucket of 4 with one padding clone at the reference's fixed
    batched budget (``tests/test_solvers_api.py``: 300 iterations, τ
    fixed): x within 1e-5, equal iterations, convergence flags and
    stats.  (Under a tolerance stop the two packages' fp32 noise moves
    the stopping iteration by a few.)"""
    jprobs = FAMILY_BATCHES["lasso"]()[:3]
    kw = dict(max_iters=300, tol=-1.0, tau_adapt=False)
    jeng = JWave(JSolverConfig(**kw), max_batch=4)
    jr = jeng.submit([_jreq(pj) for pj in jprobs])
    eng = SolverServeEngine(SolverConfig(**kw), ServeConfig(max_batch=4),
                            device="cpu")
    pr = eng.submit([_preq(pj) for pj in jprobs])
    for a, b in zip(pr, jr):
        np.testing.assert_allclose(a.x, np.asarray(b.x), atol=1e-5)
        assert (a.iters, a.converged, a.bucket) == \
            (b.iters, b.converged, b.bucket)
    assert eng.stats == pytest.approx(jeng.stats)
    assert eng.stats["padded"] == 1
    assert eng.stats["padding_waste"] == pytest.approx(0.25)
    (wave,) = eng.telemetry.waves
    (jwave,) = jeng.telemetry.waves
    for key in ("bucket", "n_real", "padded", "iters_max",
                "useful_row_iters", "row_iters"):
        assert wave[key] == jwave[key], key
    snap = eng.telemetry.snapshot()
    assert snap["wave"]["waves"] == 1 and snap["completed"] == 3


def test_path_request_matches_reference_served_path():
    pj = jnesterov(m=30, n=96, nnz_frac=0.1, c=1.0, seed=1)
    A, b = np.asarray(pj.data["A"]), np.asarray(pj.data["b"])
    jeng = JContinuous(JSolverConfig(**TOLCFG),
                       JServeConfig(slab_capacity=4, chunk_iters=25))
    jpid = jeng.submit_path(JPathRequest(A=A, b=b, n_points=8,
                                         lam_min_ratio=0.05))
    jeng.drain()
    ref = jeng.path_result(jpid)
    eng = _cont(SolverConfig(**TOLCFG), slab_capacity=4, chunk_iters=25)
    pid = eng.submit_path(PathRequest(A=A, b=b, n_points=8,
                                      lam_min_ratio=0.05))
    eng.drain()
    got = eng.path_result(pid)
    assert got["done"] and ref["done"] and got["converged"].all()
    np.testing.assert_allclose(got["lambdas"], ref["lambdas"], rtol=1e-6)
    np.testing.assert_allclose(got["x"], ref["x"], atol=1e-5)
    support = (got["x"] != 0).sum(1)
    np.testing.assert_array_equal(support[1:],
                                  (np.asarray(ref["x"]) != 0).sum(1)[1:])
    driver = j_solve_path(pj, n_points=8, lam_min_ratio=0.05,
                          cfg=JSolverConfig(**TOLCFG))
    np.testing.assert_array_equal(support, driver.support)
    assert got["screened_out"].sum() > 0
    assert got["iters"][0] == 0 and len(got["req_ids"]) >= 7


def _entries(make_entry, make_req):
    rng = np.random.default_rng(7)
    r = make_req(A=np.zeros((2, 2), np.float32), b=np.zeros(2, np.float32))
    out = []
    for i in range(24):
        dl = None if i % 4 == 0 else float(rng.integers(0, 6))
        out.append(make_entry(req_id=i, request=r,
                              arrival=float(rng.integers(0, 5)),
                              priority=int(rng.integers(0, 3)),
                              deadline=dl))
    return out


@pytest.mark.parametrize("policy", ["fifo", "priority", "deadline"])
def test_admission_queue_pops_the_reference_order(policy):
    jq, q = JQueue(policy), AdmissionQueue(policy)
    for e in _entries(JEntry, JRequest):
        jq.push(e)
    for e in _entries(QueueEntry, SolveRequest):
        q.push(e)
    # remove some, push back, then drain: the same order throughout
    jgone = [e.req_id for e in jq.remove_if(lambda e: e.req_id % 5 == 0)]
    gone = [e.req_id for e in q.remove_if(lambda e: e.req_id % 5 == 0)]
    assert gone == jgone
    assert [q.pop().req_id for _ in range(len(q))] == \
        [jq.pop().req_id for _ in range(len(jq))]
    with pytest.raises(ValueError, match="unknown admission policy"):
        AdmissionQueue("lifo")


BAD = {
    "logreg_with_b": dict(A=np.zeros((5, 4), np.float32),
                          b=np.zeros(5, np.float32), family="logreg"),
    "lasso_without_b": dict(A=np.zeros((5, 4), np.float32)),
    "b_shape": dict(A=np.zeros((5, 4), np.float32),
                    b=np.zeros(4, np.float32)),
    "x0_shape": dict(A=np.zeros((5, 4), np.float32),
                     b=np.zeros(5, np.float32), x0=np.zeros(5, np.float32)),
    "mask_shape": dict(A=np.zeros((5, 4), np.float32),
                       b=np.zeros(5, np.float32),
                       active_mask=np.ones(3, np.float32)),
    "warm_and_x0": dict(A=np.zeros((5, 4), np.float32),
                        b=np.zeros(5, np.float32), warm_from=0,
                        x0=np.zeros(4, np.float32)),
    "negative_tol": dict(A=np.zeros((5, 4), np.float32),
                         b=np.zeros(5, np.float32), tol=-1.0),
    "nan_tol": dict(A=np.zeros((5, 4), np.float32),
                    b=np.zeros(5, np.float32), tol=float("nan")),
}


@pytest.mark.parametrize("case", sorted(BAD))
@pytest.mark.parametrize("where", [None, 3])
def test_validate_request_rejects_like_the_reference(case, where):
    jr, r = JRequest(**BAD[case]), SolveRequest(**BAD[case])
    with pytest.raises(ValueError) as jexc:
        jvalidate(where, jr, jr.spec)
    with pytest.raises(ValueError) as exc:
        validate_request(where, r, r.spec)
    assert str(exc.value) == str(jexc.value)
    assert r.spec.__dict__ == jr.spec.__dict__


def test_engines_reject_what_the_reference_rejects():
    eng = _cont(SolverConfig(max_iters=10))
    Z = np.zeros((5, 4), np.float32)
    with pytest.raises(ValueError, match="takes no b"):
        eng.submit(SolveRequest(A=Z, b=np.zeros(5, np.float32),
                                family="logreg"))
    with pytest.raises(ValueError, match="needs b"):
        eng.submit(SolveRequest(A=Z, c=1.0))
    assert eng.pending == 0
    wave = SolverServeEngine(SolverConfig(), device="cpu")
    A, b = np.zeros((5, 4), np.float32), np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="continuous-engine feature"):
        wave.submit([SolveRequest(A=A, b=b, warm_from=0)])
    with pytest.raises(ValueError, match="per-request tol"):
        wave.submit([SolveRequest(A=A, b=b, tol=1e-3)])
    with pytest.raises(ValueError, match="align"):
        wave.submit([SolveRequest(A=A, b=b)], arrivals=[0.0, 1.0])
    for bad in (dict(slab_capacity=0), dict(chunk_iters=0),
                dict(policy="lifo"), dict(mesh_devices=2)):
        with pytest.raises(ValueError):
            _cont(SolverConfig(), **bad)


# ------------------------------------------------------------------ #
# Port-only properties                                               #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("K", [1, 7, 64])
def test_slab_rows_equal_solo_bitwise_any_chunk_size(K):
    """Tol-stopping at 1e-6 (greedy): each row stops at its solo run's
    iteration with its solo run's bits, whatever K."""
    probs = [_lasso(s) for s in range(5)]
    cfg = SolverConfig(max_iters=1000, tol=1e-6, tau_adapt=False)
    eng = _cont(cfg, slab_capacity=2, chunk_iters=K)
    ids = [eng.submit(_req(p)) for p in probs]
    resps = eng.drain()
    for i, p in zip(ids, probs):
        solo = _solve(p, method="flexa", cfg=cfg)
        assert resps[i].iters == solo.iters
        assert resps[i].converged == solo.converged
        assert bitwise_equal(resps[i].x, solo.x)
    assert len({resps[i].iters for i in ids}) > 1    # not lock-step


def test_chunk_stepper_matches_the_wave_program():
    """A full slab stepped to completion reproduces the lockstep driver
    bit for bit (same freeze merge)."""
    probs = [_lasso(s) for s in range(4)]
    cfg = SolverConfig(max_iters=1000, tol=1e-6, tau_adapt=False)
    wave = B._solve_batched(probs, cfg=cfg)
    eng = _cont(cfg, slab_capacity=4, chunk_iters=17)
    ids = [eng.submit(_req(p)) for p in probs]
    resps = eng.drain()
    for j, i in enumerate(ids):
        assert resps[i].iters == int(wave.iters[j])
        assert bitwise_equal(resps[i].x, wave.x[j])


def test_exactly_once_audit_and_no_double_booking():
    probs = [_lasso(s) for s in range(7)]
    eng = _cont(SolverConfig(max_iters=400, tol=1e-6, tau_adapt=False),
                slab_capacity=2, chunk_iters=16)
    ids = [eng.submit(_req(p)) for p in probs]
    eng.drain()
    assert sorted(rec["req_id"] for rec in eng.audit) == sorted(ids)
    by_slot: dict = {}
    for rec in eng.audit:
        assert rec["evict_tick"] is not None and rec["status"] == "ok"
        assert rec["admit_tick"] <= rec["evict_tick"]
        by_slot.setdefault(rec["slot"], []).append(
            (rec["admit_tick"], rec["evict_tick"]))
    for spans in by_slot.values():
        spans.sort()
        for (_, e1), (a2, _) in zip(spans, spans[1:]):
            assert a2 > e1
    # live-slot iterations are conserved: K per tick a request held a slot
    K = 16
    assert eng.telemetry.chunk_live_iters == sum(
        K * (r["evict_tick"] - r["admit_tick"] + 1) for r in eng.audit)


def test_deterministic_under_fixed_seed_and_trace():
    probs = [_lasso(s) for s in range(5)]

    def run():
        cfg = SolverConfig(max_iters=600, tol=1e-6, selection="hybrid",
                           sel_p=0.5, seed=3)
        eng = _cont(cfg, slab_capacity=2, chunk_iters=16)
        ids = [eng.submit(_req(p)) for p in probs]
        return ids, eng.drain(), eng.audit

    ids1, r1, a1 = run()
    ids2, r2, a2 = run()
    assert ids1 == ids2 and a1 == a2
    for i in ids1:
        assert r1[i].iters == r2[i].iters
        assert bitwise_equal(r1[i].x, r2[i].x)


RANDOM_CFG = SolverConfig(max_iters=120, tol=-1.0, tau_adapt=False,
                          selection="random", sel_p=0.5, seed=5)


def test_randomized_stream_is_keyed_by_request_id():
    """Request 0 alone, beside a neighbour, and in slot 1 behind a
    higher-priority neighbour: the same bits."""
    p, q = _lasso(0), _lasso(9)
    serve = dict(slab_capacity=2, chunk_iters=16)
    e1 = _cont(RANDOM_CFG, **serve)
    i1 = e1.submit(_req(p))
    alone = e1.drain()[i1]
    e2 = _cont(RANDOM_CFG, **serve)
    i2 = e2.submit(_req(p))
    e2.submit(_req(q))
    beside = e2.drain()[i2]
    e3 = _cont(RANDOM_CFG, policy="priority", **serve)
    i3 = e3.submit(_req(p))
    e3.submit(_req(q, priority=5))
    other_slot = e3.drain()[i3]
    assert [r["slot"] for r in e3.audit if r["req_id"] == i3] == [1]
    assert i1 == i2 == i3 == 0
    assert bitwise_equal(alone.x, beside.x)
    assert bitwise_equal(alone.x, other_slot.x)
    # another request id draws another stream
    e4 = _cont(RANDOM_CFG, **serve)
    e4.submit(_req(q))
    i4 = e4.submit(_req(p))
    assert not bitwise_equal(e4.drain()[i4].x, alone.x)
    assert B.request_seed(5, 0) == B.request_seed(5, 0) != \
        B.request_seed(5, 1)


def test_randomized_stream_survives_a_migration():
    """Request 0 waits in slot 3 behind three requests that stop early
    (a loose per-request tol); the drain tail then moves it to slot 0 of
    a capacity-1 slab, generator and all: its iterate is the one of the
    run that never migrates, and of the run where it is alone."""
    p = _lasso(0)
    fast = [_lasso(s) for s in (1, 2, 3)]
    cfg = dataclasses.replace(RANDOM_CFG, max_iters=200)

    def run(compact, neighbours=True):
        eng = _cont(cfg, slab_capacity=4, chunk_iters=16, policy="priority",
                    compact_drain=compact)
        rid = eng.submit(_req(p))
        for f in fast if neighbours else ():
            eng.submit(_req(f, priority=5, tol=0.5))
        return eng, eng.drain()[rid]

    eng0, fixed = run(False)
    eng1, moved = run(True)
    _, alone = run(False, neighbours=False)
    rec = next(r for r in eng1.audit if r["req_id"] == 0)
    assert [(m["from_slot"], m["to_slot"]) for m in rec["migrations"]] \
        == [(3, 0)]
    assert eng0.telemetry.migrations == 0
    assert fixed.iters == moved.iters == alone.iters == 200
    assert bitwise_equal(moved.x, fixed.x)
    assert bitwise_equal(moved.x, alone.x)


def test_per_request_tol_mixes_on_one_slab():
    p = _lasso(0, m=30)
    cfg = SolverConfig(max_iters=2000, tol=1e-7, tau_adapt=False)
    eng = _cont(cfg, slab_capacity=2, chunk_iters=5)
    loose = eng.submit(_req(p, tol=1e-2))
    tight = eng.submit(_req(p))
    same = eng.submit(_req(p, tol=1e-7))
    resp = eng.drain()
    assert resp[loose].converged and resp[tight].converged
    assert resp[loose].iters < resp[tight].iters
    assert resp[loose].stat <= 1e-2 and resp[tight].stat <= 1e-7
    # tol=None is the engine's tol, bit for bit
    assert resp[same].iters == resp[tight].iters
    assert bitwise_equal(resp[same].x, resp[tight].x)
    solo = _solve(p, cfg=dataclasses.replace(cfg, tol=1e-2))
    assert resp[loose].iters == solo.iters
    assert bitwise_equal(resp[loose].x, solo.x)


def test_expire_overdue_queued_and_live():
    probs = [_lasso(s) for s in range(3)]
    cfg = SolverConfig(max_iters=10_000, tol=-1.0, tau_adapt=False)
    eng = _cont(cfg, slab_capacity=1, chunk_iters=4)
    live = eng.submit(_req(probs[0], deadline=1e5))
    eng.step()
    queued = eng.submit(_req(probs[1], deadline=-1.0))
    assert eng.expire_overdue(now=0.0) == [queued]
    rq = eng.responses[queued]
    assert rq.status == "timeout" and rq.iters == 0
    assert not rq.converged and not np.isfinite(rq.stat)
    assert queued not in {rec["req_id"] for rec in eng.audit}
    assert eng.expire_overdue(now=2e5) == [live]
    rl = eng.responses[live]
    assert rl.status == "timeout" and not rl.converged and rl.iters == 4
    (rec,) = [r for r in eng.audit if r["req_id"] == live]
    assert rec["status"] == "timeout"
    assert [f.req_id for f in eng.failures] == [queued, live]
    ok = eng.submit(_req(probs[2]))
    eng2 = _cont(dataclasses.replace(cfg, max_iters=40), slab_capacity=1,
                 chunk_iters=4)
    assert eng2.expire_overdue(now=1e18) == []
    resp = eng.drain()
    assert resp[ok].iters == 10_000
    assert all(v == 1 for v in Counter(r["req_id"]
                                       for r in eng.audit).values())
    assert eng.telemetry.snapshot()["health"]["timeouts"] == 2


def test_expire_overdue_of_a_staged_slot_answers_its_x0():
    p = _lasso(0)
    eng = _cont(SolverConfig(max_iters=50, tol=-1.0), slab_capacity=1,
                chunk_iters=4)
    x0 = np.full(p.n, 0.5, np.float32)
    rid = eng.submit(_req(p, x0=x0, deadline=1.0))
    eng._slabs[next(iter(eng._slabs))].backfill(eng.audit, 1)
    assert eng.expire_overdue(now=2.0) == [rid]
    assert eng.responses[rid].iters == 0
    assert bitwise_equal(eng.responses[rid].x, x0)
    assert eng.pending == 0


DRAIN_CFG = SolverConfig(max_iters=6000, tol=1e-7, tau_adapt=False)


def test_drain_tail_migration_is_bitwise():
    """compact_drain shrinks the slab behind the stragglers: the same
    responses bit for bit as the fixed-capacity run, migrations counted
    and recorded on the audit trail, every request served once."""
    probs = [_lasso(s) for s in range(6)]
    runs = []
    for compact in (False, True):
        eng = _cont(DRAIN_CFG, slab_capacity=8, chunk_iters=8,
                    compact_drain=compact)
        ids = [eng.submit(_req(p)) for p in probs]
        runs.append((eng, ids, eng.drain()))
    (e0, ids0, r0), (e1, ids1, r1) = runs
    assert e0.telemetry.migrations == 0
    assert e1.telemetry.migrations >= 1
    assert e1.telemetry.snapshot()["continuous"]["migrations"] == \
        e1.telemetry.migrations
    for i0, i1 in zip(ids0, ids1):
        assert r0[i0].iters == r1[i1].iters
        assert bitwise_equal(r0[i0].x, r1[i1].x)
    slowest = max(ids1, key=lambda i: r1[i].iters)
    assert r1[slowest].bucket < 8
    trail = [rec for rec in e1.audit if rec.get("migrations")]
    assert trail
    for rec in trail:
        for mv in rec["migrations"]:
            assert mv["from_capacity"] != mv["to_capacity"]
    assert Counter(r["req_id"] for r in e1.audit) == Counter(ids1)
    K = 8
    assert e1.telemetry.chunk_live_iters == sum(
        K * (r["evict_tick"] - r["admit_tick"] + 1) for r in e1.audit)


def test_drain_tail_grows_back_on_new_arrivals():
    probs = [_lasso(s) for s in range(10)]
    eng = _cont(DRAIN_CFG, slab_capacity=8, chunk_iters=8,
                compact_drain=True)
    ids = [eng.submit(_req(p)) for p in probs[:6]]
    slab = None
    for _ in range(200):
        eng.step()
        slab = next(iter(eng._slabs.values()))
        if slab.capacity < 8 or not slab.pending:
            break
    assert slab.capacity < 8 and slab.live > 0
    shrunk = slab.capacity
    ids += [eng.submit(_req(p)) for p in probs[6:]]
    eng.step()
    assert slab.capacity > shrunk
    resp = eng.drain()
    assert sorted(resp) == sorted(ids)
    assert Counter(r["req_id"] for r in eng.audit) == Counter(ids)
    cfg = DRAIN_CFG
    for i, p in zip(ids, probs):
        solo = _solve(p, cfg=cfg)
        assert resp[i].iters == solo.iters
        assert bitwise_equal(resp[i].x, solo.x)


def test_slab_migrate_moves_rows_and_generators():
    p, q = _lasso(0), _lasso(1)
    spec = B.BatchedProblemSpec.of(p)
    cfg = RANDOM_CFG
    slab = B.slab_alloc(spec, cfg, 4, "cpu")
    adm = B.SlotAdmission(
        slots=(1, 3), data=tuple(solve_request_of(r).data_arrays(spec)
                                 for r in (p, q)),
        c=(1.0, 0.5), x0=(None, np.ones(p.n, np.float32)), req_ids=(7, 8),
        active=(None, None), tol=(1e-3, 1e-4))
    slab = B.write_slots(slab, spec, cfg, adm)
    moved = B.slab_migrate(slab, [3, 1], spec, cfg, 2)
    assert moved.capacity == 2
    for new, old in ((0, 3), (1, 1)):
        for a, b in zip(moved.data, slab.data):
            assert torch.equal(a[new], b[old])
        for a, b in zip(moved.state[:-1], slab.state[:-1]):
            assert torch.equal(a[new], b[old])
        assert moved.state.gen[new] is slab.state.gen[old]
        assert float(moved.tol[new]) == float(slab.tol[old])
    (row,) = B.read_slots(moved.state, [1])
    assert int(row.k) == 0 and np.isinf(float(row.stat))
    # placeholders: unit norms and τ, c = 1, stat +inf, finite forever
    empty = B.slab_alloc(spec, cfg, 2, "cpu")
    chunk = B.make_chunk_stepper(spec, cfg, 5)
    out, stop = chunk(empty, torch.ones(2, dtype=torch.bool))
    assert bool(stop.all()) and torch.isinf(out.state.stat).all()
    assert torch.isfinite(out.state.x).all()
    with pytest.raises(ValueError, match="cannot migrate"):
        B.slab_migrate(slab, [0, 1, 2], spec, cfg, 2)


WATCH = dict(slab_capacity=4, chunk_iters=25, watchdog=True,
             stall_patience=3)


def test_watchdog_quarantines_a_nan_request_in_its_first_chunk():
    eng = _cont(SolverConfig(max_iters=400, tol=1e-5, tau_adapt=False),
                **WATCH)
    p = _lasso(0, m=24)
    bad = eng.submit(_req(p, x0=np.full(p.n, np.nan, np.float32)))
    good = eng.submit(_req(_lasso(1, m=24)))
    resps = eng.drain()
    assert resps[bad].status == "diverged" and not resps[bad].converged
    assert resps[good].status == "ok" and resps[good].converged
    rec = next(r for r in eng.audit if r["req_id"] == bad)
    assert rec["status"] == "diverged"
    assert rec["evict_tick"] - rec["admit_tick"] <= 1
    assert [f.req_id for f in eng.failures] == [bad]
    assert eng.telemetry.snapshot()["health"] == {
        "quarantined": 1, "diverged": 1, "stalled": 0, "timeouts": 0}


def test_watchdog_quarantines_a_stall_within_patience():
    # γ⁰ = 0 with τ fixed freezes the iterate: the stat never decreases
    cfg = SolverConfig(max_iters=400, tol=1e-12, gamma0=0.0,
                       tau_adapt=False)
    eng = _cont(cfg, **WATCH)
    ids = [eng.submit(_req(_lasso(s, m=24))) for s in range(3)]
    resps = eng.drain()
    for i in ids:
        assert resps[i].status == "stalled"
        rec = next(r for r in eng.audit if r["req_id"] == i)
        assert rec["evict_tick"] - rec["admit_tick"] <= 3 + 1
    assert sorted(f.req_id for f in eng.failures) == ids
    assert eng.telemetry.snapshot()["health"]["stalled"] == 3
    off = _cont(cfg, slab_capacity=4, chunk_iters=25)
    i = off.submit(_req(_lasso(0, m=24)))
    assert off.drain()[i].status == "ok" and off.failures == []


def test_watchdog_is_bitwise_neutral_on_healthy_work():
    cfg = SolverConfig(max_iters=400, tol=1e-5, tau_adapt=False)

    def run(**kw):
        eng = _cont(cfg, slab_capacity=4, chunk_iters=25, **kw)
        ids = [eng.submit(_req(_lasso(s, m=24))) for s in range(6)]
        resps = eng.drain()
        return [resps[i] for i in ids], eng.failures

    off, _ = run()
    on, failures = run(watchdog=True, stall_patience=10)
    assert failures == []
    for a, b in zip(off, on):
        assert bitwise_equal(a.x, b.x)
        assert (a.iters, a.stat, b.status) == (b.iters, b.stat, "ok")


def test_watchdog_carry_survives_a_migration():
    cfg = SolverConfig(max_iters=2000, tol=1e-12, gamma0=0.0,
                       tau_adapt=False)
    eng = _cont(cfg, compact_drain=True, **WATCH)
    ids = [eng.submit(_req(_lasso(s, m=24))) for s in range(4)]
    for _ in range(2):
        eng.step()
    late = eng.submit(_req(_lasso(9, m=24)))
    resps = eng.drain()
    assert eng.telemetry.migrations > 0
    assert all(resps[i].status == "stalled" for i in ids + [late])
    rec = next(r for r in eng.audit if r["req_id"] == late)
    assert rec["evict_tick"] - rec["admit_tick"] == 3


def test_x0_splice_and_active_mask_freeze():
    p = _lasso(1, m=30, n=96)
    cfg = SolverConfig(**TOLCFG)
    solo = _solve(p, cfg=cfg)
    eng = _cont(cfg, slab_capacity=2, chunk_iters=16)
    rid = eng.submit(_req(p, x0=solo.x))
    out = eng.drain()
    assert out[rid].iters <= 16
    np.testing.assert_allclose(out[rid].x, solo.x, atol=1e-6)
    mask = np.ones(p.n, np.float32)
    mask[p.n // 2:] = 0.0
    eng = _cont(cfg, slab_capacity=2, chunk_iters=16)
    rid = eng.submit(_req(p, active=mask))
    free = eng.submit(_req(_lasso(2, m=30, n=96)))
    out = eng.drain()
    assert np.all(out[rid].x[p.n // 2:] == 0.0)
    ref = _solve(p, cfg=cfg, active=mask)
    assert out[rid].iters == ref.iters
    assert bitwise_equal(out[rid].x, ref.x)
    assert bitwise_equal(out[free].x,
                         _solve(_lasso(2, m=30, n=96), cfg=cfg).x)


def test_warm_from_defers_and_validates():
    p = _lasso(1, m=30, n=96)
    r = solve_request_of(p)
    cfg = SolverConfig(**TOLCFG)
    eng = _cont(cfg, slab_capacity=2, chunk_iters=25)
    a = eng.submit(r)
    w = eng.submit(dataclasses.replace(r, c=0.9, warm_from=a))
    free = eng.submit(dataclasses.replace(r, c=0.8))
    out = eng.drain()
    rec = {x["req_id"]: x for x in eng.audit}
    assert rec[w]["admit_tick"] > rec[a]["evict_tick"]
    assert rec[free]["admit_tick"] == 1
    eng2 = _cont(cfg, slab_capacity=2, chunk_iters=25)
    r2 = eng2.submit(dataclasses.replace(r, c=0.9, x0=out[a].x))
    assert bitwise_equal(out[w].x, eng2.drain()[r2].x)
    other = solve_request_of(_lasso(2, m=20, n=64))
    with pytest.raises(ValueError, match="unknown request id"):
        eng.submit(dataclasses.replace(r, warm_from=999))
    with pytest.raises(ValueError, match="signature mismatch"):
        eng.submit(dataclasses.replace(other, warm_from=a))
    with pytest.raises(ValueError, match="mutually exclusive"):
        eng.submit(dataclasses.replace(r, warm_from=a,
                                       x0=np.zeros(p.n, np.float32)))


def test_concurrent_paths_share_one_slab():
    cfg = SolverConfig(**TOLCFG)
    ps = [_lasso(s, m=30, n=96) for s in (3, 4)]
    eng = _cont(cfg, slab_capacity=2, chunk_iters=25)
    pids = [eng.submit_path(PathRequest(
        A=p.data["A"].numpy(), b=p.data["b"].numpy(), n_points=6,
        lam_min_ratio=0.1)) for p in ps]
    eng.drain()
    assert len(eng._slabs) == 1
    from repro_torch.path.driver import _solve_path
    for pid, p in zip(pids, ps):
        res = eng.path_result(pid)
        assert res["done"] and res["converged"].all()
        ref = _solve_path(p, lambdas=res["lambdas"], cfg=cfg)
        np.testing.assert_allclose(res["x"], ref.x, atol=1e-5)
        assert len(res["req_ids"]) >= 5     # λ_max certified, no request


def test_a_path_at_or_above_lambda_max_needs_no_request():
    """Points at c ≥ λ_max are certified as x = 0 without a solve, as the
    path driver certifies them; a path made only of them is done at
    submission."""
    p = _lasso(1, m=30, n=96)
    A, b = p.data["A"].numpy(), p.data["b"].numpy()
    eng = _cont(SolverConfig(**TOLCFG), slab_capacity=2, chunk_iters=8)
    from repro_torch.path.grid import lambda_max
    lam = lambda_max(p)
    pid = eng.submit_path(PathRequest(A=A, b=b,
                                      lambdas=[2.0 * lam, 1.5 * lam, lam]))
    res = eng.path_result(pid)
    assert res["done"] and res["req_ids"] == [] and eng.pending == 0
    assert not res["x"].any() and res["converged"].all()
    assert not res["iters"].any()
    pid = eng.submit_path(PathRequest(A=A, b=b, lambdas=[lam, 0.5 * lam]))
    assert len(eng.path_result(pid)["req_ids"]) == 1
    eng.drain()
    res = eng.path_result(pid)
    assert res["done"] and res["iters"][0] == 0 and res["iters"][1] > 0


def test_slabs_per_tick_rotation_starves_no_signature():
    cfg = SolverConfig(**TOLCFG)
    big, small = _lasso(1, m=30, n=96), _lasso(2, m=20, n=64)
    eng = _cont(cfg, slab_capacity=1, chunk_iters=8, slabs_per_tick=1)
    eng.submit(_req(big))
    victim = eng.submit(_req(small))
    done_at = None
    for tick in range(1, 400):
        eng.submit(_req(big))          # keep the first slab saturated
        if victim in eng.step():
            done_at = tick
            break
    assert done_at is not None
    rec = {r["req_id"]: r for r in eng.audit}
    assert rec[victim]["admit_tick"] <= 2
    sigs = [_lasso(s, m=16 + 4 * s, n=48) for s in (1, 2, 3)]
    eng = _cont(cfg, slab_capacity=1, chunk_iters=8, slabs_per_tick=1)
    ids = [eng.submit(_req(p)) for p in sigs]
    eng.drain()
    rec = {r["req_id"]: r for r in eng.audit}
    assert max(rec[i]["admit_tick"] for i in ids) <= 3
    eng = _cont(cfg, slab_capacity=1, chunk_iters=8)
    ids = [eng.submit(_req(p)) for p in sigs[:2]]
    eng.step()
    assert all(r["admit_tick"] == 1 for r in eng.audit)


def test_continuous_engine_runs_four_families_on_one_engine():
    """Every family's slab beside the others, each row its solo run bit
    for bit (greedy, a tolerance stop)."""
    cfg = SolverConfig(max_iters=500, tol=1e-5, tau_adapt=False)
    eng = _cont(cfg, slab_capacity=2, chunk_iters=16)
    probs = [_port(pj) for fam in sorted(FAMILY_BATCHES)
             for pj in FAMILY_BATCHES[fam]()[:3]]
    ids = [eng.submit(_req(p)) for p in probs]
    resps = eng.drain()
    assert len(eng._slabs) == 4
    for i, p in zip(ids, probs):
        solo = _solve(p, cfg=cfg)
        assert resps[i].iters == solo.iters, p.family
        assert bitwise_equal(resps[i].x, solo.x), p.family


# ------------------------------------------------------------------ #
# The client front door                                              #
# ------------------------------------------------------------------ #
def _cv_folds():
    ps = [_lasso(s, m=30, n=96) for s in range(3)]
    folds = [make_lasso(p.data["A"][:20], p.data["b"][:20], c=1.0,
                        device="cpu") for p in ps]
    val = [(p.data["A"][20:], p.data["b"][20:]) for p in ps]
    return folds, val


KINDS = ("solo", "batch", "path", "cv")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", ["wave", "continuous"])
def test_client_backend_matches_inline(backend, kind):
    cfg = SolverConfig(**TOLCFG)
    serve = ServeConfig(slab_capacity=4, chunk_iters=16, max_batch=4)
    inline = FlexaClient(device="cpu", solver=cfg)
    client = FlexaClient(device="cpu", solver=cfg, serve=serve,
                         backend=backend)
    ps = [_lasso(s, m=30, n=96) for s in range(3)]
    if kind == "solo":
        spec = SoloSpec(problem=ps[0])
    elif kind == "batch":
        x0 = np.zeros((3, ps[0].n), np.float32)
        spec = BatchSpec(problems=ps, x0=x0)
    elif kind == "path":
        spec = PathSpec(problem=ps[0], n_points=6, lam_min_ratio=0.1)
    else:
        folds, val = _cv_folds()
        spec = CVSpec(problems=folds, validation=val, n_points=6,
                      lam_min_ratio=0.1, tol_coarse=1e-3)
    t = client.submit(spec)
    assert client.pending == 1 and client.result(t, wait=False) is None
    got = client.result(t)
    ref = inline.run(spec)
    assert client.pending == 0
    if kind in ("solo", "batch"):
        # one solo closure triple per row: bitwise, iterations equal
        assert bitwise_equal(got.x, ref.x)
        np.testing.assert_array_equal(got.iters, ref.iters)
        np.testing.assert_array_equal(got.converged, ref.converged)
        assert got.backend == backend and got.ledger.conserved()
    elif kind == "path":
        # each served point runs the inline driver's solo closures from
        # the same warm start and screen: the same bits
        assert bitwise_equal(got.x, ref.x)
        np.testing.assert_array_equal(got.iters, ref.iters)
        np.testing.assert_array_equal(got.support, ref.support)
        assert got.converged.all()
        np.testing.assert_allclose(got.V, ref.V, rtol=1e-6)
    else:
        assert got.best_index == ref.best_index
        np.testing.assert_allclose(got.lambdas, ref.lambdas, rtol=1e-12)
        np.testing.assert_allclose(got.x_best, ref.x_best, atol=1e-5)
        assert got.meta["mode"] == backend
    diag = client.diagnostics(t)
    assert diag.done and diag.backend == backend and diag.requests
    snap = client.stats()["telemetry"]
    assert snap["completed"] == snap["requests"] and snap["in_flight"] == 0
    section = "continuous" if backend == "continuous" else "wave"
    assert snap[section]["row_iters"] > 0


def test_client_serving_streams_and_rejects_inline_only_work():
    from repro_torch.client import UnsupportedWorkloadError
    cfg = SolverConfig(**TOLCFG)
    client = FlexaClient(device="cpu", solver=cfg, backend="continuous",
                         serve=ServeConfig(slab_capacity=2, chunk_iters=8))
    ps = [_lasso(s) for s in range(4)]
    tickets = [client.submit(SoloSpec(problem=p)) for p in ps]
    order = [t for t, r in client.stream()]
    assert sorted(order) == tickets
    assert set(client.drain()) == set(tickets)
    for bad in (SoloSpec(problem=ps[0], method="fista"),
                PathSpec(problem=ps[0], compact=True),
                PathSpec(problem=ps[0], lam_batch=2),
                BatchSpec(problems=ps[:2], record_history=True)):
        with pytest.raises(UnsupportedWorkloadError):
            client.submit(bad)
    assert client._backend.expire_overdue(now=0.0) == []
    st = client.stats()
    assert st["backend"] == "continuous" and st["pending"] == 0
