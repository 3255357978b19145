"""The port's batched engine and K-fold CV sweep against the JAX package's.

* ``FlexaClient(device="cpu").run(BatchSpec(...))`` against the
  reference's ``BatchSpec`` and against per-instance ``SoloSpec``s, for
  the greedy and the Jacobi rule, at fixed τ and a fixed budget
  (``tests/test_client.py:99``, ``tests/test_solvers_api.py:78-121``):
  x within 1e-5 (fp32, sums in another order).
* ``CVSpec`` against the reference's: the same grid (rel 1e-12), the same
  selected λ, each fold's x within 1e-5, with and without ``tol_coarse``
  (``tests/test_client.py:164, 218``).
* ``_solve_path_batched`` against sequential ``_solve_path`` runs on the
  shared grid (``tests/test_path.py:268``): x within 1e-5.
* The spec validation errors of ``tests/test_client.py:305-335``.
* Steps S.2 and S.4 of the solver's iteration, now the fused kernels'
  plain versions, against the torch expressions they replaced, bit for
  bit on a fixed iterate.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.client import (BatchSpec as JBatchSpec, CVSpec as JCVSpec,
                          FlexaClient as JClient)
from repro.config.base import SolverConfig as JSolverConfig
from repro.path.driver import _solve_path_batched as j_solve_path_batched
from repro.problems.lasso import make_lasso as jmake_lasso
from repro.problems.lasso import nesterov_instance as jnesterov
from repro_torch.client import (BatchResult, BatchSpec, CVResult, CVSpec,
                                FlexaClient, SoloSpec, SpecError)
from repro_torch.config.base import SolverConfig
from repro_torch.core import flexa, surrogate
from repro_torch.core.prox import soft_threshold
from repro_torch.kernels import flexa_prox
from repro_torch.path import geometric_grid, lambda_max
from repro_torch.path.driver import _solve_path, _solve_path_batched
from repro_torch.problems.families import problem_from_arrays
from repro_torch.problems.lasso import make_lasso, nesterov_instance
from repro_torch.solvers.batched import _solve_batched

#: The fixed-budget, fixed-τ configuration of the reference's batched
#: acceptance test: both drivers take the same smooth steps.
BUDGET = dict(max_iters=300, tol=-1.0, tau_adapt=False)
#: Full Jacobi contracts only with τ near L_F (as tests/test_torch_client).
RULES = {"greedy": {}, "jacobi": dict(jacobi=True, tau0=60.0)}
#: Tol-stopping at 1e-7 with fixed τ: the reference's path/CV config.
CFG = dict(tol=1e-7, max_iters=4000, tau_adapt=False)
GRID = dict(n_points=5, lam_min_ratio=0.1)


def _pairs(seeds, **inst):
    inst = {"m": 20, "n": 64, "nnz_frac": 0.15, "c": 1.0, **inst}
    out = []
    for s in seeds:
        pj = jnesterov(**inst, seed=s)
        out.append((pj, problem_from_arrays(
            "lasso", {k: np.asarray(v) for k, v in pj.data.items()},
            inst["c"], device="cpu")))
    return out


def _client(**cfg):
    return FlexaClient(device="cpu", solver=SolverConfig(**cfg))


@pytest.fixture(scope="module")
def batch():
    return _pairs(range(4))


@pytest.mark.parametrize("rule", sorted(RULES))
def test_batch_matches_reference_and_solo(batch, rule):
    cfg = {**BUDGET, **RULES[rule]}
    jprobs, tprobs = zip(*batch)
    rj = JClient(solver=JSolverConfig(**cfg)).run(
        JBatchSpec(problems=list(jprobs)))
    client = _client(**cfg)
    rt = client.run(BatchSpec(problems=list(tprobs)))
    assert isinstance(rt, BatchResult) and len(rt) == 4
    assert rt.x.shape == (4, 64) and (rt.iters == 300).all()
    assert rt.stat.shape == (4,) and rt.backend == "inline"
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), atol=1e-5)
    for i, p in enumerate(tprobs):
        solo = client.run(SoloSpec(problem=p, method="flexa"))
        assert solo.iters == 300
        np.testing.assert_allclose(rt.x[i], solo.x, atol=1e-5)
    # lockstep pricing: every row runs the slowest row's iterations
    led = rt.ledger
    assert led.row_iters == 4 * 300 == led.live_iters and led.conserved()
    assert led.device_flops == 4 * 300 * 20 * 64
    diag = client.diagnostics(0)
    assert diag.kind == "batch" and len(diag.requests) == 4


def test_batch_history_x0_and_active(batch):
    """The host-stepped driver records (B,) trajectories; a warm start and
    a freeze mask reach the engine as the reference's do."""
    jprobs, tprobs = zip(*batch)
    cfg = dict(max_iters=40, tol=0.0, tau_adapt=False)
    rng = np.random.default_rng(1)
    x0 = (0.1 * rng.standard_normal((4, 64))).astype(np.float32)
    active = (rng.uniform(size=(4, 64)) < 0.7).astype(np.float32)
    kw = dict(x0=x0, active=active, record_history=True)
    rt = _client(**cfg).run(BatchSpec(problems=list(tprobs), **kw))
    rj = JClient(solver=JSolverConfig(**cfg)).run(
        JBatchSpec(problems=list(jprobs), **kw))
    assert len(rt.raw.history["V"]) == 40
    assert rt.raw.history["V"][0].shape == (4,)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), atol=1e-5)
    np.testing.assert_array_equal(rt.x[active == 0], x0[active == 0])
    assert (rt.raw.history["V"][-1] <= rt.raw.history["V"][0]).all()


def test_batch_rejects_mixed_shapes(batch):
    _, tprobs = zip(*batch)
    odd = nesterov_instance(m=24, n=64, nnz_frac=0.15, seed=9,
                            device="cpu")
    with pytest.raises(ValueError, match="shape signature"):
        _client(**BUDGET).run(BatchSpec(problems=list(tprobs) + [odd]))
    with pytest.raises(ValueError, match=r"x0 must be \(B, n\)"):
        _client(**BUDGET).run(BatchSpec(problems=list(tprobs),
                                        x0=np.zeros((3, 64))))


def _cv_data(seed=7, K=3, n=48):
    """K folds + validation pairs sharing one shape signature, as
    ``tests/test_client.py::_cv_data`` builds them."""
    rng = np.random.default_rng(seed)
    x_true = np.zeros(n, np.float32)
    x_true[rng.choice(n, 6, replace=False)] = 1.0
    jfolds, tfolds, val = [], [], []
    for i in range(K):
        A = rng.standard_normal((24, n)).astype(np.float32)
        b = A @ x_true + 0.3 * rng.standard_normal(24).astype(np.float32)
        Av = rng.standard_normal((12, n)).astype(np.float32)
        bv = Av @ x_true + 0.3 * rng.standard_normal(12).astype(
            np.float32)
        jfolds.append(jmake_lasso(A, b, c=1.0, name=f"f{i}"))
        tfolds.append(make_lasso(A, b, c=1.0, name=f"f{i}", device="cpu"))
        val.append((Av, bv))
    return jfolds, tfolds, val


@pytest.fixture(scope="module")
def cv():
    jfolds, tfolds, val = _cv_data()
    ref = JClient(solver=JSolverConfig(**CFG)).run(
        JCVSpec(problems=jfolds, validation=val, **GRID))
    return jfolds, tfolds, val, ref


def test_cv_matches_reference(cv):
    _, tfolds, val, ref = cv
    client = _client(**CFG)
    spec = CVSpec(problems=tfolds, validation=val, **GRID)
    got = client.run(spec)
    assert isinstance(got, CVResult) and len(got.folds) == 3
    np.testing.assert_allclose(got.lambdas, ref.lambdas, rtol=1e-12)
    lam_max = max(lambda_max(p) for p in tfolds)
    np.testing.assert_allclose(got.lambdas, geometric_grid(lam_max, **GRID),
                               rtol=1e-12)
    assert got.best_index == ref.best_index
    assert got.best_lambda == pytest.approx(ref.best_lambda, rel=1e-12)
    np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-4)
    for f, rf in zip(got.folds, ref.folds):
        np.testing.assert_allclose(f.x, rf.x, atol=1e-5)
        assert list(f.support) == list(rf.support)
        assert f.converged.all()
    np.testing.assert_allclose(got.x_best, ref.x_best, atol=1e-5)
    # the winner column of a full-tolerance sweep is the answer
    np.testing.assert_array_equal(
        got.x_best, np.stack([f.x[got.best_index] for f in got.folds]))
    assert got.ledger.row_iters == got.folds[0].meta["sweep_row_iters"]
    assert got.meta == {"mode": "lockstep", "tol_coarse": None}
    diag = client.diagnostics(0)
    assert diag.kind == "cv" and len(diag.requests) == 3


def test_cv_tol_coarse_matches_reference_and_full_sweep(cv):
    jfolds, tfolds, val, full = cv
    ref = JClient(solver=JSolverConfig(**CFG)).run(
        JCVSpec(problems=jfolds, validation=val, tol_coarse=1e-3, **GRID))
    got = _client(**CFG).run(CVSpec(problems=tfolds, validation=val,
                                    tol_coarse=1e-3, **GRID))
    assert got.best_index == ref.best_index == full.best_index
    assert got.meta["tol_coarse"] == 1e-3
    np.testing.assert_allclose(got.x_best, ref.x_best, atol=1e-5)
    np.testing.assert_allclose(got.x_best, full.x_best, atol=1e-5)
    assert sum(int(f.iters.sum()) for f in got.folds) \
        < sum(int(f.iters.sum()) for f in full.folds)
    # the winners' re-solve is priced on top of the sweep
    assert got.ledger.row_iters > got.folds[0].meta["sweep_row_iters"]


def test_cv_without_scoring_is_a_plain_sweep(cv):
    _, tfolds, _, ref = cv
    got = _client(**CFG).run(CVSpec(problems=tfolds, **GRID))
    assert got.best_index is None and got.x_best is None
    assert got.scores is None
    for f, rf in zip(got.folds, ref.folds):
        np.testing.assert_allclose(f.x, rf.x, atol=1e-5)


def test_path_batched_matches_sequential_paths():
    """``tests/test_path.py:268`` on the port: the lockstep sweep equals
    sequential paths on the shared grid, and the fold whose λ_max lies
    below the grid's head comes out zero there."""
    inst = dict(m=30, n=96, nnz_frac=0.1, c=1.0)
    ps = [nesterov_instance(**inst, seed=s, device="cpu") for s in (0, 1)]
    lam = max(lambda_max(p) for p in ps)
    grid = geometric_grid(lam, n_points=6, lam_min_ratio=0.1)
    cfg = SolverConfig(**CFG)
    batched = _solve_path_batched(ps, lambdas=grid, cfg=cfg)
    jps = [jnesterov(**inst, seed=s) for s in (0, 1)]
    jbatched = j_solve_path_batched(jps, lambdas=grid,
                                    cfg=JSolverConfig(**CFG))
    for p, r, rj in zip(ps, batched, jbatched):
        solo = _solve_path(p, lambdas=grid, cfg=cfg)
        np.testing.assert_allclose(r.x, solo.x, atol=1e-5)
        np.testing.assert_allclose(r.x, rj.x, atol=1e-5)
        np.testing.assert_allclose(r.V, rj.V, rtol=1e-5)
        assert np.all(r.converged)
        assert r.meta["sweep_row_iters"] == r.ledger.row_iters
        assert r.ledger.conserved()
    i_small = int(np.argmin([lambda_max(p) for p in ps]))
    assert float(np.abs(batched[i_small].x[0]).max()) <= 1e-5


def test_spec_validation_errors():
    """``tests/test_client.py:305-335``: malformed specs raise SpecError
    at submit, before any work."""
    c = _client(**CFG)
    with pytest.raises(SpecError, match="at least one problem"):
        c.submit(BatchSpec(problems=[]))
    with pytest.raises(SpecError, match="at least one fold"):
        c.submit(CVSpec(problems=[]))
    with pytest.raises(SpecError, match="unknown workload spec"):
        c.submit(object())
    _, folds, val = _cv_data()
    with pytest.raises(SpecError, match="align"):
        c.submit(CVSpec(problems=folds, validation=val[:1]))
    with pytest.raises(SpecError, match="mutually exclusive scoring"):
        c.submit(CVSpec(problems=folds, validation=val,
                        score=lambda i, k, x: 0.0))
    with pytest.raises(SpecError, match="scoring route"):
        c.submit(CVSpec(problems=folds, tol_coarse=1e-3))
    with pytest.raises(SpecError, match="mutually exclusive"):
        c.submit(CVSpec(problems=folds, validation=val,
                        tol_coarse=1e-3, tol_schedule=[1e-7] * 20))
    with pytest.raises(KeyError, match="unknown ticket"):
        c.result(10_000)


# ------------------------------------------------------------------ #
# The fused steps change no bit of the chain                         #
# ------------------------------------------------------------------ #
def _iterate(B, seed=3):
    """A batched problem (B = 0: a solo one) and a fixed iterate: x, ∇F,
    d, γ as the iteration forms them."""
    probs = [nesterov_instance(m=20, n=64, nnz_frac=0.15, c=0.7 + 0.1 * s,
                               seed=s, device="cpu") for s in range(max(B, 1))]
    if B:
        from repro_torch.solvers.batched import (_stack_instances,
                                                 family_problem)
        spec, data, c = _stack_instances(probs)
        p = family_problem(data, c.unsqueeze(-1), spec)
        lead = (B,)
    else:
        p, lead = probs[0], ()
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(lead + (64,)).astype(
        np.float32))
    cfg = SolverConfig(tau_adapt=False)
    tau = flexa._base_tau(probs[0], cfg) * torch.full(lead, 1.3).unsqueeze(-1)
    d = surrogate.curvature(p, tau, cfg.surrogate)
    gamma = torch.full(lead, 0.87)
    return p, x, p.grad_f(x), d, gamma


@pytest.mark.parametrize("B", [0, 3])
def test_fused_steps_equal_the_chain_expressions(B):
    p, x, grad, d, gamma = _iterate(B)
    assert surrogate.fused(p)
    z = surrogate.best_response(p, x, grad, d)
    z_old = soft_threshold(x - grad / d, (1.0 / d) * p.g_weight)
    assert torch.equal(z, z_old)
    xnew = surrogate.full_update(p, x, grad, d, gamma)
    x_old = x + gamma.unsqueeze(-1) * torch.ones_like(x) * (z_old - x)
    assert torch.equal(xnew, x_old)


def test_full_rule_iteration_is_bitwise_with_and_without_the_fused_update():
    """``active=None`` (the fused S.4) and an all-ones freeze mask (the
    torch expression) give the same state, bit for bit."""
    p, x, _, _, _ = _iterate(3)
    cfg = SolverConfig(jacobi=True, tau0=60.0, tau_adapt=False)
    tau = torch.full((64,), 60.0)
    s0 = flexa.init_state(p, x, cfg)
    a, _ = flexa.flexa_iteration(p, cfg, tau, s0)
    b, _ = flexa.flexa_iteration(p, cfg, tau, s0, active=torch.ones_like(x))
    for u, v in zip(a, b):
        if isinstance(u, torch.Tensor):
            assert torch.equal(u, v)


def test_group_off_keeps_the_prox():
    """G off (c = 0) is no soft threshold: the chain keeps ``problem.prox``
    and never reaches the fused steps."""
    p = dataclasses.replace(
        nesterov_instance(m=20, n=64, nnz_frac=0.15, seed=0, device="cpu"),
        g_weight=0.0)
    assert not surrogate.fused(p)
    x = torch.full((64,), -0.0)
    z = surrogate.best_response(p, x, torch.zeros(64), torch.ones(64))
    assert torch.equal(torch.signbit(z), torch.ones(64, dtype=torch.bool))


def test_cpu_chain_launches_no_kernel(batch):
    before = (flexa_prox.batched_best_response.launches,
              flexa_prox.batched_apply_update.launches)
    _, tprobs = zip(*batch)
    _client(**BUDGET, jacobi=True, tau0=60.0).run(
        BatchSpec(problems=list(tprobs)))
    assert (flexa_prox.batched_best_response.launches,
            flexa_prox.batched_apply_update.launches) == before
    assert flexa_prox._br_lib is None


def test_run_frozen_steps_no_further_than_max_iters(batch):
    """The device loop stops at max_iters steps, not at the next multiple
    of the stop-flag period."""
    _, tprobs = zip(*batch)
    calls = []
    real = flexa.flexa_iteration

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    import repro_torch.solvers.batched as batched
    try:
        batched.flexa_iteration = counted
        r = _solve_batched(list(tprobs), cfg=SolverConfig(
            max_iters=21, tol=-1.0))
    finally:
        batched.flexa_iteration = real
    assert len(calls) == 21 and (r.iters == 21).all()
