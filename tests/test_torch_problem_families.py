"""The port's group-Lasso, logreg and svm families against the JAX package's.

Every test builds the same seeded numpy instance, runs the reference
(plain jnp: no Pallas kernel lies on these paths) and the port on the
CPU, and compares under the reference's own contracts:

* the host generators bit for bit (both round the float64 arrays to fp32
  once; logreg and svm round Y and a before Z = Y·a);
* F, ∇F, the curvature, G, V, the prox, the block norms and the
  stationarity residual at seeded points within 1e-5 relative (fp32
  products summed in another order; XLA's and torch's exp/log1p may
  differ in the last bit);
* the group prox's edge cases (a zero block, a block at the threshold)
  within 1e-7 absolute, and the screening scores within 1e-6 relative;
* the inexact best response (5 inner steps) within 1e-5, its certificate
  within 1e-5 relative, and per instance in a batch;
* 200 fixed-τ iterations: V within rtol 5e-4 (the goldens' rule), x
  within 1e-5;
* the reference's own convergence bounds (``tests/test_flexa_solver.py``)
  on the port's solves;
* batched ≡ solo ≤ 1e-5 (``tests/test_solvers_api.py``), with a group
  batch whose curvatures differ in scale;
* λ-paths (``tests/test_path.py``'s sizes) within 1e-5, equal supports,
  no KKT violation left, compacted and not.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.client import FlexaClient as JClient, PathSpec as JPathSpec
from repro.config.base import SolverConfig as JSolverConfig
from repro.core import flexa as jflexa
from repro.core import prox as jprox
from repro.core import surrogate as jsurrogate
from repro.problems import families as jfamilies
from repro.problems import group_lasso as jgroup
from repro.problems import lasso as jlasso
from repro.problems import logreg as jlogreg
from repro.problems import svm as jsvm
from repro.solvers.batched import _solve_batched as j_solve_batched
from repro_torch.client import BatchSpec, FlexaClient, PathSpec
from repro_torch.config.base import SolverConfig
from repro_torch.core import flexa, prox, surrogate
from repro_torch.path.screening import (DEFAULT_KKT_SLACK, block_scores,
                                        kkt_violations)
from repro_torch.problems import families, group_lasso, lasso, logreg, svm
from repro_torch.problems.families import problem_from_arrays
from repro_torch.solvers.batched import _solve_batched

#: (family, block size, reference constructor): each family, and logreg
#: both ℓ1 and group-ℓ2.
CASES = {
    "lasso": (1, lambda: jlasso.nesterov_instance(
        m=30, n=64, nnz_frac=0.1, c=1.0, seed=3)),
    "group_lasso": (4, lambda: jgroup.nesterov_group_instance(
        m=30, n_blocks=16, block_size=4, nnz_frac=0.2, c=1.0, seed=1)),
    "logreg": (1, lambda: jlogreg.random_logreg_instance(
        m=40, n=60, nnz_frac=0.1, c=0.5, seed=0)),
    "logreg_group": (4, lambda: jlogreg.random_logreg_instance(
        m=40, n=60, nnz_frac=0.1, c=0.5, seed=0, block_size=4)),
    "svm": (1, lambda: jsvm.random_svm_instance(
        m=40, n=50, nnz_frac=0.1, c=0.5, seed=0)),
}
#: Fixed-budget, fixed-τ runs: both packages take the same steps.
BUDGET = dict(max_iters=200, tol=-1.0, tau_adapt=False)
NEWTON = dict(surrogate="newton_cg", inexact_alpha1=0.5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These solves take thousands of tiny eager steps: one intra-op thread
    keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_of(pj, device="cpu"):
    """The port's problem from the reference's arrays."""
    arrays = {k: np.asarray(v) for k, v in pj.data.items()}
    return problem_from_arrays(pj.family, arrays, pj.g_weight,
                               block_size=pj.block_size, device=device)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    bs, make = CASES[request.param]
    pj = make()
    assert pj.block_size == bs
    return pj, _port_of(pj)


def _close(got, want, rtol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    assert got.shape == want.shape, what
    assert float(np.abs(got - want).max(initial=0.0)) <= rtol * scale, what


# ------------------------------------------------------------------ #
# Generators                                                         #
# ------------------------------------------------------------------ #
GENERATORS = [
    ("group_lasso",
     lambda: jgroup.nesterov_group_instance(40, 24, 5, 0.15, c=1.0, seed=2),
     lambda: group_lasso.nesterov_group_instance(40, 24, 5, 0.15, c=1.0,
                                                 seed=2, device="cpu")),
    ("lasso_blocks",
     lambda: jlasso.nesterov_instance(30, 96, 0.1, c=1.0, seed=1,
                                      block_size=4),
     lambda: lasso.nesterov_instance(30, 96, 0.1, c=1.0, seed=1,
                                     block_size=4, device="cpu")),
    ("logreg",
     lambda: jlogreg.random_logreg_instance(50, 80, 0.1, c=0.5, seed=4),
     lambda: logreg.random_logreg_instance(50, 80, 0.1, c=0.5, seed=4,
                                           device="cpu")),
    ("logreg_group",
     lambda: jlogreg.random_logreg_instance(50, 80, 0.1, c=0.5, seed=4,
                                            block_size=4),
     lambda: logreg.random_logreg_instance(50, 80, 0.1, c=0.5, seed=4,
                                           block_size=4, device="cpu")),
    ("svm",
     lambda: jsvm.random_svm_instance(50, 70, 0.2, c=0.5, seed=5),
     lambda: svm.random_svm_instance(50, 70, 0.2, c=0.5, seed=5,
                                     device="cpu")),
]


@pytest.mark.parametrize("name,make_j,make_t", GENERATORS,
                         ids=[g[0] for g in GENERATORS])
def test_generators_are_bitwise_identical(name, make_j, make_t):
    pj, pt = make_j(), make_t()
    assert set(pt.data) == set(pj.data)
    for key, v in pj.data.items():
        np.testing.assert_array_equal(pt.data[key].numpy(), np.asarray(v))
        assert pt.data[key].dtype == torch.float32
    if pj.x_star is not None:
        np.testing.assert_array_equal(pt.x_star.numpy(),
                                      np.asarray(pj.x_star))
    assert pt.v_star == pj.v_star
    assert (pt.name, pt.n, pt.block_size, pt.g_kind, pt.g_weight,
            pt.family) == (pj.name, pj.n, pj.block_size, pj.g_kind,
                           pj.g_weight, pj.family)
    # float64 power iteration on the card's side, numpy fp32 here
    assert pt.lipschitz == pytest.approx(pj.lipschitz, rel=1e-5)


def test_problem_from_arrays_builds_every_family():
    for name, (bs, make) in CASES.items():
        pj = make()
        pt = _port_of(pj)
        assert (pt.family, pt.block_size, pt.g_kind, pt.n) == \
            (pj.family, pj.block_size, pj.g_kind, pj.n), name
    A = np.ones((4, 6), np.float32)
    with pytest.raises(ValueError, match="group_lasso"):
        problem_from_arrays("lasso", {"A": A, "b": np.ones(4)}, 1.0,
                            block_size=2, device="cpu")
    with pytest.raises(ValueError, match="needs arrays"):
        problem_from_arrays("logreg", {"A": A}, 1.0, device="cpu")


# ------------------------------------------------------------------ #
# Problem functions                                                  #
# ------------------------------------------------------------------ #
def _points(n, seed, k=3):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32) * 0.3


def test_problem_functions_match_reference(pair):
    pj, pt = pair
    X = _points(pt.n, 7)
    X[0, : pt.block_size] = 0.0              # one zero block at least
    for x in X:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        for fn in ("f", "g", "v"):
            _close(float(getattr(pt, fn)(xt)),
                   float(getattr(pj, fn)(xj)), 1e-5, fn)
        _close(pt.grad_f(xt), pj.grad_f(xj), 1e-5, "grad_f")
        _close(pt.block_norms(xt), pj.block_norms(xj), 1e-5, "block_norms")
        t = np.abs(x) + 0.5
        _close(pt.prox(xt, torch.from_numpy(t)),
               pj.prox(xj, jnp.asarray(t)), 1e-5, "prox")
        _close(pt.prox(xt, 0.7), pj.prox(xj, 0.7), 1e-5, "prox scalar t")
        for tau in (1.0, 3.0):
            _close(float(pt.stationarity(xt, tau)),
                   float(pj.stationarity(xj, tau)), 1e-5, "stationarity")
    _close(pt.diag_curv(None), pj.diag_curv(None), 1e-5, "diag_curv")
    # rows of a batch give the per-row values
    Xt = torch.from_numpy(X)
    _close(pt.v(Xt), [float(pt.v(torch.from_numpy(x))) for x in X], 1e-6)
    _close(pt.stationarity(Xt),
           [float(pt.stationarity(torch.from_numpy(x))) for x in X], 1e-6)


def test_unknown_g_kind_raises_where_the_reference_does():
    pt = dataclasses.replace(_port_of(CASES["lasso"][1]()), g_kind="huber")
    x = torch.ones(pt.n)
    for call in (lambda: pt.g(x), lambda: pt.prox(x, 1.0)):
        with pytest.raises(ValueError, match="huber"):
            call()


def test_group_soft_threshold_edge_cases():
    v = np.array([[0.0, 0.0, 0.0],           # all-zero block
                  [3.0, 4.0, 0.0],           # norm 5, exactly at t = 5
                  [3.0, 4.0, 0.0],           # norm 5 below t = 6
                  [1e-3, -2e-3, 2e-3],       # tiny block, small t
                  [-1.0, 2.0, -2.0]], np.float32)
    t = np.array([[1.0], [5.0], [6.0], [1e-3], [1.5]], np.float32)
    got = prox.group_soft_threshold(torch.from_numpy(v), torch.from_numpy(t))
    want = np.asarray(jprox.group_soft_threshold(jnp.asarray(v),
                                                 jnp.asarray(t)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    assert not got[:3].any()
    # leading axes and a scalar t
    V = np.random.default_rng(0).standard_normal((2, 3, 4)).astype(
        np.float32)
    np.testing.assert_allclose(
        prox.group_soft_threshold(torch.from_numpy(V), 0.8).numpy(),
        np.asarray(jprox.group_soft_threshold(jnp.asarray(V), 0.8)),
        rtol=0, atol=1e-7)
    np.testing.assert_array_equal(
        prox.project_box(torch.from_numpy(V), -0.5, 0.5).numpy(),
        np.asarray(jprox.project_box(jnp.asarray(V), -0.5, 0.5)))
    np.testing.assert_array_equal(
        prox.project_nonneg(torch.from_numpy(V)).numpy(),
        np.asarray(jprox.project_nonneg(jnp.asarray(V))))


@pytest.mark.parametrize("family", ["lasso", "group_lasso", "logreg",
                                    "svm"])
@pytest.mark.parametrize("block_size", [1, 4])
def test_screen_scores_match_reference(family, block_size):
    grad = np.random.default_rng(block_size).standard_normal(48).astype(
        np.float32)
    got = families.get_family(family).screen_scores(torch.from_numpy(grad),
                                                    block_size)
    want = jfamilies.get_family(family).screen_scores(jnp.asarray(grad),
                                                      block_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_block_scores_of_a_problem_match_reference(pair):
    pj, pt = pair
    x = _points(pt.n, 11, 1)[0]
    gj = pj.grad_f(jnp.asarray(x))
    want = jfamilies.get_family(pj.family).screen_scores(gj, pj.block_size)
    got = block_scores(families.get_family(pt.family), pt, x)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


# ------------------------------------------------------------------ #
# Surrogate                                                          #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("sur", ["linear", "exact_block", "newton_cg"])
def test_curvature_matches_reference(pair, sur):
    pj, pt = pair
    tau = np.linspace(0.5, 2.0, pt.n).astype(np.float32)
    _close(surrogate.curvature(pt, torch.from_numpy(tau), sur),
           jsurrogate.curvature(pj, jnp.asarray(tau), sur), 1e-6, sur)


def _inner_curvature(p, tau, jitter, module, tensor):
    """newton_cg's d at τ, times a jitter that varies inside each block:
    with d constant on a block the one prox is already the surrogate's
    minimizer, and the certificate is rounding noise."""
    return module.curvature(p, tensor(np.full(p.n, tau, np.float32)),
                            "newton_cg") * tensor(jitter)


def test_inexact_best_response_matches_reference(pair):
    pj, pt = pair
    x = _points(pt.n, 5, 1)[0]
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    jitter = np.random.default_rng(5).uniform(1.0, 10.0, pt.n).astype(
        np.float32)
    tau = 0.3 * flexa.default_tau0(pt)
    dj = _inner_curvature(pj, tau, jitter, jsurrogate, jnp.asarray)
    dt = _inner_curvature(pt, tau, jitter, surrogate, torch.from_numpy)
    gj, gt = pj.grad_f(xj), pt.grad_f(xt)
    zj = jsurrogate.best_response(pj, xj, gj, dj, inner_iters=5, eps=0.0)
    zt = surrogate.best_response(pt, xt, gt, dt, inner_iters=5, eps=0.0)
    if pt.block_size == 1:               # exact: one prox, no certificate
        _close(zt, zj, 1e-5)
        return
    (zj, cj), (zt, ct) = zj, zt
    _close(zt, zj, 1e-5, "z")
    assert ct.shape == ()
    assert float(ct) == pytest.approx(float(cj), rel=1e-5)
    # the inner steps moved z off the one prox
    z0 = surrogate.best_response(pt, xt, gt, dt)
    assert float((zt - z0).abs().max()) > 1e-3
    _close(surrogate.best_response(pt, xt, gt, dt, inner_iters=5),
           zj, 1e-5, "z without eps")


def test_inexact_best_response_takes_L_and_mu_per_instance():
    """Rows of a batch whose curvatures differ 9× in scale: each row's z
    and certificate are its solo ones (L, μ and the norm per row)."""
    pa = _port_of(CASES["group_lasso"][1]())
    A, b = pa.data["A"].numpy(), pa.data["b"].numpy()
    pb = problem_from_arrays("group_lasso", {"A": 3.0 * A, "b": b}, 1.0,
                             block_size=4, device="cpu")
    X = torch.from_numpy(_points(pa.n, 9, 2))
    jitter = np.random.default_rng(9).uniform(1.0, 10.0, pa.n).astype(
        np.float32)
    solo = []
    for p, x in zip((pa, pb), X):
        d = _inner_curvature(p, 0.3 * flexa.default_tau0(p), jitter,
                             surrogate, torch.from_numpy)
        g = p.grad_f(x)
        solo.append((d, g, surrogate.best_response(p, x, g, d,
                                                   inner_iters=5, eps=0.0)))
    stacked = _stacked_problem([pa, pb])
    D = torch.stack([s[0] for s in solo])
    G = torch.stack([s[1] for s in solo])
    Z, cert = surrogate.best_response(stacked, X, G, D, inner_iters=5,
                                      eps=0.0)
    assert cert.shape == (2,)
    for i, (_, _, (z, c)) in enumerate(solo):
        torch.testing.assert_close(Z[i], z, rtol=0, atol=1e-6)
        assert float(cert[i]) == pytest.approx(float(c), rel=1e-6)
    assert float(solo[1][2][1]) != pytest.approx(float(solo[0][2][1]),
                                                 rel=1e-2)


def _stacked_problem(probs):
    from repro_torch.solvers.batched import (BatchedProblemSpec,
                                             family_problem)
    spec = BatchedProblemSpec.of(probs[0])
    fam = families.get_family(spec.family)
    data = tuple(torch.stack([p.data[k] for p in probs])
                 for k in fam.data_keys)
    c = torch.tensor([[float(p.g_weight)] for p in probs])
    return family_problem(data, c, spec)


# ------------------------------------------------------------------ #
# Solo parity                                                        #
# ------------------------------------------------------------------ #
SOLO = {
    "group_lasso": {},
    "group_lasso_newton": NEWTON,
    "logreg": {},
    "logreg_group": {},
    "svm": {},
}


@pytest.mark.parametrize("name", sorted(SOLO))
@pytest.mark.parametrize("rule", ["greedy", "jacobi"])
def test_solo_trajectory_matches_reference(name, rule):
    case = name.replace("_newton", "")
    pj = CASES[case][1]()
    pt = _port_of(pj)
    kw = {**BUDGET, **SOLO[name]}
    if rule == "jacobi":
        # full Jacobi at fixed τ contracts with τ near L_F (the default
        # τ diverges for the quadratic families, as chip_smoke's batch
        # phase records)
        kw.update(jacobi=True, tau0=pj.lipschitz / 2)
    certs = []
    rj = jflexa.solve(pj, cfg=JSolverConfig(**kw))
    rt = flexa.solve(pt, cfg=SolverConfig(**kw),
                     callback=lambda it, s, info: certs.append(
                         float(info["inexact_cert"])))
    assert rt.iters == rj.iters == kw["max_iters"]
    np.testing.assert_allclose(rt.history["V"], rj.history["V"],
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-5)
    if name.endswith("_newton"):
        # newton_cg's d is constant on each block, so the one prox is the
        # surrogate's minimizer and the certificate is rounding noise
        assert all(np.isfinite(certs)) and min(certs) >= 0.0
    else:
        assert set(certs) == {0.0}


# ------------------------------------------------------------------ #
# The reference's own behaviour tests (tests/test_flexa_solver.py)   #
# ------------------------------------------------------------------ #
def _rel_err(p, v):
    return abs(v - p.v_star) / abs(p.v_star)


def test_group_lasso_convergence():
    p = group_lasso.nesterov_group_instance(
        m=60, n_blocks=60, block_size=5, nnz_frac=0.15, c=1.0, seed=1,
        device="cpu")
    r = flexa.solve(p, cfg=SolverConfig(max_iters=800, tol=1e-8))
    assert _rel_err(p, r.history["V"][-1]) < 1e-3
    xb = r.x.numpy().reshape(60, 5)
    off = np.linalg.norm(p.x_star.numpy().reshape(60, 5), axis=1) == 0
    assert np.linalg.norm(xb[off], axis=1).max() < 2e-2


def test_inexact_subproblems_still_converge():
    p = group_lasso.nesterov_group_instance(
        m=50, n_blocks=40, block_size=5, nnz_frac=0.2, c=1.0, seed=2,
        device="cpu")
    r = flexa.solve(p, cfg=SolverConfig(max_iters=800, tol=1e-8, **NEWTON))
    assert _rel_err(p, r.history["V"][-1]) < 5e-3


def test_sparse_logreg_stationarity():
    p = logreg.random_logreg_instance(m=120, n=200, nnz_frac=0.1, c=0.5,
                                      seed=0, device="cpu")
    r = flexa.solve(p, cfg=SolverConfig(max_iters=1500, tol=1e-7))
    assert float(p.stationarity(r.x)) < 5e-3
    assert (np.abs(r.x.numpy()) < 1e-6).mean() > 0.3


def test_svm_stationarity():
    p = svm.random_svm_instance(m=100, n=150, nnz_frac=0.15, c=0.5, seed=0,
                                device="cpu")
    r = flexa.solve(p, cfg=SolverConfig(max_iters=3000, tol=1e-7))
    assert float(p.stationarity(r.x)) < 5e-3


# ------------------------------------------------------------------ #
# Batched ≡ solo (tests/test_solvers_api.py:147-175)                 #
# ------------------------------------------------------------------ #
BATCHES = {
    "logreg": lambda s: jlogreg.random_logreg_instance(
        m=30, n=48, nnz_frac=0.2, c=0.5, seed=s),
    "svm": lambda s: jsvm.random_svm_instance(
        m=30, n=40, nnz_frac=0.2, c=0.5, seed=s),
    "group_lasso": lambda s: jgroup.nesterov_group_instance(
        m=30, n_blocks=12, block_size=4, nnz_frac=0.2, c=1.0, seed=s),
}


@pytest.mark.parametrize("family", sorted(BATCHES))
def test_batched_matches_independent_solves(family):
    jprobs = [BATCHES[family](s) for s in range(4)]
    probs = [_port_of(pj) for pj in jprobs]
    cfg = SolverConfig(**BUDGET)
    rb = _solve_batched(probs, cfg=cfg)
    assert rb.meta["family"] == family
    assert (np.asarray(rb.iters) == 200).all()
    for i, p in enumerate(probs):
        ri = flexa.solve(p, cfg=cfg)
        assert ri.iters == 200
        np.testing.assert_allclose(rb.x[i].numpy(), ri.x.numpy(), atol=1e-5)
    # the client's BatchSpec is the same engine
    rc = FlexaClient(device="cpu", solver=cfg).run(BatchSpec(problems=probs))
    np.testing.assert_array_equal(rc.x, rb.x.numpy())


@pytest.mark.parametrize("newton", [False, True], ids=["exact", "newton"])
def test_group_batch_with_curvatures_of_another_scale(newton):
    """Two group instances whose d differ 4× in scale: each row follows
    its solo run and, under ``newton_cg``, gets its solo certificate (an
    L or μ taken across the batch changes the certificates)."""
    pj = BATCHES["group_lasso"](0)
    pa = _port_of(pj)
    A, b = pa.data["A"].numpy(), pa.data["b"].numpy()
    pb = problem_from_arrays("group_lasso", {"A": 2.0 * A, "b": b}, 1.0,
                             block_size=4, device="cpu")
    jb = jlasso.make_lasso(2.0 * A, b, 1.0, block_size=4)
    kw = {**BUDGET, **(NEWTON if newton else {})}
    rb = _solve_batched([pa, pb], cfg=SolverConfig(**kw))
    rjb = j_solve_batched([pj, jb], cfg=JSolverConfig(**kw))
    for i, p in enumerate((pa, pb)):
        ri = flexa.solve(p, cfg=SolverConfig(**kw))
        np.testing.assert_allclose(rb.x[i].numpy(), ri.x.numpy(), atol=1e-5)
        np.testing.assert_allclose(rb.x[i].numpy(), np.asarray(rjb.x[i]),
                                   atol=1e-5)
    if newton:
        # x does not see L or μ while d is constant on each block (the
        # one prox is the minimizer); the certificate does, row by row
        cfg = SolverConfig(**kw)
        solo = [(p, flexa._base_tau(p, cfg), flexa.init_state(
            p, torch.zeros(p.n), cfg)) for p in (pa, pb)]
        stacked = _stacked_problem([pa, pb])
        tau = torch.stack([t for _, t, _ in solo])
        state = flexa.init_state(stacked, torch.zeros(2, pa.n), cfg)
        certs = []
        for _ in range(20):
            state, info = flexa.flexa_iteration(stacked, cfg, tau, state)
            row = []
            for j, (p, t, st) in enumerate(solo):
                st, inf = flexa.flexa_iteration(p, cfg, t, st)
                solo[j] = (p, t, st)
                row.append(float(inf["inexact_cert"]))
            certs.append(row)
            np.testing.assert_allclose(info["inexact_cert"].numpy(), row,
                                       rtol=1e-6, atol=0)
        assert max(max(r) for r in certs) > 0.0


def test_batch_rejects_mixed_families():
    lr = _port_of(BATCHES["logreg"](0))
    sv = _port_of(jsvm.random_svm_instance(m=30, n=48, nnz_frac=0.2, c=0.5,
                                           seed=0))
    with pytest.raises(ValueError, match="shape signature"):
        _solve_batched([lr, sv])


# ------------------------------------------------------------------ #
# λ-paths (tests/test_path.py)                                       #
# ------------------------------------------------------------------ #
#: The reference's configs: tol 1e-7 for group Lasso, 1e-8 for the
#: nonquadratic families (their stopping noise at 1e-7 was ~2e-5).
PATHS = {
    "group_lasso": (lambda: jlasso.nesterov_instance(
        m=48, n=96, nnz_frac=0.1, c=1.0, seed=1, block_size=4),
        dict(tol=1e-7, max_iters=4000, tau_adapt=False),
        dict(n_points=6, lam_min_ratio=0.15)),
    "logreg": (lambda: jlogreg.random_logreg_instance(
        m=40, n=80, nnz_frac=0.1, c=0.5, seed=0),
        dict(tol=1e-8, max_iters=20_000, tau_adapt=False),
        dict(n_points=6, lam_min_ratio=0.05)),
    "svm": (lambda: jsvm.random_svm_instance(
        m=40, n=80, nnz_frac=0.1, c=0.5, seed=0),
        dict(tol=1e-8, max_iters=20_000, tau_adapt=False),
        dict(n_points=6, lam_min_ratio=0.05)),
}


@pytest.mark.parametrize("compact", [False, True],
                         ids=["dense", "compact"])
@pytest.mark.parametrize("family", sorted(PATHS))
def test_path_matches_reference(family, compact):
    make, cfg, grid = PATHS[family]
    pj = make()
    pt = _port_of(pj)
    rj = JClient(solver=JSolverConfig(**cfg)).run(
        JPathSpec(problem=pj, compact=compact, **grid))
    rt = FlexaClient(device="cpu", solver=SolverConfig(**cfg)).run(
        PathSpec(problem=pt, compact=compact, **grid))
    assert rt.meta["family"] == family
    np.testing.assert_allclose(rt.lambdas, np.asarray(rj.lambdas),
                               rtol=1e-6)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), atol=1e-5)
    np.testing.assert_array_equal(rt.support, rj.support)
    assert sum(r.screened_out for r in rt.screened) > 0
    if compact:
        assert rt.meta["program_widths"] == rj.meta["program_widths"]
    # no KKT violation left: every zero block's score within the slack
    fam = families.get_family(family)
    nb, bs = pt.n_blocks, pt.block_size
    for k, lam in enumerate(rt.lambdas):
        pk = dataclasses.replace(pt, g_weight=float(lam))
        zero = np.linalg.norm(rt.x[k].reshape(nb, bs), axis=1) == 0
        s = block_scores(fam, pk, rt.x[k])
        assert not kkt_violations(s, ~zero, float(lam),
                                  DEFAULT_KKT_SLACK).any(), k


# ------------------------------------------------------------------ #
# K-fold CV (tests/test_client.py's matrix)                          #
# ------------------------------------------------------------------ #
def _cv_folds(family):
    """K = 3 folds of one shape signature and a host scorer: validation
    MSE for group Lasso (``tests/test_client.py:_cv_data``), the mean
    held-out logistic loss for logreg (its ``score=`` route)."""
    rng = np.random.default_rng(7)
    n = 48
    x_true = np.zeros(n, np.float32)
    x_true[rng.choice(n, 6, replace=False)] = 1.0
    jfolds, tfolds, held = [], [], []
    for _ in range(3):
        A, Av = (rng.standard_normal((rows, n)).astype(np.float32)
                 for rows in (24, 12))
        if family == "group_lasso":
            b = A @ x_true + 0.3 * rng.standard_normal(24).astype(np.float32)
            bv = Av @ x_true + 0.3 * rng.standard_normal(12).astype(
                np.float32)
            pj = jlasso.make_lasso(A, b, c=1.0, block_size=4)
            held.append((Av, bv))
        else:
            a = np.where(A @ x_true > 0, 1.0, -1.0)
            av = np.where(Av @ x_true > 0, 1.0, -1.0)
            pj = jlogreg.make_logreg(A, a, c=0.5)
            held.append(Av * av[:, None])
        jfolds.append(pj)
        tfolds.append(_port_of(pj))
    if family == "group_lasso":
        return jfolds, tfolds, dict(validation=held)

    def score(i_fold, i_lambda, x):
        t = held[i_fold].astype(np.float64) @ np.asarray(x, np.float64)
        return float(np.mean(np.logaddexp(0.0, -t)))

    return jfolds, tfolds, dict(score=score)


@pytest.mark.parametrize("family", ["group_lasso", "logreg"])
def test_cv_matches_reference(family):
    from repro.client import CVSpec as JCVSpec
    from repro_torch.client import CVSpec

    cfg = dict(tol=1e-7, max_iters=4000, tau_adapt=False)
    grid = dict(n_points=5, lam_min_ratio=0.1)
    jfolds, tfolds, scoring = _cv_folds(family)
    ref = JClient(solver=JSolverConfig(**cfg)).run(
        JCVSpec(problems=jfolds, **scoring, **grid))
    got = FlexaClient(device="cpu", solver=SolverConfig(**cfg)).run(
        CVSpec(problems=tfolds, **scoring, **grid))
    np.testing.assert_allclose(got.lambdas, np.asarray(ref.lambdas),
                               rtol=1e-6)
    assert got.best_index == ref.best_index
    np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-4)
    for f, rf in zip(got.folds, ref.folds):
        assert f.meta["family"] == family and f.converged.all()
        np.testing.assert_allclose(f.x, np.asarray(rf.x), atol=1e-5)
        assert list(f.support) == list(rf.support)
    np.testing.assert_allclose(got.x_best, np.asarray(ref.x_best),
                               atol=1e-5)
