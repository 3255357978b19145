"""The paper's §4 baselines in the port against the JAX package's.

FISTA, ADMM, GRock and Gauss-Seidel run through the port's registry on
the CPU (``device="cpu"``; Gauss-Seidel's sweep through the plain
version of its CUDA kernel) and are held against the reference:

* the golden V trajectories of ``tests/golden`` (fista, admm) at the
  reference's rtol 5e-4 / atol 1e-5;
* x after a fixed budget, on the same numpy instance, within 1e-5 — ADMM
  within 2e-5: its Gram product and Cholesky factor round otherwise than
  XLA's and ``jax.scipy``'s, and it reaches 5.7e-6–7.6e-6 here (50–300
  iterations, measured); V within 1e-5 relative throughout;
* the claims of ``tests/test_baselines.py`` and of
  ``tests/test_system.py::test_fig1_ranking_reproduces_miniature``;
* the registry: ``P`` and ``rho`` reach the methods through ``SoloSpec``,
  unknown options raise ``TypeError``, ``pflexa`` alone is unported.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from repro.config.base import SolverConfig as JSolverConfig
from repro.problems.lasso import nesterov_instance as jnesterov
from repro.solvers.api import _solve as jsolve
from repro_torch.baselines import admm, fista, gauss_seidel, grock
from repro_torch.client import FlexaClient, SoloSpec
from repro_torch.config.base import SolverConfig
from repro_torch.core import flexa
from repro_torch.problems.lasso import nesterov_instance
from repro_torch.solvers import registry
from repro_torch.solvers.api import _solve

GOLDEN_DIR = Path(__file__).resolve().parent / "golden"
#: tests/test_baselines.py's instance
INSTANCE = dict(m=80, n=400, nnz_frac=0.05, c=1.0, seed=1)


@pytest.fixture(scope="module")
def lasso():
    return nesterov_instance(**INSTANCE, device="cpu")


@pytest.fixture(scope="module")
def jlasso():
    return jnesterov(**INSTANCE)


def rel(p, v):
    return (v - p.v_star) / p.v_star


@pytest.mark.parametrize("method", ["fista", "admm"])
def test_trajectory_matches_golden(method):
    gold = json.loads((GOLDEN_DIR / f"{method}_lasso_V.json").read_text())
    p = nesterov_instance(**gold["instance"], device="cpu")
    r = _solve(p, method=method,
               cfg=SolverConfig(**gold["budget"], **gold["cfg_overrides"]),
               **gold["options"])
    assert r.method == method and r.iters == len(gold["V"])
    np.testing.assert_allclose(r.history["V"], gold["V"], rtol=5e-4,
                               atol=1e-5)


#: (method, options, budget, x tolerance): GRock with P = 16 diverges on
#: this instance (V 10 → 511 in 5 iterations), so its budget stops before
#: x grows past the reach of an absolute tolerance.
PARITY = [("fista", {}, 300, 1e-5), ("admm", {"rho": 10.0}, 300, 2e-5),
          ("admm", {"rho": 10.0}, 50, 2e-5), ("grock", {"P": 1}, 300, 1e-5),
          ("grock", {"P": 16}, 5, 1e-5), ("gauss_seidel", {}, 10, 1e-5)]


@pytest.mark.parametrize("method,options,iters,tol", PARITY, ids=str)
def test_x_matches_reference(lasso, jlasso, method, options, iters, tol):
    rj = jsolve(jlasso, method=method,
                cfg=JSolverConfig(max_iters=iters, tol=0.0), **options)
    rt = _solve(lasso, method=method,
                cfg=SolverConfig(max_iters=iters, tol=0.0), **options)
    assert rt.iters == rj.iters == iters and rt.method == method
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=tol)
    np.testing.assert_allclose(rt.history["V"], rj.history["V"], rtol=1e-5)
    # stat is a max |difference| of two iterates: up to twice x's error
    np.testing.assert_allclose(rt.history["stat"], rj.history["stat"],
                               rtol=1e-4, atol=2 * tol)
    assert len(rt.history["time"]) == iters


def test_fista_converges(lasso):
    r = fista.solve(lasso, max_iters=1500, tol=1e-8)
    assert rel(lasso, r.history["V"][-1]) < 1e-4


def test_admm_converges(lasso):
    r = admm.solve(lasso, rho=10.0, max_iters=1500, tol=1e-6)
    assert rel(lasso, r.history["V"][-1]) < 1e-3


def test_gauss_seidel_converges(lasso):
    r = gauss_seidel.solve(lasso, max_iters=60, tol=1e-8)
    assert rel(lasso, r.history["V"][-1]) < 1e-3


def test_grock_serial_converges(lasso):
    r = grock.solve(lasso, P=1, max_iters=1500, tol=1e-8)
    assert rel(lasso, r.history["V"][-1]) < 1e-3


def test_grock_parallel_unstable_on_denser_problem():
    """GRock's spectral-radius condition fails on correlated columns, the
    weakness the paper's damped scheme fixes (§4); the loop stops at the
    first non-finite V."""
    dense = nesterov_instance(m=100, n=500, nnz_frac=0.1, c=1.0, seed=0,
                              device="cpu")
    rg = grock.solve(dense, P=32, max_iters=500, tol=1e-8)
    v = rg.history["V"]
    diverged = not np.isfinite(v[-1]) or v[-1] > dense.v_star * 10
    assert np.isfinite(v[:-1]).all() and len(v) == rg.iters
    rf = flexa.solve(dense, cfg=SolverConfig(max_iters=500, tol=1e-8))
    assert rel(dense, rf.history["V"][-1]) < 1e-3 and diverged


def test_all_solvers_agree_on_solution(lasso):
    xs = {
        "flexa": flexa.solve(lasso, cfg=SolverConfig(max_iters=800,
                                                     tol=1e-9)).x,
        "fista": fista.solve(lasso, max_iters=2500, tol=1e-9).x,
        "gs": gauss_seidel.solve(lasso, max_iters=80, tol=1e-9).x,
    }
    ref = xs["flexa"].numpy()
    for name, x in xs.items():
        assert np.abs(x.numpy() - ref).max() < 5e-3, name


def test_fig1_ranking_reproduces_miniature():
    """Paper Fig. 1's qualitative claims at miniature scale, through the
    port's client: FPA ≥ FISTA at matched iteration budgets, FPA within
    1e-4 of V*, GRock(P=32) fragile on the lower-sparsity instance."""
    p = nesterov_instance(m=100, n=500, nnz_frac=0.1, c=1.0, seed=0,
                          device="cpu")
    client = FlexaClient(device="cpu",
                         solver=SolverConfig(max_iters=500, tol=0))

    def final(method, **options):
        r = client.run(SoloSpec(problem=p, method=method, options=options))
        return rel(p, r.raw.history["V"][-1])

    fpa = final("flexa")
    assert fpa < final("fista") and fpa < 1e-4
    gr = final("grock", P=32)
    assert not np.isfinite(gr) or gr > fpa


#: benchmarks/fig1.py's fig1c group at its full size (m 2000, n 10000, 5 %
#: nnz), seed 0, and the witness's budget.
FIG1C = dict(m=2000, n=10_000, nnz_frac=0.05, c=1.0, seed=0)
FIG1C_ITERS = 100


@pytest.fixture(scope="module")
def fig1c():
    return (nesterov_instance(**FIG1C, device="cpu"), jnesterov(**FIG1C))


@pytest.mark.parametrize("method,rtol", [("fista", 1e-5), ("flexa", 1e-3)])
def test_fig1c_history_follows_reference(fig1c, method, rtol):
    """The race's witness at a Fig. 1 group's full size: the port's V
    history against the reference's, 100 iterations from the same seed on
    the CPU.  FISTA's follows to 8.0e-7 relative.  FPA's follows to
    1.1e-6 for 88 iterations, τ and γ equal throughout; then its greedy
    selection meets a near-tie (the selected fraction parts in its last
    bits) and V parts by up to 5.0e-4 (measured), hence 1e-3.  FPA leads
    FISTA here (0.036 against 0.444), the paper's order.  Run with ``-s``
    for the readings."""
    p, jp = fig1c
    cfg = dict(max_iters=FIG1C_ITERS, tol=0.0)
    rt = _solve(p, method=method, cfg=SolverConfig(**cfg))
    rj = jsolve(jp, method=method, cfg=JSolverConfig(**cfg))
    vt, vj = np.asarray(rt.history["V"]), np.asarray(rj.history["V"])
    assert rt.iters == rj.iters == FIG1C_ITERS
    assert p.v_star == jp.v_star
    gap = np.abs(vt - vj) / np.abs(vj)
    far = np.nonzero(gap > 1e-5)[0]
    print(f"\nfig1c {method}: V rel gap max {gap.max():.3e} at iteration "
          f"{gap.argmax() + 1}, first above 1e-5 at "
          f"{far[0] + 1 if far.size else None}"
          f"; (V - V*)/V* port {rel(p, vt[-1]):.6g}, reference "
          f"{rel(jp, vj[-1]):.6g}")
    np.testing.assert_allclose(vt, vj, rtol=rtol)
    if method == "flexa":
        fista_v = _solve(p, method="fista",
                         cfg=SolverConfig(**cfg)).history["V"][-1]
        assert rel(p, vt[-1]) < rel(p, fista_v)


def test_solo_spec_passes_p_and_rho(lasso):
    """``options`` reach the method: GRock's P (default 16) and ADMM's ρ
    (default 10), each run equal to a direct call of its module."""
    client = FlexaClient(device="cpu", solver=SolverConfig(max_iters=20,
                                                           tol=0.0))

    def run(method, **options):
        return client.run(SoloSpec(problem=lasso, method=method,
                                   options=options)).x

    for P in (1, 16):
        np.testing.assert_array_equal(
            run("grock", P=P),
            grock.solve(lasso, P=P, max_iters=20, tol=0.0).x.numpy())
    np.testing.assert_array_equal(run("grock"), run("grock", P=16))
    for rho in (2.0, 10.0):
        np.testing.assert_array_equal(
            run("admm", rho=rho),
            admm.solve(lasso, rho=rho, max_iters=20, tol=0.0).x.numpy())
    np.testing.assert_array_equal(run("admm"), run("admm", rho=10.0))
    assert not np.array_equal(run("admm", rho=2.0), run("admm"))
    assert not np.array_equal(run("grock", P=1), run("grock"))


@pytest.mark.parametrize("method,bad", [
    ("fista", {"rho": 1.0}), ("admm", {"P": 4}), ("grock", {"rho": 1.0}),
    ("gauss_seidel", {"P": 1})], ids=str)
def test_unknown_options_raise_type_error(lasso, method, bad):
    with pytest.raises(TypeError, match="unknown solver options"):
        FlexaClient(device="cpu").run(SoloSpec(problem=lasso, method=method,
                                               options=bad))


def test_registry_resolves_the_baselines():
    assert registry.NOT_YET_PORTED == ("pflexa",)
    for name, module in (("fista", fista), ("admm", admm), ("grock", grock),
                         ("gauss_seidel", gauss_seidel)):
        assert callable(registry.get_solver(name))
        assert name in registry.available_methods()
        assert module.solve.__module__ == f"repro_torch.baselines.{name}"
    with pytest.raises(NotImplementedError, match="not yet ported"):
        registry.get_solver("pflexa")


def test_baselines_stop_on_tol_and_keep_x0(lasso):
    """A start point is not written to (Gauss-Seidel sweeps in place), and
    a loose tol stops every method early with ``converged``."""
    import torch
    x0 = torch.zeros(lasso.n)
    for method, options in (("fista", {}), ("admm", {}), ("grock", {"P": 1}),
                            ("gauss_seidel", {})):
        r = _solve(lasso, method=method, x0=x0,
                   cfg=SolverConfig(max_iters=500, tol=1e-2), **options)
        assert r.converged and r.iters < 500, method
        assert r.history["stat"][-1] <= 1e-2
    assert not x0.any()
