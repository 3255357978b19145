"""The port's front door against the JAX package's, end to end.

``FlexaClient(device="cpu")`` running a ``SoloSpec`` and a
``PathSpec(compact=True)`` matches the reference ``FlexaClient`` within
1e-5 (fp32, sums in another order), with equal supports on the path.
"""
import numpy as np
import pytest
import torch

from repro.client import (FlexaClient as JClient, PathSpec as JPathSpec,
                          SoloSpec as JSoloSpec)
from repro.config.base import SolverConfig as JSolverConfig
from repro.problems.lasso import nesterov_instance as jnesterov
from repro_torch.client import (BatchSpec, CVSpec, FlexaClient,
                                NotPortedError, PathSpec, SoloSpec,
                                SpecError, UnknownBackendError,
                                solve_request_of)
from repro_torch.config.base import ClientConfig, SolverConfig
from repro_torch.problems.families import problem_from_arrays

INSTANCE = dict(m=40, n=160, nnz_frac=0.1, c=1.0, seed=4)


@pytest.fixture(scope="module")
def pair():
    pj = jnesterov(**INSTANCE)
    pt = problem_from_arrays("lasso", {k: np.asarray(v)
                                       for k, v in pj.data.items()},
                             INSTANCE["c"], device="cpu")
    return pj, pt


@pytest.mark.parametrize("method", ["flexa", "flexa_compiled", "jacobi"])
def test_solo_matches_reference_client(pair, method):
    pj, pt = pair
    kw = dict(max_iters=400, tol=1e-6, tau_adapt=False)
    if method == "jacobi":
        kw["tau0"] = 400.0          # full Jacobi contracts at τ near L_F
    rj = JClient(solver=JSolverConfig(**kw)).run(
        JSoloSpec(problem=pj, method=method))
    rt = FlexaClient(device="cpu", solver=SolverConfig(**kw)).run(
        SoloSpec(problem=pt, method=method))
    assert isinstance(rt.x, np.ndarray) and rt.backend == "inline"
    np.testing.assert_allclose(rt.x, rj.x, atol=1e-5)
    assert abs(rt.iters - rj.iters) <= 2
    assert rt.converged == rj.converged
    assert rt.raw.method == method


def test_compact_path_matches_reference_client(pair):
    pj, pt = pair
    kw = dict(tol=1e-7, max_iters=4000, tau_adapt=False)
    grid = dict(n_points=8, lam_min_ratio=0.1, compact=True)
    rj = JClient(solver=JSolverConfig(**kw)).run(JPathSpec(problem=pj,
                                                           **grid))
    client = FlexaClient(device="cpu", solver=SolverConfig(**kw))
    rt = client.run(PathSpec(problem=pt, **grid))
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), atol=1e-5)
    np.testing.assert_array_equal(rt.support, rj.support)
    assert rt.meta["program_widths"] == rj.meta["program_widths"]
    np.testing.assert_allclose(rt.V, rj.V, rtol=1e-5)
    diag = client.diagnostics(0)
    assert diag.done and diag.kind == "path"
    assert diag.requests[0]["iters"] == int(rt.iters.sum())
    snap = client.stats()["telemetry"]
    ref_snap = JClient().stats()["telemetry"]
    assert set(snap) == set(ref_snap)
    assert snap["completed"] == 1 and snap["iters_total"] == rt.iters.sum()
    # per-point stops move by a few iterations with summation order
    assert rt.ledger.conserved()
    assert rt.ledger.row_iters == pytest.approx(rj.ledger.row_iters,
                                                rel=0.02)


def test_default_device_is_the_card(monkeypatch):
    """Without CUDA the default client raises instead of running on the
    CPU; asking for the CPU works."""
    assert ClientConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FlexaClient()
    assert FlexaClient(device="cpu").device == torch.device("cpu")


def test_unported_parts_raise(pair):
    _, pt = pair
    for make in (lambda: BatchSpec([pt]), lambda: CVSpec([pt]),
                 lambda: solve_request_of(pt),
                 lambda: FlexaClient(device="cpu", backend="continuous")):
        with pytest.raises(NotPortedError, match="not yet ported"):
            make()
    with pytest.raises(UnknownBackendError):
        FlexaClient(device="cpu", backend="nope")
    client = FlexaClient(device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        client.run(SoloSpec(problem=pt, method="fista"))
    with pytest.raises(SpecError):
        client.submit(object())
    with pytest.raises(SpecError):
        client.run(SoloSpec(problem="not a problem"))
