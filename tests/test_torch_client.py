"""The port's front door against the JAX package's, end to end.

``FlexaClient(device="cpu")`` running a ``SoloSpec`` and a
``PathSpec(compact=True)`` matches the reference ``FlexaClient`` within
1e-5 (fp32, sums in another order), with equal supports on the path,
for the families of the reference's matrix (``tests/test_client.py``):
solo over ``SOLO_FAMILIES``, the compacted path over ``PATH_FAMILIES``.
"""
import numpy as np
import pytest
import torch

from repro.client import (FlexaClient as JClient, PathSpec as JPathSpec,
                          SoloSpec as JSoloSpec)
from repro.config.base import SolverConfig as JSolverConfig
from repro.problems.lasso import nesterov_instance as jnesterov
from repro.problems.logreg import random_logreg_instance as jlogreg
from repro_torch.client import (ClientError, FlexaClient, NotPortedError,
                                PathSpec, SoloSpec, SpecError,
                                UnknownBackendError, solve_request_of)
from repro_torch.config.base import ClientConfig, SolverConfig
from repro_torch.problems.families import problem_from_arrays

INSTANCE = dict(m=40, n=160, nnz_frac=0.1, c=1.0, seed=4)
SOLO_FAMILIES = ("lasso", "logreg")
PATH_FAMILIES = ("lasso", "group_lasso")


def _pair(family):
    if family == "logreg":                  # tests/test_client.py's
        pj = jlogreg(m=24, n=48, nnz_frac=0.15, c=0.5, seed=0)
    else:
        pj = jnesterov(**INSTANCE,
                       block_size=4 if family == "group_lasso" else 1)
    pt = problem_from_arrays(family, {k: np.asarray(v)
                                      for k, v in pj.data.items()},
                             pj.g_weight, block_size=pj.block_size,
                             device="cpu")
    return pj, pt


@pytest.fixture(scope="module")
def pair():
    return _pair("lasso")


@pytest.mark.parametrize("family", SOLO_FAMILIES)
@pytest.mark.parametrize("method", ["flexa", "flexa_compiled", "jacobi"])
def test_solo_matches_reference_client(family, method):
    pj, pt = _pair(family)
    kw = dict(max_iters=400, tol=1e-6, tau_adapt=False)
    if family == "logreg":          # the reference matrix's solver config
        kw.update(max_iters=4000, tol=1e-7)
    if method == "jacobi":
        # full Jacobi contracts at τ near L_F (400 for the Lasso)
        kw["tau0"] = 400.0 if family == "lasso" else pj.lipschitz / 2
    rj = JClient(solver=JSolverConfig(**kw)).run(
        JSoloSpec(problem=pj, method=method))
    rt = FlexaClient(device="cpu", solver=SolverConfig(**kw)).run(
        SoloSpec(problem=pt, method=method))
    assert isinstance(rt.x, np.ndarray) and rt.backend == "inline"
    np.testing.assert_allclose(rt.x, rj.x, atol=1e-5)
    # logreg's stop at tol 1e-7 sits at its fp32 floor (the reference's
    # tests/test_path.py:224-228): the count moves by a few per thousand
    slack = 2 if family == "lasso" else rj.iters // 200
    assert abs(rt.iters - rj.iters) <= slack
    assert rt.converged == rj.converged
    assert rt.raw.method == method


@pytest.mark.parametrize("family", PATH_FAMILIES)
def test_compact_path_matches_reference_client(family):
    pj, pt = _pair(family)
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
    req = solve_request_of(pt)
    np.testing.assert_array_equal(req.A, pt.data["A"].numpy())
    assert (req.family, req.c, req.spec.n) == ("lasso", 1.0, pt.n)
    for backend in ("wave", "continuous"):
        assert FlexaClient(device="cpu", backend=backend).backend == backend
    with pytest.raises(NotPortedError, match="not yet ported"):
        FlexaClient(device="cpu", backend="mesh")
    # the remote backend is ported: without a server URL it refuses
    with pytest.raises(ClientError, match="remote_url"):
        FlexaClient(device="cpu", backend="remote")
    with pytest.raises(UnknownBackendError):
        FlexaClient(device="cpu", backend="nope")
    client = FlexaClient(device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        client.run(SoloSpec(problem=pt, method="pflexa"))
    with pytest.raises(SpecError):
        client.submit(object())
    with pytest.raises(SpecError):
        client.run(SoloSpec(problem="not a problem"))
