"""The port's screened, compacted λ-path against the JAX package's.

Tolerances and why:

* golden files (``tests/golden/path_lasso_V.json``,
  ``path_lasso_compact_V.json``): V at the reference's rtol 5e-4 and
  λ_max at its rel 1e-6; supports and program widths equal.
* ``device_flops`` (Σ iterations × m × width) within 2 % of the golden
  number: each point stops at ‖x̂−x‖∞ ≤ 1e-7, and fp32 sums taken in
  another order move that stop by a few iterations — the reference on
  jax 0.9.0 itself counts 2156160 against its golden 2143680.
* the port's compacted path against the reference's: x ≤ 1e-5 per
  point, equal supports.
* the port's compact path against its masked-dense path, as
  ``tests/test_compaction.py:176`` holds the reference: x ≤ 1e-5, equal
  supports, fewer device FLOPs, power-of-two widths.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.client import FlexaClient as JClient, PathSpec as JPathSpec
from repro.config.base import SolverConfig as JSolverConfig
from repro.problems.lasso import nesterov_instance as jnesterov
from repro_torch.client import FlexaClient, PathSpec
from repro_torch.config.base import SolverConfig
from repro_torch.kernels import flexa_prox
from repro_torch.path import geometric_grid, lambda_max
from repro_torch.path.driver import _solve_path
from repro_torch.problems.lasso import nesterov_instance
from repro_torch.solvers.compaction import bucket_capacity, make_plan

GOLDEN_DIR = Path(__file__).resolve().parent / "golden"
INSTANCE = dict(m=30, n=96, nnz_frac=0.1, c=1.0, seed=0)
CFG = dict(tol=1e-7, max_iters=4000, tau_adapt=False)
GRID = dict(n_points=10, lam_min_ratio=0.05)


def _path(problem, *, compact, **kw):
    return FlexaClient(device="cpu", solver=SolverConfig(**CFG)).run(
        PathSpec(problem=problem, warm=True, screen=True, compact=compact,
                 **{**GRID, **kw}))


@pytest.fixture(scope="module")
def lasso():
    return nesterov_instance(**INSTANCE, device="cpu")


@pytest.fixture(scope="module")
def compact(lasso):
    return _path(lasso, compact=True)


@pytest.fixture(scope="module")
def dense(lasso):
    return _path(lasso, compact=False)


@pytest.mark.parametrize("name,which", [
    ("path_lasso_compact_V.json", "compact"),
    ("path_lasso_V.json", "dense")])
def test_path_matches_golden(name, which, request):
    gold = json.loads((GOLDEN_DIR / name).read_text())
    assert gold["instance"] == INSTANCE and gold["grid"] == GRID
    r = request.getfixturevalue(which)
    assert r.lam_max == pytest.approx(gold["lam_max"], rel=1e-6)
    np.testing.assert_allclose(r.V, gold["V"], rtol=5e-4)
    assert [int(s) for s in r.support] == gold["support"]
    if "program_widths" in gold:
        assert r.meta["program_widths"] == gold["program_widths"]
        assert r.device_flops == pytest.approx(gold["device_flops"],
                                               rel=0.02)


def test_compact_path_matches_reference_path(compact):
    pj = jnesterov(**INSTANCE)
    rj = JClient(solver=JSolverConfig(**CFG)).run(
        JPathSpec(problem=pj, compact=True, **GRID))
    np.testing.assert_array_equal(compact.lambdas, rj.lambdas)
    np.testing.assert_allclose(compact.x, np.asarray(rj.x), atol=1e-5)
    np.testing.assert_array_equal(compact.support, rj.support)
    np.testing.assert_array_equal(compact.active_blocks, rj.active_blocks)
    assert compact.meta["program_widths"] == rj.meta["program_widths"]
    assert compact.device_flops == pytest.approx(rj.device_flops, rel=0.02)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_path_matches_dense(seed):
    p = nesterov_instance(**{**INSTANCE, "seed": seed}, device="cpu")
    d = _path(p, compact=False)
    c = _path(p, compact=True)
    np.testing.assert_allclose(c.x, d.x, atol=1e-5)
    np.testing.assert_array_equal(c.support, d.support)
    assert np.all(c.converged)
    assert c.meta["compact"] and not d.meta["compact"]
    assert 0 < c.device_flops < d.device_flops
    widths = c.meta["program_widths"]
    for w in widths:
        assert w & (w - 1) == 0
    assert len(widths) <= int(math.log2(p.n)) + 1
    assert d.meta["program_widths"] == [p.n]
    assert c.ledger.conserved() and c.ledger.device_flops == c.device_flops


def test_compact_path_is_bitwise_deterministic(lasso, compact):
    again = _path(lasso, compact=True)
    np.testing.assert_array_equal(again.x, compact.x)
    assert again.device_flops == compact.device_flops
    assert len(compact.meta["program_widths"]) > 1


def test_lambda_max_is_zero_threshold(lasso):
    lam = lambda_max(lasso)
    r = _solve_path(lasso, [lam * 1.5, lam, lam * 0.5],
                    cfg=SolverConfig(**CFG))
    assert np.all(r.x[:2] == 0) and np.any(r.x[2] != 0)
    grid = geometric_grid(lam, n_points=5, lam_min_ratio=0.1)
    assert grid[0] == lam and np.all(np.diff(grid) < 0)


def test_plan_round_trip_and_buckets():
    mask = np.zeros(40, bool)
    mask[[3, 4, 17, 39]] = True
    plan = make_plan(mask, 1)
    assert plan.capacity == bucket_capacity(4, 40) == 4
    np.testing.assert_array_equal(plan.block_idx, [3, 4, 17, 39])
    x = torch.arange(40, dtype=torch.float32)
    packed = plan.pack_vector(x)
    np.testing.assert_array_equal(packed.numpy(), [3, 4, 17, 39])
    back = plan.unpack_vector(packed)
    np.testing.assert_array_equal(back.numpy(),
                                  np.where(mask, np.arange(40), 0))
    A = torch.arange(3 * 40, dtype=torch.float32).reshape(3, 40)
    np.testing.assert_array_equal(plan.pack_columns(A).numpy(),
                                  A[:, mask].numpy())
    assert bucket_capacity(0, 40) == 1 and bucket_capacity(33, 40) == 40


def test_cpu_path_launches_no_kernel(compact):
    """On the CPU the compacted path runs the plain versions: the CUDA
    kernels' counters do not move."""
    assert flexa_prox.gather_rows.launches == 0
    assert flexa_prox.scatter_rows.launches == 0


def test_ledger_counts_program_signatures(lasso, compact, dense):
    """Eager PyTorch builds no programs: a path's ``compiles`` is the
    number of distinct program signatures it ran — one per program width
    at a single tolerance — and does not depend on earlier solves."""
    assert compact.ledger.compiles == len(compact.meta["program_widths"])
    assert dense.ledger.compiles == 1
    assert _path(lasso, compact=True).ledger.compiles \
        == compact.ledger.compiles
    tols = np.full(GRID["n_points"], CFG["tol"])
    tols[-1] = 1e-6
    mixed = _path(lasso, compact=False, tol_schedule=tols)
    assert mixed.ledger.compiles == 2
