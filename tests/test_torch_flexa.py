"""The port's FLEXA core against the JAX package's.

Tolerances and why:

* the golden V trajectory (``tests/golden/flexa_lasso_V.json``) at the
  reference's own rtol 5e-4, fixed τ (the τ-controller branches on
  last-bit comparisons, see ``tests/test_golden_convergence.py``);
* x after a fixed number of iterations within 1e-5 of
  ``repro.core.flexa.solve`` — both run fp32, and only the summation
  order of the two matrix-vector products differs;
* deterministic selection masks exactly equal on the same E;
* the randomized rules (torch generators cannot give JAX's bits) are
  held to the properties of ``tests/test_selection_rules.py``;
* the device loop (``solve_compiled``) and the batched engine give the
  per-iteration driver's numbers bit for bit: same operations, same
  order, finished instances frozen.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import SolverConfig as JSolverConfig
from repro.core import flexa as jflexa
from repro.core import selection as jsel
from repro.problems import lasso as jlasso
from repro_torch.config.base import SolverConfig
from repro_torch.core import flexa, selection
from repro_torch.problems import lasso
from repro_torch.problems.families import problem_from_arrays, state_from_arrays
from repro_torch.solvers.api import _solve
from repro_torch.solvers.batched import _solve_batched

GOLDEN = Path(__file__).resolve().parent / "golden" / "flexa_lasso_V.json"
INSTANCE = dict(m=40, n=120, nnz_frac=0.1, c=1.0, seed=0)


def _pair(**inst):
    """The same instance in both packages (the port's from the
    reference's arrays)."""
    inst = {**INSTANCE, **inst}
    pj = jlasso.nesterov_instance(**inst)
    pt = problem_from_arrays("lasso", {k: np.asarray(v)
                                       for k, v in pj.data.items()},
                             inst["c"], device="cpu")
    return pj, pt


def test_trajectory_matches_golden():
    gold = json.loads(GOLDEN.read_text())
    cfg = SolverConfig(**gold["budget"], **gold["cfg_overrides"])
    p = lasso.nesterov_instance(**gold["instance"], device="cpu")
    r = _solve(p, method="flexa", cfg=cfg)
    V = np.asarray(r.history["V"], np.float64)
    assert V.shape == (len(gold["V"]),)
    np.testing.assert_allclose(V, gold["V"], rtol=5e-4, atol=1e-5)


#: Fixed-τ configurations (full Jacobi needs τ near L_F to contract).
CFGS = {
    "greedy_fixed_tau": dict(tau_adapt=False),
    "jacobi": dict(jacobi=True, tau_adapt=False, tau0=160.0),
    "southwell": dict(selection="southwell", tau_adapt=False),
    "topk_linear": dict(selection="topk", sel_k=12, surrogate="linear",
                        tau_adapt=False),
}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_x_matches_reference_after_fixed_iterations(name):
    pj, pt = _pair()
    kw = dict(max_iters=60, tol=-1.0, **CFGS[name])
    rj = jflexa.solve(pj, cfg=JSolverConfig(**kw))
    rt = flexa.solve(pt, cfg=SolverConfig(**kw))
    assert rt.iters == rj.iters == 60
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-5)
    np.testing.assert_allclose(rt.history["V"], rj.history["V"],
                               rtol=1e-5)


def test_warm_started_state_continues_like_reference():
    """A reference state carried across (``state_from_arrays``) continues
    along the reference trajectory."""
    pj, pt = _pair(seed=3)
    kw = dict(tol=-1.0, tau_adapt=False)
    jcfg, tcfg = JSolverConfig(**kw), SolverConfig(**kw)
    step = jflexa.make_step(pj, jcfg)
    s = jflexa.init_state(pj, jnp.zeros(pj.n), jcfg)
    for _ in range(25):
        s, _ = step(s)
    ts = state_from_arrays({f: np.asarray(getattr(s, f))
                            for f in s._fields if f != "key"},
                           cfg=tcfg, device="cpu")
    tau = flexa._base_tau(pt, tcfg)
    for _ in range(40):
        s, _ = step(s)
        ts, _ = flexa.flexa_iteration(pt, tcfg, tau, ts)
    assert int(ts.k) == int(s.k) == 65
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(s.x), atol=1e-5)
    assert float(ts.gamma) == pytest.approx(float(s.gamma), rel=1e-6)


E_CASES = [
    [1.0, 1.0, 1.0, 1.0],
    [0.0, 0.0, 5.0, 0.0],
    [3.0, 3.0, 3.0, 0.1, 0.2],
    list(np.linspace(0.01, 1.0, 32)),
    list(np.random.default_rng(0).uniform(0, 1, 64)),
    list(np.random.default_rng(1).exponential(1.0, 48)),
    [1e-6, 2e-6, 1.5e-6],
]


@pytest.mark.parametrize("vals", E_CASES)
@pytest.mark.parametrize("rho", [0.1, 0.5, 1.0])
def test_deterministic_masks_equal_reference(vals, rho):
    Ej = jnp.asarray(vals, jnp.float32)
    Et = torch.tensor(vals, dtype=torch.float32)
    n = len(vals)
    k = max(1, n // 2)
    pairs = [(jsel.greedy_mask(Ej, rho), selection.greedy_mask(Et, rho)),
             (jsel.southwell_mask(Ej), selection.southwell_mask(Et)),
             (jsel.topk_mask(Ej, k), selection.topk_mask(Et, k)),
             (jsel.full_mask(Ej), selection.full_mask(Et))]
    for mj, mt in pairs:
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    # a leading instance axis gives each row its own mask
    both = torch.stack([Et, Et.flip(0)])
    np.testing.assert_array_equal(
        selection.greedy_mask(both, rho)[1].numpy(),
        np.asarray(jsel.greedy_mask(Ej[::-1], rho)))


@pytest.mark.parametrize("vals", E_CASES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_and_hybrid_rule_properties(vals, seed):
    E = torch.tensor(vals, dtype=torch.float32)
    n = E.shape[0]
    for p in (0.01, 0.25, 0.9):
        m = selection.random_mask(E, p, torch.Generator().manual_seed(seed))
        assert m.shape == (n,) and set(m.unique().tolist()) <= {0.0, 1.0}
        assert m.sum() >= 1                       # empty-draw fallback
    rho = 0.5
    mask = selection.hybrid_mask(E, rho, 0.5,
                                 torch.Generator().manual_seed(seed))
    sketch = selection.random_mask(E, 0.5,
                                   torch.Generator().manual_seed(seed))
    assert (mask <= sketch).all()                 # subset of the sketch
    En = (E * sketch).numpy()
    if En.max() > 0:
        assert mask[int(En.argmax())] == 1        # sketch argmax kept
        assert (En[mask.numpy() > 0] >= rho * En.max() * (1 - 1e-6)).all()


@pytest.mark.parametrize("n", [3, 10, 64])
@pytest.mark.parametrize("seed", [0, 5])
def test_cyclic_rule_covers_every_block_each_cycle(n, seed):
    chunks = min(4, n)
    masks = [selection.cyclic_shuffle_mask(n, k, chunks, seed).numpy()
             for k in range(chunks)]
    total = np.stack(masks).sum(axis=0)
    assert (total == 1).all()                     # disjoint AND covering
    sizes = [m.sum() for m in masks]
    assert max(sizes) - min(sizes) <= 1           # balanced
    np.testing.assert_array_equal(
        masks[0], selection.cyclic_shuffle_mask(n, chunks, chunks,
                                                seed).numpy())
    # more chunks than blocks clamps: never an empty Sᵏ
    for k in range(2 * n):
        assert selection.cyclic_shuffle_mask(n, k, n + 3, seed).sum() == 1


@pytest.mark.parametrize("rule", ["random", "hybrid", "cyclic"])
def test_randomized_rules_solve_to_the_optimum(rule):
    p = lasso.nesterov_instance(**INSTANCE, device="cpu")
    r = flexa.solve_compiled(p, cfg=SolverConfig(
        selection=rule, sel_p=0.5, max_iters=6000, tol=1e-6))
    assert r.converged
    v = float(p.v(r.x))
    assert (v - p.v_star) / p.v_star < 1e-4


@pytest.fixture(scope="module")
def lasso80():
    """The instance of ``tests/test_flexa_solver.py``."""
    return lasso.nesterov_instance(m=80, n=400, nnz_frac=0.1, c=1.0, seed=0,
                                   device="cpu")


def test_adaptive_tau_converges_to_planted_optimum(lasso80):
    """Adaptive τ is held by behaviour (its branches flip on last-bit
    comparisons): the bounds of ``tests/test_flexa_solver.py``."""
    p = lasso80
    r = flexa.solve(p, cfg=SolverConfig(max_iters=600, tol=1e-8))
    assert (r.history["V"][-1] - p.v_star) / p.v_star < 1e-5
    big = p.x_star.abs() > 0.2
    assert (r.x[big].abs() > 0.05).all()
    assert int(r.state.n_tau_changes) <= flexa.MAX_TAU_CHANGES
    r200 = flexa.solve(p, cfg=SolverConfig(max_iters=200, tol=0))
    V = np.asarray(r200.history["V"])
    assert (np.diff(V) > 1e-6 * np.abs(V[:-1])).sum() <= 10
    assert (V[-1] - p.v_star) / (V[0] - p.v_star) < 1e-3


def test_greedy_beats_full_jacobi(lasso80):
    """Paper §4: updating a greedy ρ-subset converges faster than all."""
    rg = _solve(lasso80, "flexa", SolverConfig(max_iters=300, tol=0))
    rj = _solve(lasso80, "jacobi", SolverConfig(max_iters=300, tol=0))
    assert rj.method == "jacobi"
    assert rg.history["V"][-1] <= rj.history["V"][-1] * 1.05


@pytest.mark.parametrize("tol", [-1.0, 1e-5])
def test_solve_compiled_equals_solve(tol):
    p = lasso.nesterov_instance(**INSTANCE, device="cpu")
    cfg = SolverConfig(max_iters=203, tol=tol)
    a = flexa.solve(p, cfg=cfg)
    b = flexa.solve_compiled(p, cfg=cfg)
    assert a.iters == b.iters and a.converged == b.converged
    assert torch.equal(a.x, b.x)
    assert float(a.state.stat) == float(b.state.stat)


def test_batched_rows_equal_solo_solves():
    """Two weights of one instance in one batched solve: each row follows
    its solo trajectory (≤1e-5 over 100 iterations: the batched products
    sum in another order, and over hundreds of iterations that can flip
    a greedy-threshold tie), and the history and device loops agree bit
    for bit, also when the rows stop at different iterations."""
    import dataclasses
    p = lasso.nesterov_instance(**INSTANCE, device="cpu")
    probs = [dataclasses.replace(p, g_weight=c) for c in (1.0, 0.4)]
    fixed = SolverConfig(max_iters=100, tol=-1.0, tau_adapt=False)
    rb = _solve_batched(probs, cfg=fixed)
    np.testing.assert_array_equal(rb.iters, [100, 100])
    for i, q in enumerate(probs):
        rs = flexa.solve_compiled(q, cfg=fixed)
        np.testing.assert_allclose(rb.x[i].numpy(), rs.x.numpy(),
                                   atol=1e-5)
    cfg = SolverConfig(max_iters=3000, tol=1e-6, tau_adapt=False)
    rb = _solve_batched(probs, cfg=cfg)
    rh = _solve_batched(probs, cfg=cfg, record_history=True)
    assert rb.converged.all() and rb.iters[0] != rb.iters[1]
    assert torch.equal(rb.x, rh.x)
    np.testing.assert_array_equal(rb.iters, rh.iters)
