"""The port's problem layer against the JAX package's.

* ``nesterov_instance`` is a host copy of the reference generator: the
  same seed gives the same A, b, x* and V* bit for bit (both packages
  round the float64 instance to fp32 once, to nearest).
* ``problem_from_arrays`` builds the port's Lasso from the reference's
  own arrays; V and ∇F at random points agree within 1e-6 relative (fp32
  products summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.problems import families as jfamilies
from repro.problems import lasso as jlasso
from repro_torch.device import resolve_device
from repro_torch.problems import families, lasso
from repro_torch.problems.families import problem_from_arrays, problem_on

SHAPES = [dict(m=40, n=120, nnz_frac=0.1, c=1.0, seed=0),
          dict(m=30, n=96, nnz_frac=0.1, c=1.0, seed=2),
          dict(m=25, n=70, nnz_frac=0.2, c=0.5, seed=7)]


@pytest.mark.parametrize("inst", SHAPES)
def test_nesterov_instance_is_bitwise_identical(inst):
    pj = jlasso.nesterov_instance(**inst)
    pt = lasso.nesterov_instance(**inst, device="cpu")
    for key in ("A", "b"):
        np.testing.assert_array_equal(pt.data[key].numpy(),
                                      np.asarray(pj.data[key]))
        assert pt.data[key].dtype == torch.float32
    np.testing.assert_array_equal(pt.x_star.numpy(), np.asarray(pj.x_star))
    assert pt.v_star == pj.v_star
    assert (pt.n, pt.block_size, pt.g_weight, pt.family) == \
        (pj.n, pj.block_size, pj.g_weight, pj.family)
    assert pt.lipschitz == pytest.approx(pj.lipschitz, rel=1e-6)


@pytest.mark.parametrize("inst", SHAPES)
def test_problem_from_arrays_matches_reference(inst):
    pj = jlasso.nesterov_instance(**inst)
    arrays = {k: np.asarray(v) for k, v in pj.data.items()}
    pt = problem_from_arrays("lasso", arrays, inst["c"], block_size=1,
                             device="cpu")
    rng = np.random.default_rng(inst["seed"])
    X = rng.standard_normal((4, pt.n)).astype(np.float32)
    for x in X:
        vj, gj = float(pj.v(jnp.asarray(x))), np.asarray(
            pj.grad_f(jnp.asarray(x)))
        xt = torch.from_numpy(x)
        assert float(pt.v(xt)) == pytest.approx(vj, rel=1e-6)
        np.testing.assert_allclose(pt.grad_f(xt).numpy(), gj, rtol=1e-6,
                                   atol=1e-6 * np.abs(gj).max())
    np.testing.assert_allclose(pt.diag_curv(None).numpy(),
                               np.asarray(pj.diag_curv(None)), rtol=1e-6)
    # batched rows (leading dimension) give the per-row values
    V = pt.v(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(
        V, [float(pt.v(torch.from_numpy(x))) for x in X], rtol=1e-6)


def test_problem_on_keeps_the_instance():
    p = lasso.nesterov_instance(20, 50, 0.1, device="cpu")
    assert problem_on(p, "cpu") is p
    q = problem_on(p, torch.device("cpu"))
    assert q is p


def test_every_reference_family_is_registered():
    assert families.NOT_YET_PORTED == ()
    assert families.available_families() == \
        jfamilies.available_families() == \
        ("group_lasso", "lasso", "logreg", "svm")
    p = lasso.make_lasso(np.ones((4, 6)), np.ones(4), 1.0, block_size=2,
                         device="cpu")
    assert (p.family, p.g_kind, p.n_blocks) == ("group_lasso", "group_l2", 3)


def test_cuda_default_raises_without_cuda(monkeypatch):
    """Entry points default to the card; without CUDA they raise rather
    than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lasso.nesterov_instance(10, 20, 0.1)
    assert resolve_device("cpu") == torch.device("cpu")
