"""The port's kernels (best response, gather/scatter) against the JAX
package's.

On the CPU the port dispatches to its plain torch versions
(``repro_torch.kernels.ref``); those, and the dispatch
``repro_torch.kernels.ops``, must equal the reference's Pallas kernels
run in interpret mode (``force="interpret"``) and its jnp oracles
exactly: both functions only move data, so any difference is a bug, not
rounding.  The best response's z is elementwise fp32 arithmetic in the
same order in both packages, so it must be equal too; its e2 is a sum
taken in another order, held within 1e-5 relative (the reference's own
interpret and ref paths differ by ≈ 5e-7).  Inputs are made once with
numpy and handed to both packages.

``tests/test_torch_kernels_cuda.py`` holds the CUDA kernels against the
plain versions on the card.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flexa_prox
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _plan_arrays(n_rows, k_active, seed, cap=None):
    """(idx, inv): idx packs k active rows ascending with −1 padding up to
    a power-of-two capacity (or ``cap``), inv is the inverse permutation."""
    rng = np.random.default_rng(seed)
    act = np.sort(rng.choice(n_rows, size=k_active, replace=False))
    if cap is None:
        cap = max(1, 1 << (max(k_active, 1) - 1).bit_length())
    idx = np.full(cap, -1, np.int32)
    idx[:k_active] = act
    inv = np.full(n_rows, -1, np.int32)
    inv[act] = np.arange(k_active, dtype=np.int32)
    return idx, inv


#: (n_rows, k_active, capacity, C, src dtype): K=1, all −1, C ∈ {1, 37,
#: 128, 300}, N ≠ K, and bf16 / fp16 sources.
CASES = [
    (16, 5, None, 1, "float32"),
    (16, 5, None, 37, "float32"),
    (12, 1, 1, 128, "float32"),          # K = 1
    (8, 0, 4, 96, "float32"),            # every slot padding (all −1)
    (40, 23, None, 300, "float32"),      # N ≠ K, ragged C
    (8, 8, None, 37, "float32"),         # everything active
    (16, 5, None, 300, "bfloat16"),
    (16, 5, None, 128, "float16"),
]


def _src(n_rows, C, dtype, seed):
    """The same source rows in both packages (rounded once, identically)."""
    a = np.random.default_rng(seed).standard_normal((n_rows, C)).astype(
        np.float32)
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    np.testing.assert_array_equal(np.asarray(j.astype(jnp.float32)),
                                  t.float().numpy())
    return j, t


@pytest.mark.parametrize("n_rows,k,cap,C,dtype", CASES)
def test_gather_matches_reference_exactly(n_rows, k, cap, C, dtype):
    idx, _ = _plan_arrays(n_rows, k, seed=n_rows + k + C, cap=cap)
    src_j, src_t = _src(n_rows, C, dtype, seed=C)
    want = np.asarray(jops.gather_blocks(src_j, jnp.asarray(idx),
                                         force="interpret"))
    np.testing.assert_array_equal(
        want, np.asarray(jref.gather_rows_ref(src_j, jnp.asarray(idx))))
    plain = tref.gather_rows_ref(src_t, torch.from_numpy(idx))
    via_ops = tops.gather_blocks(src_t, idx)
    assert plain.dtype == via_ops.dtype == torch.float32
    assert plain.shape == (idx.size, C)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(via_ops.numpy(), want)
    np.testing.assert_array_equal(via_ops.numpy()[idx < 0], 0.0)


@pytest.mark.parametrize("n_rows,k,cap,C,dtype", CASES)
def test_scatter_matches_reference_exactly(n_rows, k, cap, C, dtype):
    idx, inv = _plan_arrays(n_rows, k, seed=n_rows + k + C, cap=cap)
    vals_j, vals_t = _src(idx.size, C, "float32", seed=C + 1)
    base_j, base_t = _src(n_rows, C, dtype, seed=C + 2)
    inv_j = jnp.asarray(inv)
    want = np.asarray(jops.scatter_blocks(vals_j, inv_j, base_j,
                                          force="interpret").astype(
        jnp.float32))
    for other in (jops.scatter_blocks(vals_j, inv_j, base_j),
                  jref.scatter_rows_ref(vals_j, inv_j, base_j)):
        np.testing.assert_array_equal(
            np.asarray(other.astype(jnp.float32)), want)
    plain = tref.scatter_rows_ref(vals_t, torch.from_numpy(inv), base_t)
    via_ops = tops.scatter_blocks(vals_t, inv, base_t)
    assert plain.dtype == via_ops.dtype == base_t.dtype
    np.testing.assert_array_equal(plain.float().numpy(), want)
    np.testing.assert_array_equal(via_ops.float().numpy(), want)
    # rows without a slot keep the base, every other row is its value
    np.testing.assert_array_equal(via_ops[inv < 0].float().numpy(),
                                  base_t[inv < 0].float().numpy())


def test_gather_scatter_round_trip():
    """Scattering a gathered pack onto zeros restores the active rows."""
    idx, inv = _plan_arrays(32, 9, seed=3)
    src = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (32, 7)).astype(np.float32))
    packed = tops.gather_blocks(src, idx)
    back = tops.scatter_blocks(packed, inv, torch.zeros_like(src))
    act = inv >= 0
    np.testing.assert_array_equal(back[act].numpy(), src[act].numpy())
    np.testing.assert_array_equal(back[~act].numpy(), 0.0)


@pytest.mark.parametrize("bad_idx,bad_inv", [(16, 2), (-2, -2)])
def test_dispatch_rejects_out_of_range_indices(bad_idx, bad_inv):
    """Indices outside [−1, rows) never reach a kernel."""
    src = torch.zeros((16, 4))
    with pytest.raises(IndexError):
        tops.gather_blocks(src, np.asarray([0, bad_idx], np.int32))
    with pytest.raises(IndexError):
        tops.scatter_blocks(torch.zeros((2, 4)), np.asarray(
            [bad_inv] + [-1] * 15, np.int32), src)


def test_cpu_dispatch_never_touches_the_kernel():
    """A CPU tensor takes the plain version: nothing is built, nothing is
    launched."""
    before = (flexa_prox.gather_rows.launches,
              flexa_prox.scatter_rows.launches)
    idx, inv = _plan_arrays(8, 3, seed=0)
    out = tops.gather_blocks(torch.ones((8, 2)), idx)
    tops.scatter_blocks(out, inv, torch.ones((8, 2)))
    assert (flexa_prox.gather_rows.launches,
            flexa_prox.scatter_rows.launches) == before
    assert flexa_prox._lib is None


def test_kernel_modules_import_without_nvcc():
    """Importing the kernel modules builds and loads nothing, so the
    package imports where nvcc and the card are missing."""
    code = ("import repro_torch.kernels.ops, repro_torch.solvers.compaction\n"
            "from repro_torch.kernels import flexa_prox\n"
            "assert flexa_prox._lib is None\n")
    env = {**os.environ, "PATH": os.path.dirname(sys.executable)}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [p for p in sys.path if p])
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------------ #
# best_response                                                      #
# ------------------------------------------------------------------ #
#: (shape, dense d, c, x dtype): odd sizes (1, 1000, 37×53), a 2-D and a
#: 3-D tensor, scalar and dense d, c = 0 and > 0, fp32 and bf16 x.
BR_CASES = [
    ((1,), False, 0.0, "float32"),
    ((1000,), False, 0.0, "float32"),
    ((1000,), False, 0.01, "float32"),
    ((37, 53), True, 0.0, "float32"),
    ((37, 53), True, 0.05, "float32"),
    ((3, 64, 160), False, 1e-3, "float32"),
    ((3, 64, 160), True, 1e-3, "bfloat16"),
    ((517,), False, 0.02, "bfloat16"),
]


def _br_inputs(shape, dense, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    g = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    d = (rng.uniform(0.5, 2.0, shape) if dense else np.float32(1.7)
         ).astype(np.float32)
    jx, jg = (jnp.asarray(a).astype(dtype) for a in (x, g))
    tx, tg = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, g))
    return (jx, jg, jnp.asarray(d)), (tx, tg, torch.from_numpy(np.array(d)))


@pytest.mark.parametrize("shape,dense,c,dtype", BR_CASES)
def test_best_response_matches_reference(shape, dense, c, dtype):
    (jx, jg, jd), (tx, tg, td) = _br_inputs(shape, dense, dtype,
                                            seed=sum(shape) + int(dense))
    zi, ei = jops.flexa_best_response(jx, jg, jd, c, force="interpret")
    zr, er = jops.flexa_best_response(jx, jg, jd, c, force="ref")
    np.testing.assert_array_equal(np.asarray(zi), np.asarray(zr))
    for z, e2 in (tref.flexa_best_response_ref(tx, tg, td, c),
                  tops.flexa_best_response(tx, tg, td, c),
                  tops.flexa_best_response(tx, tg, float(td) if not dense
                                           else td, c)):
        assert z.dtype == torch.float32 and z.shape == tx.shape
        assert e2.dtype == torch.float32 and e2.dim() == 0
        np.testing.assert_array_equal(z.numpy(), np.asarray(zi))
        for want in (ei, er):
            np.testing.assert_allclose(float(e2), float(want), rtol=1e-5)


def test_best_response_divides_where_torch_would_multiply():
    """c / d and g / d are true fp32 divisions, as the reference's; torch's
    ``float / tensor`` (a reciprocal times c) differs in the last bit for
    some d, and the plain version must not take that route."""
    d = torch.linspace(0.3, 7.7, 4001)
    t_true = torch.tensor(0.1) / d
    assert not torch.equal(0.1 / d, t_true)          # the trap exists
    x = torch.full((4001,), 0.5)
    g = torch.zeros(4001)
    z, _ = tref.flexa_best_response_ref(x, g, d, 0.1)
    np.testing.assert_array_equal(z.numpy(), (x - t_true).numpy())


def test_best_response_cpu_dispatch_never_touches_the_kernel():
    before = flexa_prox.best_response.launches
    tops.flexa_best_response(torch.ones(10), torch.ones(10), 2.0, 0.1)
    assert flexa_prox.best_response.launches == before
    assert flexa_prox._br_lib is None
    assert flexa_prox.best_response.plain is tref.flexa_best_response_ref


def test_best_response_grid_depends_on_numel_and_sms_only():
    """The kernel's grid (and so e2's summation order) is fixed by numel
    and the SM count: one block for small tensors, capped at 8 per SM."""
    blocks = flexa_prox.best_response_blocks
    assert blocks(1, 132) == 1 and blocks(2048, 132) == 1
    assert blocks(2049, 132) == 2
    assert blocks(2560 * 6912, 132) == 8 * 132
    assert blocks(50304 * 2560, 132) == 8 * 132
