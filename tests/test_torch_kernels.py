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

from repro.baselines import gauss_seidel as jgs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.problems import lasso as jlasso
from repro_torch.kernels import flexa_prox
from repro_torch.kernels import gauss_seidel as tgs
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


# ------------------------------------------------------------------ #
# apply_update, batched_best_response, batched_apply_update          #
# ------------------------------------------------------------------ #
#: (shape, dense d, c, γ·m, x dtype) of apply_update: odd sizes, scalar
#: and dense d, c = 0 and > 0, γ·m = 0, 1 and 0.9, fp32 and bf16 x.
APPLY_CASES = [
    ((1,), False, 0.0, 0.9, "float32"),
    ((1000,), False, 0.01, 1.0, "float32"),
    ((37, 53), True, 0.05, 0.9, "float32"),
    ((37, 53), True, 0.0, 0.0, "float32"),
    ((3, 64, 160), False, 1e-3, 0.9, "bfloat16"),
    ((517,), True, 0.02, 0.9, "bfloat16"),
]

#: (B, instance shape, d kind, c kind, γ·m kind): d scalar, per instance
#: or dense; c and γ·m scalar or per instance; ragged n (no 512 padding).
BATCHED_CASES = [
    (1, (1,), "scalar", "scalar", "scalar"),
    (3, (1000,), "dense", "instance", "instance"),
    (2, (37, 53), "instance", "scalar", "instance"),
    (4, (517,), "dense", "scalar", "scalar"),
    (2, (8, 300), "scalar", "instance", "scalar"),
]

#: ≤ 2 fp32 ulps: the oracle's threshold is c/d, the port's (1/d)·c.
ORACLE_TOL = dict(rtol=1e-6, atol=1e-7)


def _tol(dtype):
    """One bf16 ulp for bf16 results (a last-bit fp32 difference can move
    the rounding to bf16), the oracle tolerance otherwise."""
    return dict(rtol=2.0 ** -7, atol=1e-7) if dtype == "bfloat16" \
        else ORACLE_TOL


@pytest.mark.parametrize("shape,dense,c,gm,dtype", APPLY_CASES)
def test_apply_update_matches_reference(shape, dense, c, gm, dtype):
    (jx, jg, jd), (tx, tg, td) = _br_inputs(shape, dense, dtype,
                                            seed=sum(shape) + 7)
    want = jops.flexa_apply(jx, jg, jd, c, gm, force="interpret")
    oracle = jref.flexa_apply_ref(jx, jg, jd, c, gm, 1.0)
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               np.asarray(oracle, np.float32), **_tol(dtype))
    got = tref.flexa_apply_ref(tx, tg, td, c, torch.tensor(gm))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    for w in (want, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32), **_tol(dtype))
    via_ops = tops.flexa_apply(tx, tg, td, c, gm)
    assert torch.equal(via_ops, got)
    x2 = tx.clone()
    assert tops.flexa_apply(x2, tg, td, c, gm, out=x2) is x2
    assert torch.equal(x2, got)


def _batched_inputs(B, shape, dkind, ckind, gkind, seed):
    rng = np.random.default_rng(seed)
    full = (B,) + shape
    x = rng.standard_normal(full).astype(np.float32)
    g = (0.1 * rng.standard_normal(full)).astype(np.float32)
    d = {"scalar": np.float32(1.7),
         "instance": rng.uniform(0.5, 2.0, B).astype(np.float32),
         "dense": rng.uniform(0.5, 2.0, full).astype(np.float32)}[dkind]
    c = (rng.uniform(0.01, 0.1, B).astype(np.float32) if ckind == "instance"
         else np.float32(0.05))
    gm = (rng.uniform(0.5, 1.0, B).astype(np.float32) if gkind == "instance"
          else np.float32(0.9))
    j = tuple(jnp.asarray(a) for a in (x, g, d, c, gm))
    t = tuple(torch.from_numpy(np.array(a)) for a in (x, g, d, c, gm))
    return j, t


@pytest.mark.parametrize("B,shape,dkind,ckind,gkind", BATCHED_CASES)
def test_batched_kernels_match_reference(B, shape, dkind, ckind, gkind):
    (jx, jg, jd, jc, jgm), (tx, tg, td, tc, tgm) = _batched_inputs(
        B, shape, dkind, ckind, gkind, seed=B + len(shape))
    zi, ei = jops.flexa_best_response_batched(jx, jg, jd, jc,
                                              force="interpret")
    zr, er = jref.flexa_best_response_batched_ref(jx, jg, jd, jc)
    oi = jops.flexa_apply_batched(jx, jg, jd, jc, jgm, force="interpret")
    orr = jref.flexa_apply_batched_ref(jx, jg, jd, jc, jgm)
    for z, e2 in (tref.flexa_best_response_batched_ref(tx, tg, td, tc),
                  tops.flexa_best_response_batched(tx, tg, td, tc)):
        assert z.dtype == torch.float32 and z.shape == tx.shape
        assert e2.shape == (B,) and e2.dtype == torch.float32
        for zw, ew in ((zi, ei), (zr, er)):
            np.testing.assert_allclose(z.numpy(), np.asarray(zw),
                                       **ORACLE_TOL)
            np.testing.assert_allclose(e2.numpy(), np.asarray(ew),
                                       rtol=1e-5)
    for o in (tref.flexa_apply_batched_ref(tx, tg, td, tc, tgm),
              tops.flexa_apply_batched(tx, tg, td, tc, tgm)):
        assert o.dtype == tx.dtype and o.shape == tx.shape
        for w in (oi, orr):
            np.testing.assert_allclose(o.numpy(), np.asarray(w),
                                       **ORACLE_TOL)


def test_batched_response_rounds_as_the_solver_not_the_oracle():
    """The batched plain versions take the threshold as the solver's chain
    does, (1/d)·c (a reciprocal, then a product); the single-tensor ones
    and the reference's oracle take c/d.  The two differ in the last bit
    for some d, and the batched version must take the chain's route."""
    d = torch.linspace(0.3, 7.7, 4001)
    c = 0.1
    t_chain, t_oracle = (1.0 / d) * c, torch.tensor(c) / d
    assert not torch.equal(t_chain, t_oracle)        # the two differ
    x = torch.full((1, 4001), 0.5)
    g = torch.zeros((1, 4001))
    z, _ = tref.flexa_best_response_batched_ref(x, g, d[None], c)
    np.testing.assert_array_equal(z[0].numpy(), (0.5 - t_chain).numpy())
    z1, _ = tref.flexa_best_response_ref(x[0], g[0], d, c)
    np.testing.assert_array_equal(z1.numpy(), (0.5 - t_oracle).numpy())
    zj, _ = jref.flexa_best_response_batched_ref(
        jnp.asarray(x.numpy()), jnp.asarray(g.numpy()),
        jnp.asarray(d[None].numpy()), jnp.float32(c))
    np.testing.assert_array_equal(np.asarray(zj)[0], z1.numpy())
    np.testing.assert_allclose(z[0].numpy(), z1.numpy(), **ORACLE_TOL)


def test_new_kernels_cpu_dispatch_never_touches_them():
    before = (flexa_prox.apply_update.launches,
              flexa_prox.batched_best_response.launches,
              flexa_prox.batched_apply_update.launches)
    x = torch.ones((2, 10))
    tops.flexa_apply(x[0], x[0], 2.0, 0.1, 0.9)
    tops.flexa_best_response_batched(x, x, 2.0, 0.1)
    tops.flexa_apply_batched(x, x, 2.0, 0.1, 0.9)
    assert (flexa_prox.apply_update.launches,
            flexa_prox.batched_best_response.launches,
            flexa_prox.batched_apply_update.launches) == before
    assert flexa_prox._br_lib is None
    assert flexa_prox.apply_update.plain is tref.flexa_apply_ref
    assert flexa_prox.batched_best_response.plain \
        is tref.flexa_best_response_batched_ref
    assert flexa_prox.batched_apply_update.plain \
        is tref.flexa_apply_batched_ref


@pytest.mark.parametrize("sms,cap", [(132, 16), (132, 8), (78, 16)])
def test_batched_grid_is_one_cluster_per_instance_up_to_the_switch(sms,
                                                                   cap):
    """The batched best response's grid: one cluster of C ≤ cap CTAs per
    instance, C = 1 where one CTA's share covers n, each CTA a share of
    at most BATCHED_CTA_ELEMS elements (a multiple of 8) with none empty;
    a function of (n, B, SM count, cap) only, B and the SM count mattering
    only past the switch to the two-level form at cap × BATCHED_CTA_ELEMS
    elements."""
    grid = flexa_prox.batched_blocks
    share, split = flexa_prox.BATCHED_CTA_ELEMS, flexa_prox.BATCHED_SPLIT
    switch = cap * share
    for n in (1, 7, 1000, split):
        assert grid(n, 8, sms, cap) == (1, -(-n // 8) * 8, True)
    assert grid(split + 1, 1, sms, cap).ctas == 2
    assert grid(cap * split, 1, sms, cap).ctas == cap
    assert grid(cap * split + 1, 1, sms, cap).ctas == cap
    for n in (split + 1, 3 * split + 5, cap * split, cap * split + 1,
              100_000, switch - 1, switch):
        if n > switch:
            continue
        C, per, one = grid(n, 8, sms, cap)
        assert one and 1 < C <= cap <= 16
        assert per % 8 == 0 and per <= share
        assert (C - 1) * per < n <= C * per
        assert grid(n, 1, 1, cap) == grid(n, 2000, sms, cap) == (C, per,
                                                                 one)
    assert grid(switch, 3, sms, cap).one_launch
    two = grid(switch + 1, 3, sms, cap)
    assert not two.one_launch
    assert two.ctas == flexa_prox.update_blocks(switch + 1, 3, sms)
    assert flexa_prox.batched_blocks(100_000, 8, 132) == (16, 6256, True)
    assert flexa_prox.batched_blocks(100_000, 1, 132, 8).one_launch is False


def test_update_grid_depends_on_n_b_and_sms_only():
    blocks = flexa_prox.update_blocks
    assert blocks(1, 1, 132) == 1 and blocks(2048, 8, 132) == 1
    assert blocks(100_000, 8, 132) == 49
    assert blocks(100_000, 1, 132) == 49
    assert blocks(10**8, 8, 132) == 8 * 132 // 8
    assert blocks(10**8, 2000, 132) == 1


# ------------------------------------------------------------------ #
# compact_best_response, gauss_seidel_sweep                          #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("C", [64, 200])
@pytest.mark.parametrize("scalar_d", [True, False])
def test_compact_best_response_matches_reference(C, scalar_d):
    """The plain version and the CPU dispatch against the reference's
    oracle and its Pallas kernel in interpret mode (the reference's own
    sweep, ``tests/test_kernels.py:253``): z exactly (the same fp32
    operations, c/d and g/d true divisions), pad rows 0; e2 within 1e-5
    relative (summed in another order)."""
    n_rows, k = 16, 6
    idx, _ = _plan_arrays(n_rows, k, seed=C)
    rng = np.random.default_rng(C + int(scalar_d))
    x = rng.standard_normal((n_rows, C)).astype(np.float32)
    g = rng.standard_normal((n_rows, C)).astype(np.float32)
    d = np.float32(2.0) if scalar_d else \
        rng.uniform(0.5, 3, (n_rows, C)).astype(np.float32)
    jargs = (jnp.asarray(x), jnp.asarray(g), jnp.asarray(d))
    zr, er = jref.compact_best_response_ref(*jargs, 0.3, jnp.asarray(idx))
    zi, ei = jops.compact_best_response(*jargs, 0.3, jnp.asarray(idx),
                                        force="interpret")
    targs = (torch.from_numpy(x), torch.from_numpy(g),
             torch.from_numpy(np.array(d)))
    for z, e2 in (tref.compact_best_response_ref(
                      *targs, 0.3, torch.from_numpy(idx)),
                  tops.compact_best_response(*targs, 0.3, idx)):
        assert z.dtype == torch.float32 and z.shape == (idx.size, C)
        assert e2.dtype == torch.float32 and e2.dim() == 0
        np.testing.assert_array_equal(z.numpy(), np.asarray(zr))
        np.testing.assert_array_equal(z.numpy(), np.asarray(zi))
        np.testing.assert_array_equal(z.numpy()[idx < 0], 0.0)
        for want in (er, ei):
            np.testing.assert_allclose(float(e2), float(want), rtol=1e-5)


def test_compact_best_response_is_gather_then_best_response():
    """On bf16 rows and the (n, 1) layout too: the port's composition
    ``gather_blocks`` → ``flexa_best_response`` (pad rows given d = 1)
    equals it bit for bit, e2 included (the same sum)."""
    idx, _ = _plan_arrays(40, 23, seed=1)
    rng = np.random.default_rng(1)
    for C, dtype in ((1, torch.float32), (37, torch.bfloat16)):
        x = torch.from_numpy(rng.standard_normal((40, C)).astype(
            np.float32)).to(dtype)
        g = torch.from_numpy(rng.standard_normal((40, C)).astype(
            np.float32)).to(dtype)
        d = torch.from_numpy(rng.uniform(0.5, 3, (40, C)).astype(
            np.float32))
        dc = tops.gather_blocks(d, idx)
        dc[torch.from_numpy(idx) < 0] = 1.0
        want = tops.flexa_best_response(tops.gather_blocks(x, idx),
                                        tops.gather_blocks(g, idx), dc, 0.2)
        got = tops.compact_best_response(x, g, d, 0.2, idx)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_compact_best_response_dispatch_rejects_out_of_range_idx():
    x = torch.ones((8, 4))
    for bad in (8, -2):
        with pytest.raises(IndexError):
            tops.compact_best_response(x, x, 1.0, 0.1, [0, bad])


@pytest.mark.parametrize("sms,cap", [(132, 16), (132, 8), (78, 16)])
def test_compact_best_response_grid_depends_on_k_c_and_sms_only(sms, cap):
    """compact_best_response's grid: one cluster of ≤ cap CTAs up to
    cap × COMPACT_CTA_ELEMS gathered elements K·C, ⌈K·C / COMPACT_SPLIT⌉
    CTAs, each a share of at most COMPACT_CTA_ELEMS elements (a multiple
    of 8) with none empty (the path's K = 16384 bucket at C = 1: 16 CTAs
    of 1024), the SM count mattering only past the switch; there the grid
    form, wide rows one per block-step and narrow rows 256 per block,
    capped at 8 blocks per SM."""
    grid = flexa_prox.compact_blocks
    share, split = flexa_prox.COMPACT_CTA_ELEMS, flexa_prox.COMPACT_SPLIT
    switch = cap * share
    assert grid(1, 1, sms, cap) == (1, 8, True)
    assert grid(split, 1, sms, cap) == (1, split, True)
    assert grid(split + 1, 1, sms, cap).ctas == 2
    assert grid(1, 5000, sms, cap) == (cap, -(-5000 // (8 * cap)) * 8, True)
    assert grid(16384, 1, sms, cap) == (cap, 16384 // cap, True)
    assert grid(16384, 1, sms, cap) == grid(16384, 1, 1, cap)
    for K, C in ((switch, 1), (switch // 64, 64), (split, 1), (500, 64),
                 (3, 37), (switch // 5000, 5000)):
        ctas, per, one = grid(K, C, sms, cap)
        assert one and 1 <= ctas <= cap and per % 8 == 0 and per <= share
        assert (ctas - 1) * per < K * C <= ctas * per
        assert ctas == min(cap, -(-K * C // split))
    assert grid(switch, 1, sms, cap) == (cap, share, True)
    past = grid(switch + 1, 1, sms, cap)
    assert not past.one_launch
    assert past.ctas == min(-(-(switch + 1) // 256), 8 * sms)
    wide = grid(switch // 64 + 1, 64, sms, cap)
    assert not wide.one_launch
    assert wide.ctas == min(switch // 64 + 1, 8 * sms)
    assert grid(65536, 5000, sms, cap).ctas == 8 * sms
    assert grid(10**7, 1, sms, cap).ctas == 8 * sms


#: Constants of flexa_prox.py that size the compact best response's grid
#: beside the C names they must equal in csrc/compact_rows.cu.
COMPACT_SOURCE_CONSTANTS = [("COMPACT_CTA_ELEMS", "kCbrCtaElems"),
                            ("BATCHED_MAX_CLUSTER", "kCbrMaxCluster"),
                            ("NARROW_COLS", "kNarrowCols"),
                            ("NARROW_ROWS_PER_BLOCK", "kCbrNarrowThreads")]


@pytest.mark.parametrize("name,c_name", COMPACT_SOURCE_CONSTANTS, ids=str)
def test_compact_grid_constants_match_the_source(name, c_name):
    """The wrapper sizes compact_best_response's grid from copies of the
    kernel's constants, which must equal the source's."""
    import re
    from pathlib import Path

    src = (Path(flexa_prox.__file__).parent / "csrc" /
           "compact_rows.cu").read_text()
    m = re.search(rf"constexpr (?:int|long long) {c_name} = (\d+);", src)
    assert m is not None, c_name
    assert getattr(flexa_prox, name) == int(m.group(1))


def test_compact_best_response_plain_version_at_the_path_state():
    """At the fig1d path's last-point shape, a K = 16384 bucket with 9286
    valid rows of (100000, 1) vectors and dense d: the plain version and
    the CPU dispatch equal the reference's oracle, z exactly, pad rows 0,
    e2 within 1e-5 relative."""
    n_rows, k, cap = 100_000, 9286, 16384
    idx, _ = _plan_arrays(n_rows, k, seed=23, cap=cap)
    rng = np.random.default_rng(23)
    x = rng.standard_normal((n_rows, 1)).astype(np.float32)
    g = (0.5 * rng.standard_normal((n_rows, 1))).astype(np.float32)
    d = rng.uniform(0.5, 3, (n_rows, 1)).astype(np.float32)
    zr, er = jref.compact_best_response_ref(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(d), 0.3,
        jnp.asarray(idx))
    targs = (torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(d))
    for z, e2 in (tref.compact_best_response_ref(
                      *targs, 0.3, torch.from_numpy(idx)),
                  tops.compact_best_response(*targs, 0.3, idx)):
        assert z.shape == (cap, 1) and z.dtype == torch.float32
        np.testing.assert_array_equal(z.numpy(), np.asarray(zr))
        np.testing.assert_array_equal(z.numpy()[idx < 0], 0.0)
        np.testing.assert_allclose(float(e2), float(er), rtol=1e-5)


@pytest.mark.parametrize("n_rows", [100_000, 100_003])
def test_scatter_plain_version_at_the_path_shape(n_rows):
    """65536 values scattered into (N, 1) fp32 vectors, N the path's
    100000 and one that is not a multiple of 4: the plain version and the
    CPU dispatch equal the reference's oracle exactly."""
    idx, inv = _plan_arrays(n_rows, 65536, seed=n_rows, cap=65536)
    vals_j, vals_t = _src(idx.size, 1, "float32", seed=5)
    base_j, base_t = _src(n_rows, 1, "float32", seed=6)
    want = np.asarray(jref.scatter_rows_ref(vals_j, jnp.asarray(inv),
                                            base_j))
    plain = tref.scatter_rows_ref(vals_t, torch.from_numpy(inv), base_t)
    via_ops = tops.scatter_blocks(vals_t, inv, base_t)
    for got in (plain, via_ops):
        assert got.dtype == torch.float32 and got.shape == (n_rows, 1)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(via_ops.numpy()[inv < 0],
                                  base_t.numpy()[inv < 0])


def _gs_state(m, n, seed):
    """The reference's instance and the port's sweep inputs from it: At,
    colsq, x = 0 and r = −b."""
    p = jlasso.nesterov_instance(m=m, n=n, nnz_frac=0.1, c=1.0, seed=seed)
    A = torch.from_numpy(np.array(p.data["A"]))
    b = torch.from_numpy(np.array(p.data["b"]))
    colsq = torch.clamp_min((A * A).sum(0), 1e-12)
    return p, A.T.contiguous(), colsq, torch.zeros(n), -b


def test_gauss_seidel_sweep_matches_reference_sweep():
    """One and two plain sweeps from x = 0 against the reference's swept
    x and its history's V and max |δ| (``repro.baselines.gauss_seidel``):
    within 1e-5 (the dot products sum in another order)."""
    p, At, colsq, x, r = _gs_state(30, 96, seed=2)
    for sweeps in (1, 2):
        rj = jgs.solve(p, max_iters=sweeps, tol=0.0)
        xs, rs = x.clone(), r.clone()
        for k in range(sweeps):
            stat = tops.gauss_seidel_sweep(At, colsq, xs, rs, 1.0)
            v = float(rs @ rs + xs.abs().sum())
            np.testing.assert_allclose(v, rj.history["V"][k], rtol=1e-5)
            np.testing.assert_allclose(float(stat), rj.history["stat"][k],
                                       rtol=1e-5)
        np.testing.assert_allclose(xs.numpy(), np.asarray(rj.x), atol=1e-5)
        # r is kept as A·x − b
        np.testing.assert_allclose(rs.numpy(), (At.T @ xs + r).numpy(),
                                   atol=1e-5)


def test_gauss_seidel_cpu_dispatch_never_touches_the_kernel():
    _, At, colsq, x, r = _gs_state(8, 20, seed=0)
    before = tgs.gauss_seidel_sweep.launches
    stat = tops.gauss_seidel_sweep(At, colsq, x, r, 1.0)
    assert tgs.gauss_seidel_sweep.launches == before
    assert tgs._lib is None and float(stat) > 0
    assert tgs.gauss_seidel_sweep.plain is tref.gauss_seidel_sweep_ref
    before = flexa_prox.compact_best_response.launches
    tops.compact_best_response(torch.ones((4, 3)), torch.ones((4, 3)), 2.0,
                               0.1, [2, -1])
    assert flexa_prox.compact_best_response.launches == before
    assert flexa_prox._lib is None


# ------------------------------------------------------------------ #
# The arithmetic of the Hopper designs (csrc/flash_attention.cu's     #
# bf16 body, csrc/gauss_seidel.cu), modelled in torch on the CPU      #
# ------------------------------------------------------------------ #
from hypothesis import given, settings, strategies as st  # noqa: E402

#: p at and above this split exactly into three bf16 terms; below it the
#: third term can underflow bf16's subnormals (step 2^-133).
SPLIT_EXACT_FROM = 2.0 ** -110


def _split3(p: torch.Tensor):
    """The bf16 body's split of fp32 p (``split3``): p1 = bf16(p),
    p2 = bf16(p − p1), p3 = bf16(p − p1 − p2), each remainder an fp32
    subtraction."""
    bf = torch.bfloat16
    p1 = p.to(bf)
    r1 = p - p1.float()
    p2 = r1.to(bf)
    return p1, p2, (r1 - p2.float()).to(bf)


def _assert_split_exact(p):
    """p1 + p2 + p3, summed in fp32, equals p bit for bit where p ≥
    2^-110, and is within 2^-133 of it below."""
    p = torch.as_tensor(p, dtype=torch.float32).reshape(-1)
    p1, p2, p3 = _split3(p)
    total = (p1.float() + p2.float()) + p3.float()
    big = p >= SPLIT_EXACT_FROM
    assert torch.equal(total[big].view(torch.int32),
                       p[big].view(torch.int32))
    assert bool(((total - p).abs()[~big] <= 2.0 ** -133).all())


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(0.0, 1.0, width=32), min_size=1, max_size=256))
def test_bf16_split_of_p_in_unit_interval_is_exact(ps):
    _assert_split_exact(ps)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(float(np.float32(0.99)), 1.0, width=32), min_size=1, max_size=256))
def test_bf16_split_of_p_near_one_is_exact(ps):
    _assert_split_exact(ps)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(0.0, 80.0, width=32), min_size=1, max_size=256))
def test_bf16_split_of_softmax_exponentials_is_exact(xs):
    """p = exp(−x), x up to 80, as the online softmax forms it (fp32)."""
    _assert_split_exact(torch.exp(-torch.tensor(xs, dtype=torch.float32)))


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(-149, 0), min_size=1, max_size=64))
def test_bf16_split_of_powers_of_two_is_exact(ks):
    _assert_split_exact(torch.ldexp(torch.ones(len(ks)),
                                    torch.tensor(ks, dtype=torch.int32)))


def test_bf16_split_covers_a_dense_grid_of_exponentials():
    """Every exp(−x) on a grid of 200001 points in [0, 80], and 2^20
    consecutive fp32 values just below 1 (every significand pattern of
    the top 20 bits' neighbourhood)."""
    x = torch.linspace(0.0, 80.0, 200001, dtype=torch.float32)
    _assert_split_exact(torch.exp(-x))
    below_one = torch.arange(0x3F800000 - (1 << 20), 0x3F800000,
                             dtype=torch.int32).view(torch.float32)
    _assert_split_exact(below_one)


def _blocked_sweep(At, colsq, x, r, c, B):
    """float64 model of ``csrc/gauss_seidel.cu``'s sweep: per block of B
    coordinates, q = A_Jᵀ r and G = A_Jᵀ A_J against r as the previous
    block left it; walking j in order, g_j = 2 (q_j + Σ_{k<j} G_jk δ_k)
    and z_j, δ_j as the per-coordinate sweep forms them; then r += a_j δ_j
    for j in order, skipped where δ_j = 0.  x and r in place → max |δ|."""
    n = At.shape[0]
    max_delta = torch.zeros((), dtype=At.dtype)
    for j0 in range(0, n, B):
        blk = At[j0:j0 + B]
        cc = blk @ r
        G = blk @ blk.T
        deltas = []
        for j in range(blk.shape[0]):
            xi, d = x[j0 + j].clone(), 2.0 * colsq[j0 + j]
            w = xi - (2.0 * cc[j]) / d
            z = torch.sign(w) * torch.clamp_min(torch.abs(w) - c / d, 0.0)
            delta = z - xi
            x[j0 + j] = z
            if delta != 0:
                cc[j + 1:] += G[j + 1:, j] * delta
            max_delta = torch.maximum(max_delta, torch.abs(delta))
            deltas.append(delta)
        for j, delta in enumerate(deltas):
            if delta != 0:
                r.add_(blk[j] * delta)
    return max_delta


@pytest.mark.parametrize("B", [1, 7, 32])
@pytest.mark.parametrize("m,n", [(40, 100), (30, 20)], ids=str)
def test_blocked_gram_sweep_matches_the_per_coordinate_sweep(B, m, n):
    """The blocked, Gram-corrected sweep is the per-coordinate sweep
    (``ref.gauss_seidel_sweep_ref``) in float64, to 1e-12: block sizes 1,
    7 and 32 over n not a multiple of B (and n < B), from a nonzero x,
    four sweeps."""
    rng = np.random.default_rng(m * n + B)
    A = torch.from_numpy(rng.standard_normal((m, n)))
    b = torch.from_numpy(rng.standard_normal(m))
    At = A.T.contiguous()
    colsq = torch.clamp_min((A * A).sum(0), 1e-12)
    x0 = torch.from_numpy(rng.standard_normal(n) * (rng.random(n) < 0.3))
    c = 0.5
    xs, rs = [x0.clone(), x0.clone()], [A @ x0 - b, A @ x0 - b]
    for _ in range(4):
        want = tref.gauss_seidel_sweep_ref(At, colsq, xs[0], rs[0], c)
        got = _blocked_sweep(At, colsq, xs[1], rs[1], c, B)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(xs[1].numpy(), xs[0].numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(rs[1].numpy(), rs[0].numpy(),
                                   rtol=1e-12, atol=1e-12)
    assert float(got) > 0 and bool((xs[1] != 0).any())


# ------------------------------------------------------------------ #
# The arithmetic of csrc/ssd_scan.cu's bf16 body (chunk states, the  #
# state pass over chunks, chunk outputs), modelled in torch on the CPU #
# ------------------------------------------------------------------ #
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan  # noqa: E402


def _assert_signed_split_exact(p):
    """p1 + p2 + p3, summed in fp32, equals p bit for bit where |p| ≥
    2^-110, and is within 2^-133 of it below, for either sign."""
    p = torch.as_tensor(p, dtype=torch.float32).reshape(-1)
    p1, p2, p3 = _split3(p)
    total = (p1.float() + p2.float()) + p3.float()
    big = p.abs() >= SPLIT_EXACT_FROM
    assert torch.equal(total[big].view(torch.int32),
                       p[big].view(torch.int32))
    assert bool(((total - p).abs()[~big] <= 2.0 ** -133).all())


def _split_matmul(eq, fp32_factor, bf16_factor):
    """einsum of an fp32 factor and a bf16-valued one as the kernel does
    it: the fp32 factor split into three bf16 terms, each product exact in
    fp32, the three summed in fp32."""
    return sum(torch.einsum(eq, t.float(), bf16_factor)
               for t in _split3(fp32_factor))


def _ssd_split_model(x, dt, A, B, C, chunk):
    """fp32 model of the bf16 body → (y fp32, h).  x, B, C bf16-valued;
    S may be ragged (the missing rows count as dt = 0).

    (a) per chunk: s = cumsum(dt·A); Hc = Σ_q (w·B)_qᵀ X with w =
    exp(s_L − s)·dt, w·B rounded once in fp32 and split into three bf16
    terms; (b) h_c = exp(s_L,c)·h_{c−1} + Hc_c over the chunks in order,
    keeping the state entering each; (c) G = C·Bᵀ (bf16 products, fp32
    sums), W = G·exp(s_t − s_u)·dt_u with the exponent formed only for
    u ≤ t, y = Σ_q W_q·X + exp(s)·Σ_q C·h_q with W and h_prev split."""
    f32 = torch.float32
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunks(t):
        t = torch.nn.functional.pad(t.to(f32),
                                    [0, 0] * (t.dim() - 2) + [0, pad])
        return t.reshape(Bt, nc, chunk, *t.shape[2:])
    xf, dtf, Bf, Cf = chunks(x), chunks(dt), chunks(B), chunks(C)
    s = torch.cumsum(dtf * A.to(f32), dim=2)            # (Bt, nc, L, H)
    s_last = s[:, :, -1]                                # (Bt, nc, H)
    # (a)
    w = torch.exp(s_last[:, :, None] - s) * dtf
    wB = w[..., None] * Bf[:, :, :, None, :]            # (Bt, nc, L, H, N)
    Hc = _split_matmul("bcuhn,bcuhp->bchnp", wB, xf)
    # (b)
    h = torch.zeros((Bt, H, N, P), dtype=f32)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = torch.exp(s_last[:, c])[:, :, None, None] * h + Hc[:, c]
    h_prev = torch.stack(h_prev, dim=1)                 # (Bt, nc, H, N, P)
    # (c)
    G = torch.einsum("bctn,bcun->bctu", Cf, Bf)
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()[:, :, None]
    diff = (s[:, :, :, None, :] - s[:, :, None, :, :]).masked_fill(~tri, 0.0)
    W = torch.where(tri, G[..., None] * torch.exp(diff)
                    * dtf[:, :, None, :, :], torch.zeros(()))
    y_inter = sum(torch.einsum("bctn,bchnp->bcthp", Cf, q.float())
                  for q in _split3(h_prev))
    y = y_inter * torch.exp(s)[..., None] + _split_matmul(
        "bctuh,bcuhp->bcthp", W, xf)
    return y.reshape(Bt, nc * chunk, H, P)[:, :S], h


def _ssd_bf16_inputs(Bt, S, H, P, N, seed, A_max=16.0):
    """x, B, C with bf16 values (as fp32 numpy), dt in (0.001, 0.301), A
    = −linspace(1, A_max, H): the mixer's ranges."""
    rng = np.random.default_rng(seed)

    def bf(shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    x, B, C = bf((Bt, S, H, P)), bf((Bt, S, N)), bf((Bt, S, N))
    dt = (rng.random((Bt, S, H)) * 0.3 + 1e-3).astype(np.float32)
    A = -np.linspace(1.0, A_max, H).astype(np.float32)
    return x, dt, A, B, C


#: The model against the JAX package: y within 5e-5 × max |y|, h within
#: 5e-5 × max |h|.  The split is exact, but jnp.cumsum sums dt·A in
#: another order than torch.cumsum, and over a chunk of 256 with A = −16
#: that moves exp(s_t − s_u) by up to ≈ 1.5e-5 relative (the port's plain
#: version reads 1.46e-5 against the same reference).  Against the port's
#: plain version (the same cumsum): 1e-6 (readings ≈ 9e-8).
JAX_RTOL, PLAIN_RTOL = 5e-5, 1e-6


def _assert_model_close(got, want, rtol):
    (y, h), (y0, h0) = got, want
    y, h = np.asarray(y, np.float32), np.asarray(h, np.float32)
    y0, h0 = np.asarray(y0, np.float32), np.asarray(h0, np.float32)
    assert np.isfinite(y).all() and np.isfinite(h).all()
    assert np.abs(y - y0).max() <= rtol * np.abs(y0).max()
    assert np.abs(h - h0).max() <= rtol * np.abs(h0).max()


def _model(arrs, chunk):
    x, dt, A, B, C = arrs
    return _ssd_split_model(torch.from_numpy(x).to(torch.bfloat16),
                            torch.from_numpy(dt), torch.from_numpy(A),
                            torch.from_numpy(B).to(torch.bfloat16),
                            torch.from_numpy(C).to(torch.bfloat16), chunk)


def test_ssd_split_model_matches_the_pallas_kernel_at_chunk_256():
    """Chunk 256 with A down to −16, where the reference's oracle is NaN:
    the model against ``repro.kernels.ssd_scan.ssd_scan`` in interpret
    mode (which masks before the product), two chunks."""
    arrs = _ssd_bf16_inputs(1, 512, 2, 16, 32, seed=256)
    want = pallas_ssd_scan(*map(jnp.asarray, arrs), chunk=256,
                           interpret=True)
    _assert_model_close(_model(arrs, 256), want, JAX_RTOL)


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_split_model_matches_the_reference_oracle(chunk):
    """Chunks 16 and 64 (A down to −4, where the oracle's decay mask does
    not overflow): the model against ``repro.kernels.ref.ssd_scan_ref``."""
    arrs = _ssd_bf16_inputs(2, 4 * chunk, 3, 8, 16, seed=chunk, A_max=4.0)
    want = jref.ssd_scan_ref(*map(jnp.asarray, arrs), chunk=chunk)
    _assert_model_close(_model(arrs, chunk), want, JAX_RTOL)


@pytest.mark.parametrize("S,chunk", [(100, 16), (300, 64), (37, 8),
                                     (600, 256)],
                         ids=str)
def test_ssd_split_model_matches_the_ports_plain_version_on_ragged_s(S,
                                                                   chunk):
    """Ragged S (the model counts the missing rows as dt = 0), chunk 256
    among them: against the port's ``ref.ssd_scan_ragged``."""
    arrs = _ssd_bf16_inputs(2, S, 3, 8, 16, seed=S)
    want = tref.ssd_scan_ragged(*map(torch.from_numpy, arrs), chunk=chunk)
    _assert_model_close(_model(arrs, chunk), want, PLAIN_RTOL)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(-4096.0, 4096.0, width=32), min_size=1,
                max_size=256))
def test_bf16_split_of_signed_w_is_exact(ws):
    """W = G·exp(s_t − s_u)·dt_u: signed, |G| up to N·max|C|·max|B|."""
    _assert_signed_split_exact(ws)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(-1024.0, 1024.0, width=32), min_size=1,
                max_size=256))
def test_bf16_split_of_signed_state_is_exact(hs):
    """h_prev: the fp32 state entering a chunk, signed."""
    _assert_signed_split_exact(hs)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.floats(0.0, 80.0, width=32),
                          st.floats(float(np.float32(0.001)), float(np.float32(0.301)), width=32),
                          st.floats(-8.0, 8.0, width=32)),
                min_size=1, max_size=256))
def test_bf16_split_of_weighted_b_is_exact(terms):
    """exp(s_L − s_u)·dt_u·B_u as the kernel forms it in fp32 (exponent
    −d ≤ 0, dt in the mixer's range, B a bf16 value of either sign)."""
    d, dt, b = (torch.tensor(v, dtype=torch.float32) for v in zip(*terms))
    b = b.to(torch.bfloat16).float()
    _assert_signed_split_exact(torch.exp(-d) * dt * b)


def test_bf16_split_covers_a_dense_grid_of_signed_values():
    """±exp(−x) on a grid of 200001 points in [0, 80] scaled by 3000, and
    the 2^20 consecutive fp32 values just above −1."""
    x = torch.linspace(0.0, 80.0, 200001, dtype=torch.float32)
    e = torch.exp(-x) * 3000.0
    _assert_signed_split_exact(torch.cat([e, -e]))
    below_one = torch.arange(0x3F800000 - (1 << 20), 0x3F800000,
                             dtype=torch.int32).view(torch.float32)
    _assert_signed_split_exact(-below_one)
