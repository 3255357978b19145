"""The port's SSD scan and Mamba2 mixer against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; the
reference's Pallas kernel runs as ``tests/test_kernels.py`` runs it, in
interpret mode (``force="interpret"``), beside its jnp oracle
(``force="ref"``).  Tolerances and why:

* ``ssd_scan`` plain version vs the reference: atol 2e-4, the bound
  ``tests/test_kernels.py:167`` holds the Pallas kernel to against the
  oracle (fp32 sums in another order);
* the chunked scan vs the step-by-step ``ssd_decode_ref`` recurrence:
  atol 2e-5, as ``tests/test_kernels.py:190``;
* the overflow case (chunk 256, A = −16, dt = 0.1): the port masks
  before ``exp`` as the TPU kernel does, so it is finite and within 2e-4
  of ``force="interpret"``; the reference's oracle is NaN there, which a
  companion assertion pins;
* one mixer (``ssm_layer``, ``_ssm_prefill_layer``, ``ssm_decode``) on
  the reduced mamba2-1.3b config with the same weights: fp32 atol 1e-4;
  bf16 atol 0.02 × max |out| — bf16 rounds in other places in the two
  frameworks (silu, the gate product): a few ulps (2⁻⁸ relative each) at
  the top of the range.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_reduced as jget_reduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro_torch.configs.registry import get_reduced
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T

SWEEP = [
    (1, 32, 2, 8, 8, 8),
    (2, 64, 3, 16, 8, 16),
    (1, 48, 1, 8, 16, 16),
    (2, 50, 3, 16, 8, 16),          # ragged: S not a chunk multiple
    (1, 37, 2, 4, 6, 8),            # ragged, odd widths
]


def _scan_inputs(Bt, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bt, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.3, (Bt, S, H)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, (H,))).astype(np.float32),
            rng.standard_normal((Bt, S, N)).astype(np.float32),
            rng.standard_normal((Bt, S, N)).astype(np.float32))


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", SWEEP)
def test_ssd_scan_plain_matches_reference(Bt, S, H, P, N, chunk):
    arrs = _scan_inputs(Bt, S, H, P, N, seed=S + H)
    y_t, h_t = tops.ssd_scan(*_torch(arrs), chunk=chunk)
    assert y_t.shape == (Bt, S, H, P) and h_t.shape == (Bt, H, N, P)
    for force in ("ref", "interpret"):
        y_j, h_j = jops.ssd_scan(*map(jnp.asarray, arrs), chunk=chunk,
                                 force=force)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-4)
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=2e-4)


def test_ssd_scan_masks_before_exp_at_chunk_256():
    """A = −16, dt = 0.1, chunk 256: Σ dt·|A| over a chunk passes 88.7, so
    exp(s_t − s_u) for u > t overflows.  The port (as the TPU kernel)
    never forms it; the reference's oracle multiplies inf by 0."""
    Bt, S, H, P, N, chunk = 1, 512, 2, 8, 16, 256
    x, _, _, B, C = _scan_inputs(Bt, S, H, P, N, seed=7)
    dt = np.full((Bt, S, H), 0.1, np.float32)
    A = np.asarray([-1.0, -16.0], np.float32)
    arrs = (x, dt, A, B, C)
    y_t, h_t = tops.ssd_scan(*_torch(arrs), chunk=chunk)
    assert torch.isfinite(y_t).all() and torch.isfinite(h_t).all()
    y_i, h_i = jops.ssd_scan(*map(jnp.asarray, arrs), chunk=chunk,
                             force="interpret")
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_i), atol=2e-4)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_i), atol=2e-4)
    y_r, _ = jops.ssd_scan(*map(jnp.asarray, arrs), chunk=chunk, force="ref")
    y_r = np.asarray(y_r)
    assert np.isnan(y_r[:, :, 1]).any()          # the A = −16 head
    np.testing.assert_allclose(y_t.numpy()[:, :, 0], y_r[:, :, 0],
                               atol=2e-4)        # A = −1: no overflow


def test_ssd_scan_matches_sequential_recurrence():
    """Chunked == step-by-step recurrence (the semantic ground truth),
    and the port's single-token step == the reference's."""
    Bt, S, H, P, N = 1, 24, 2, 4, 6
    x, dt, A, B, C = _scan_inputs(Bt, S, H, P, N, seed=3)
    h = jnp.zeros((Bt, H, N, P))
    h_t = torch.zeros((Bt, H, N, P))
    ys = []
    for t in range(S):
        y, h = jref.ssd_decode_ref(x[:, t], dt[:, t], A, B[:, t], C[:, t], h)
        y_p, h_t = tref.ssd_decode_ref(*_torch(
            (x[:, t], dt[:, t], A, B[:, t], C[:, t])), h_t)
        np.testing.assert_allclose(y_p.numpy(), np.asarray(y), atol=2e-5)
        ys.append(np.asarray(y))
    y_c, h_c = tops.ssd_scan(*_torch((x, dt, A, B, C)), chunk=8)
    np.testing.assert_allclose(y_c.numpy(), np.stack(ys, 1), atol=2e-5)
    np.testing.assert_allclose(h_c.numpy(), np.asarray(h), atol=2e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h), atol=2e-5)


def test_ssd_scan_takes_strided_views():
    """x, B and C as last-axis slices of one xBC buffer, as the mixer
    passes them: the same answer as contiguous copies."""
    Bt, S, H, P, N, chunk = 2, 40, 3, 8, 8, 16
    rng = np.random.default_rng(5)
    xBC = torch.from_numpy(rng.standard_normal(
        (Bt, S, H * P + 2 * N)).astype(np.float32))
    x = xBC[..., :H * P].reshape(Bt, S, H, P)
    B, C = xBC[..., H * P: H * P + N], xBC[..., H * P + N:]
    assert not (x.is_contiguous() or B.is_contiguous())
    dt = torch.from_numpy(rng.uniform(0.01, 0.3, (Bt, S, H)).astype(
        np.float32))
    A = -torch.linspace(1.0, 4.0, H)
    y_s, h_s = tops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    y_c, h_c = tops.ssd_scan(x.contiguous(), dt, A, B.contiguous(),
                             C.contiguous(), chunk=chunk)
    assert torch.equal(y_s, y_c) and torch.equal(h_s, h_c)


def test_cpu_ssd_scan_never_touches_the_kernel():
    before = tssd.ssd_scan.launches
    tops.ssd_scan(*_torch(_scan_inputs(1, 16, 1, 4, 4, seed=0)), chunk=8)
    assert tssd.ssd_scan.launches == before
    assert tssd._lib is None


def test_ssd_scan_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises: a host tensor is refused."""
    with pytest.raises(ValueError):
        tssd.ssd_scan(*_torch(_scan_inputs(1, 16, 1, 4, 4, seed=0)),
                      chunk=8)


# ------------------------------------------------------------------ #
# One Mamba2 mixer, the reduced mamba2-1.3b config                    #
# ------------------------------------------------------------------ #
def _mixer_pair(dtype: str, seed: int = 0):
    """The reference's mixer params and the port's mixer holding them."""
    jcfg = jget_reduced("mamba2-1.3b").replace(dtype=dtype)
    cfg = get_reduced("mamba2-1.3b").replace(dtype=dtype)
    params = jax.tree_util.tree_map(
        np.asarray, JSSM.init_ssm_params(jax.random.PRNGKey(seed), jcfg))
    mixer = SSM.SSMMixer(cfg, device="cpu")
    with torch.no_grad():
        for name, p in mixer.named_parameters():
            p.copy_(torch.tensor(params[name]))
    return jcfg, cfg, params, mixer


def _acts(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def _tol(dtype, want):
    return 1e-4 if dtype == "float32" else 0.02 * float(
        np.abs(want).max())


def _as(arr, dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(arr, jd), torch.from_numpy(arr).to(td)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [32, 21])
def test_ssm_layer_and_prefill_layer_match_reference(dtype, S):
    jcfg, cfg, params, mixer = _mixer_pair(dtype)
    xj, xt = _as(_acts(cfg, (2, S), seed=S), dtype)
    want = np.asarray(JSSM.ssm_layer(params, xj, jcfg), np.float32)
    assert np.isfinite(want).all()
    with torch.inference_mode():
        got = SSM.ssm_layer(mixer, xt, cfg)
        out, entry = T._ssm_prefill_layer(mixer, xt, cfg)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=_tol(dtype, want))
    assert torch.equal(out, got)
    jout, jentry = JT._ssm_prefill_layer(params, xj, jcfg)
    np.testing.assert_allclose(
        entry["conv"].float().numpy(), np.asarray(jentry["conv"],
                                                  np.float32),
        atol=_tol(dtype, np.asarray(jentry["conv"], np.float32)))
    np.testing.assert_allclose(entry["ssm"].numpy(),
                               np.asarray(jentry["ssm"]),
                               atol=_tol(dtype, np.asarray(jentry["ssm"])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_matches_reference(dtype):
    jcfg, cfg, params, mixer = _mixer_pair(dtype, seed=1)
    rng = np.random.default_rng(2)
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    conv = rng.standard_normal((2, cfg.ssm_conv_width - 1, conv_ch)).astype(
        np.float32)
    state = rng.standard_normal((2, cfg.ssm_nheads, cfg.ssm_state,
                                 cfg.ssm_headdim)).astype(np.float32)
    xj, xt = _as(_acts(cfg, (2, 1), seed=4), dtype)
    cj, ct = _as(conv, dtype)
    jout, jnew = JSSM.ssm_decode(
        params, xj, {"conv": cj, "ssm": jnp.asarray(state)}, jcfg)
    with torch.inference_mode():
        out, new = SSM.ssm_decode(
            mixer, xt, {"conv": ct, "ssm": torch.from_numpy(state)}, cfg)
    want = np.asarray(jout, np.float32)
    np.testing.assert_allclose(out.float().numpy(), want,
                               atol=_tol(dtype, want))
    np.testing.assert_allclose(new["conv"].float().numpy(),
                               np.asarray(jnew["conv"], np.float32),
                               atol=_tol(dtype, conv))
    np.testing.assert_allclose(new["ssm"].numpy(), np.asarray(jnew["ssm"]),
                               atol=_tol(dtype, np.asarray(jnew["ssm"])))
    empty = SSM.init_ssm_cache(cfg, 2, xt.dtype, device="cpu")
    assert empty["conv"].shape == conv.shape
    assert empty["ssm"].shape == state.shape
