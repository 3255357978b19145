"""The port's attention against the JAX package's.

Inputs come from numpy seeds and go through both packages.  Tolerances
and why:

* ``flash_attention_ref`` (the kernel's plain version) against the
  reference's oracle ``ref.flash_attention_ref``, its Pallas kernel in
  interpret mode (as ``tests/test_kernels.py`` runs it on the CPU) and
  the port's ``chunked_attention``, over the cases of
  ``tests/test_kernels.py:111-150`` plus ragged and end-aligned key
  lengths: fp32 within 2e-5 (the reference test's tolerance: fp32 sums
  in another order); bf16 inputs within 2 bf16 ulps of each element plus
  2e-5 (both round an fp32 result that differs in the last bits).  The
  Pallas kernel does not mask keys past Skv in a ragged last block, so
  it is compared only where its blocks divide Skv.
* ``ops.flash_attention`` on the CPU is the plain version, and it
  refuses a causal call with Sq > Skv and a device with no kernel.
* ``decode_attention`` / ``attention_decode`` against the reference's:
  fp32 within 1e-5; bf16 within 2 bf16 ulps plus 1e-5 (the output is
  rounded to bf16 from fp32 sums taken in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_reduced as jget_reduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as JATT
from repro.models import transformer as JT
from repro_torch.configs.registry import get_reduced
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as ATT
from repro_torch.models import transformer as T

#: (B, Hq, Hkv, Sq, Skv, D, causal, Pallas blocks or None): MHA, GQA and
#: MQA squares (tests/test_kernels.py:111-115), non-causal (:131), the
#: end-aligned offset (:148), ragged Skv, Sq = 1, stablelm-3b's D = 80.
CASES = [
    (1, 2, 2, 64, 64, 16, True, (32, 32)),
    (2, 4, 2, 64, 64, 16, True, (16, 64)),
    (1, 8, 1, 128, 128, 32, True, (64, 32)),
    (1, 2, 2, 32, 32, 16, False, (16, 16)),
    (2, 4, 2, 8, 32, 16, True, (8, 8)),
    (1, 4, 2, 37, 53, 16, True, None),
    (2, 4, 2, 1, 29, 16, True, None),
    (1, 2, 1, 20, 45, 8, False, None),
    (1, 2, 2, 48, 48, 80, True, (16, 16)),
]


def _qkv(B, Hq, Hkv, Sq, Skv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


def _close(got, want, dtype, atol):
    """``got`` within ``atol`` of ``want`` (both fp32 numpy), plus 2 bf16
    ulps of each element when ``dtype`` is bf16."""
    tol = np.full(want.shape, atol, np.float32)
    if dtype == "bfloat16":
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                  2.0 ** -126))) - 7)
        tol = tol + 2 * ulp
    err = np.abs(got - want)
    assert (err <= tol).all(), float(err.max())


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ref_matches_reference(case, dtype):
    B, Hq, Hkv, Sq, Skv, D, causal, blocks = case
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, D, seed=Sq * Skv + D)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = tref.flash_attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (B, Hq, Sq, D)
    got = got.float().numpy()
    want = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal),
                      np.float32)
    _close(got, want, dtype, 2e-5)
    if blocks is not None:
        pallas = jops.flash_attention(jq, jk, jv, causal=causal,
                                      force="interpret", block_q=blocks[0],
                                      block_k=blocks[1])
        _close(got, np.asarray(pallas, np.float32), dtype, 2e-5)
    if dtype == "float32":
        chunked = ATT.chunked_attention(tq, tk, tv, causal=causal, block=16)
        np.testing.assert_allclose(chunked.numpy(), got, rtol=0, atol=2e-5)


def test_cpu_dispatch_is_the_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 2, 8, 32, 16, 1))
    n0 = tfa.flash_attention.launches
    got = tops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, tref.flash_attention_ref(q, k, v, causal=True))
    assert tfa.flash_attention.launches == n0
    assert tfa._lib is None
    assert tfa.flash_attention.plain is tref.flash_attention_ref


@pytest.mark.parametrize("what", ["causal Sq > Skv", "device", "shapes",
                                  "empty keys"])
def test_dispatch_refuses(what):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 8, 8, 16, 2))
    if what == "causal Sq > Skv":
        with pytest.raises(ValueError, match="Sq = 8 > Skv = 4"):
            tops.flash_attention(q, k[:, :, :4], v[:, :, :4], causal=True)
        tops.flash_attention(q, k[:, :, :4], v[:, :, :4], causal=False)
    elif what == "device":
        q, k, v = (t.to("meta") for t in (q, k, v))
        with pytest.raises(ValueError, match="no flash_attention kernel"):
            tops.flash_attention(q, k, v)
    elif what == "shapes":
        with pytest.raises(ValueError, match="shape mismatch"):
            tops.flash_attention(q, k, v[:, :, :4])
        with pytest.raises(ValueError, match="multiple of Hkv"):
            tops.flash_attention(q[:, :1], torch.cat([k, k], 1),
                                 torch.cat([v, v], 1))
    else:
        with pytest.raises(ValueError, match="empty key axis"):
            tops.flash_attention(q[:, :, :0], k[:, :, :0], v[:, :, :0])


@pytest.mark.parametrize("Hq,Hkv,S,cache_len", [(4, 4, 16, 16), (4, 2, 16, 9),
                                                (8, 1, 12, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(Hq, Hkv, S, cache_len, dtype):
    q, k, v = _qkv(2, Hq, Hkv, 1, S, 16, seed=S + cache_len)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    want = np.asarray(JATT.decode_attention(jq, jk, jv, cache_len),
                      np.float32)
    got = ATT.decode_attention(tq, tk, tv, cache_len)
    assert got.dtype == tq.dtype and got.shape == (2, Hq, 1, 16)
    _close(got.float().numpy(), want, dtype, 1e-5)


@pytest.mark.parametrize("arch", ["stablelm-3b", "yi-6b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode_matches_reference(arch, dtype):
    """One decode step of layer 0 on a half-filled cache: the output and
    the cache with the new token's k and v written at ``pos``."""
    jcfg = jget_reduced(arch).replace(dtype=dtype)
    cfg = get_reduced(arch).replace(dtype=dtype)
    params = JT.init_params(jcfg, jax.random.PRNGKey(1))
    arrays = jax.tree_util.tree_map(np.asarray, params)
    model = T.model_from_arrays(cfg, arrays, device="cpu")
    jattn = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["attn"])
    rng = np.random.default_rng(4)
    S, pos = 12, 7
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((2, cfg.num_kv_heads, S, cfg.head_dim)).astype(
        np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    ck[:, :, pos:] = 0.0
    cv[:, :, pos:] = 0.0
    out, nk, nv = JATT.attention_decode(
        jattn, jnp.asarray(x).astype(dtype), jnp.asarray(ck).astype(dtype),
        jnp.asarray(cv).astype(dtype), pos, jcfg)
    tdt = getattr(torch, dtype)
    tk, tv = (torch.from_numpy(a).to(tdt) for a in (ck, cv))
    with torch.inference_mode():                      # as decode_step
        got = ATT.attention_decode(
            model.layers[0].attn, torch.from_numpy(x).to(tdt), tk, tv, pos,
            cfg)
    for a, b in ((got, out), (tk, nk), (tv, nv)):     # cache: in place
        assert a.dtype == tdt
        _close(a.float().numpy(), np.asarray(b, np.float32), dtype, 1e-5)
