"""Dense LM serving in the port against the JAX package's.

Reduced stablelm-3b (MHA) and yi-6b (GQA, 4 query heads over 2 kv
heads) run through both packages with the same weights: the reference's
``T.init_params`` tree, carried into the port by ``model_from_arrays``.
On the CPU the port's prefill attention is the plain version of the
``flash_attention`` kernel.  Tolerances and why:

* ``prefill`` → ``decode_step`` → ``forward`` consistency, as
  ``tests/test_models.py:47-82`` checks it: in fp32 the port's prefill
  and 4 decode steps within 1e-4 of the reference's ``T.prefill`` /
  ``T.decode_step`` and of its ``T.forward`` at the same positions (fp32
  sums in another order through 3 layers), the K and V caches within
  1e-5; in bf16 the prefill within 2e-2 and the decode within 5e-2 of the
  reference's forward, the reference test's own bounds (bf16 rounds at
  other places in the two paths).
* ``ServeEngine.generate``, greedy, as ``tests/test_train_serve.py:82``:
  each token within 0.05 of the max logit of the reference's
  ``T.forward`` teacher-forced on the port's tokens in bf16, within 1e-4
  in fp32, where the tokens also equal the reference engine's.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.config.base import ShapeConfig
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.models import io as IO
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["stablelm-3b", "yi-6b"]


def _pair(arch: str, dtype: str, seed: int = 0):
    jcfg = jget_reduced(arch).replace(dtype=dtype)
    cfg = get_reduced(arch).replace(dtype=dtype)
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    arrays = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, cfg, params, T.model_from_arrays(cfg, arrays, device="cpu")


def _prompts(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _np(t) -> np.ndarray:
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_forward_consistency(arch, dtype):
    S, steps = 16, 4
    jcfg, cfg, params, model = _pair(arch, dtype)
    tokens = _prompts(cfg, (2, S + steps - 1), seed=1)
    jfull, _ = JT.forward(jcfg, params, {"tokens": jnp.asarray(tokens)})
    jfull = _np(jfull)
    tfull, _ = T.forward(cfg, model, {"tokens": tokens})
    pre = tokens[:, :S - 1]
    lg, cache = T.prefill(cfg, model, {"tokens": pre})
    assert lg.dtype == torch.float32 and lg.shape == (2, cfg.vocab_size)
    kv_shape = (cfg.num_layers, 2, cfg.num_kv_heads, S - 1, cfg.head_dim)
    assert set(cache) == {"k", "v"}
    assert all(c.shape == kv_shape and c.dtype == getattr(torch, dtype)
               for c in cache.values())
    fp32 = dtype == "float32"
    np.testing.assert_allclose(_np(lg), jfull[:, S - 2],
                               atol=1e-4 if fp32 else 2e-2)
    np.testing.assert_allclose(_np(lg), _np(tfull[:, S - 2]),
                               atol=1e-4 if fp32 else 2e-2)
    if fp32:
        jlg, jcache = JT.prefill(jcfg, params, {"tokens": jnp.asarray(pre)})
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=1e-4)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                       atol=1e-5)

    # grow to capacity as the engines do, then decode the remaining tokens
    cap = S + steps
    full = ServeEngine(cfg, model, max_len=cap, device="cpu")._grow_cache(
        cache, 2)
    assert full["k"].shape == kv_shape[:3] + (cap, cfg.head_dim)
    if fp32:
        jcache = JServeEngine(jcfg, params, max_len=cap)._grow_cache(
            jcache, 2)
    for step in range(steps):
        pos = S - 1 + step
        tok = tokens[:, pos:pos + 1]
        lg, full = T.decode_step(cfg, model, torch.from_numpy(tok), full, pos)
        np.testing.assert_allclose(_np(lg), jfull[:, pos],
                                   atol=1e-4 if fp32 else 5e-2)
        if fp32:
            jlg, jcache = JT.decode_step(jcfg, params, jnp.asarray(tok),
                                         jcache, jnp.asarray(pos, jnp.int32))
            np.testing.assert_allclose(_np(lg), _np(jlg), atol=1e-4)
            for name in ("k", "v"):
                np.testing.assert_allclose(_np(full[name]),
                                           _np(jcache[name]), atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 0.05),
                                       ("float32", 1e-4)])
def test_serve_engine_matches_reference_forward_greedy(arch, dtype, tol):
    """Engine generation == greedy argmax over the reference's repeated
    full forwards, teacher-forced on the port's tokens; in fp32 also the
    reference engine's tokens."""
    jcfg, cfg, params, model = _pair(arch, dtype)
    prompts = _prompts(cfg, (2, 8))
    res = ServeEngine(cfg, model, max_len=16, device="cpu").generate(
        prompts, max_new_tokens=4)
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == np.int32
    assert res.prefill_logits.shape == (2, cfg.vocab_size)
    seq = prompts.copy()
    for step in range(4):
        lg, _ = JT.forward(jcfg, params, {"tokens": jnp.asarray(seq)})
        last = np.asarray(lg[:, -1, :])
        eng_tok = res.tokens[:, step]
        for b in range(2):
            assert last[b, eng_tok[b]] >= last[b].max() - tol, (step, b)
        seq = np.concatenate([seq, eng_tok[:, None]], axis=1)
    if dtype == "float32":
        jres = JServeEngine(jcfg, params, max_len=16).generate(
            prompts, max_new_tokens=4)
        np.testing.assert_array_equal(res.tokens, jres.tokens)


def test_dense_cache_specs_at_full_width():
    shape = ShapeConfig("serve", "decode", 4128, 4)
    specs = IO.cache_specs(get_config("stablelm-3b"), shape)
    assert specs == {"k": ((32, 4, 32, 4128, 80), torch.bfloat16),
                     "v": ((32, 4, 32, 4128, 80), torch.bfloat16)}
    specs = IO.cache_specs(get_config("yi-6b"), shape)
    assert specs["k"] == ((32, 4, 4, 4128, 128), torch.bfloat16)
    cfg = get_reduced("yi-6b").replace(dtype="float32")
    cache = IO.zero_cache(cfg, ShapeConfig("d", "decode", 9, 2), device="cpu")
    assert cache["v"].shape == (3, 2, 2, 9, 16)
    assert cache["v"].dtype == torch.float32 and not cache["v"].any()
    specs = IO.cache_specs(cfg.replace(family="encdec"), shape)
    assert set(specs) == {"self_k", "self_v", "cross_k", "cross_v"}
    assert specs["cross_k"] == ((3, 4, 2, 4128, 16), torch.float32)
    assert IO.cache_specs(cfg.replace(family="vlm"), shape)["v"] == \
        ((3, 4, 2, 4128, 16), torch.float32)
    with pytest.raises(ValueError, match="unknown"):
        IO.cache_specs(cfg.replace(family="rnn"), shape)


def test_dense_decode_needs_pos():
    _, cfg, _, model = _pair("stablelm-3b", "float32")
    cache = IO.zero_cache(cfg, ShapeConfig("d", "decode", 4, 2), device="cpu")
    with pytest.raises(ValueError, match="pos"):
        T.decode_step(cfg, model, np.zeros((2, 1), np.int32), cache)


def _cli(arch, *args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         *args], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_reduced_dense_config_on_the_cpu(arch):
    proc = _cli(arch, "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "4", "--temperature",
                "0")
    assert proc.returncode == 0, proc.stderr
    assert f"arch={arch}" in proc.stdout and "device=cpu" in proc.stdout
    assert "tok/s" in proc.stdout


def test_cli_dense_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")
    proc = _cli("stablelm-3b", "--reduced")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
