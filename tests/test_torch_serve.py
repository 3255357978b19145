"""The port's mamba2 LM and ``ServeEngine`` against the JAX package's.

The reduced mamba2-1.3b config runs through both packages with the same
weights: the reference's ``T.init_params`` tree, carried into the port by
``model_from_arrays``.  The reference's model runs as its own CPU tests
run it (the scan's jnp oracle).  Tolerances and why:

* ``prefill`` and ``decode_step`` in fp32: last-position logits and the
  conv/ssm cache within 1e-4 (fp32 sums in another order through 4
  layers), then 4 decode steps within 1e-4;
* ``ServeEngine.generate``, greedy: the criterion of
  ``tests/test_train_serve.py:82`` against the reference's ``T.forward``
  logits, teacher-forced on the port's tokens — each token within 0.05 of
  the max logit in bf16 (random-init near-ties) and within 1e-4 in fp32.
  Greedy only: sampling with temperature draws from a
  ``torch.Generator``, which cannot reproduce JAX's threefry bits.
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
from repro_torch.config.base import ShapeConfig
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.models import io as IO
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

ROOT = Path(__file__).resolve().parents[1]


def _pair(dtype: str, seed: int = 0):
    jcfg = jget_reduced("mamba2-1.3b").replace(dtype=dtype)
    cfg = get_reduced("mamba2-1.3b").replace(dtype=dtype)
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    arrays = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, cfg, params, T.model_from_arrays(cfg, arrays, device="cpu")


def _prompts(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_prefill_and_decode_match_reference():
    jcfg, cfg, params, model = _pair("float32")
    prompts = _prompts(cfg, (2, 8))
    jlg, jcache = JT.prefill(jcfg, params, {"tokens": jnp.asarray(prompts)})
    lg, cache = T.prefill(cfg, model, {"tokens": prompts})
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4)
    for name in ("conv", "ssm"):
        assert cache[name].shape == jcache[name].shape
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=1e-4)
    tok = np.argmax(np.asarray(jlg), axis=-1)[:, None].astype(np.int32)
    for step in range(4):
        jlg, jcache = JT.decode_step(jcfg, params, jnp.asarray(tok), jcache,
                                     jnp.asarray(8 + step, jnp.int32))
        lg, cache = T.decode_step(cfg, model, torch.from_numpy(tok), cache,
                                  8 + step)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4)
        np.testing.assert_allclose(cache["ssm"].numpy(),
                                   np.asarray(jcache["ssm"]), atol=1e-4)
        np.testing.assert_allclose(cache["conv"].numpy(),
                                   np.asarray(jcache["conv"]), atol=1e-4)
        tok = np.argmax(np.asarray(jlg), axis=-1)[:, None].astype(np.int32)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 0.05),
                                       ("float32", 1e-4)])
def test_serve_engine_matches_reference_forward_greedy(dtype, tol):
    """Engine generation == greedy argmax over the reference's repeated
    full forwards, teacher-forced on the port's tokens."""
    jcfg, cfg, params, model = _pair(dtype)
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


def test_forward_matches_reference_logits():
    jcfg, cfg, params, model = _pair("float32", seed=3)
    tokens = _prompts(cfg, (2, 21), seed=1)        # ragged against chunk 16
    jlg, _ = JT.forward(jcfg, params, {"tokens": jnp.asarray(tokens)})
    lg, aux = T.forward(cfg, model, {"tokens": tokens})
    assert lg.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4)


def test_sampling_is_seeded():
    _, cfg, _, model = _pair("float32")
    eng = ServeEngine(cfg, model, max_len=16, device="cpu")
    prompts = _prompts(cfg, (2, 4))
    runs = [eng.generate(prompts, max_new_tokens=6, temperature=0.8,
                         seed=s).tokens for s in (5, 5, 6)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert ((runs[0] >= 0) & (runs[0] < cfg.vocab_size)).all()


def test_init_params_draws_the_reference_distributions():
    cfg = get_reduced("mamba2-1.3b").replace(vocab_size=4096)
    gen = torch.Generator().manual_seed(0)
    model = T.init_params(cfg, generator=gen, device="cpu")
    mixer = model.layers[0].ssm
    assert len(model.layers) == cfg.num_layers
    assert T.lm_head_table(cfg, model) is model.embed     # tied
    assert abs(float(model.embed.std()) - 0.02) < 1e-3
    assert abs(float(mixer.w_in.std()) - cfg.d_model ** -0.5) < 5e-3
    assert abs(float(mixer.conv_w.std()) - 0.2) < 0.02
    jp = jax.tree_util.tree_map(np.asarray, JT.init_params(
        jget_reduced("mamba2-1.3b"), jax.random.PRNGKey(0)))["layers"]["ssm"]
    for name in ("A_log", "D", "dt_bias", "norm_scale", "conv_b"):
        np.testing.assert_allclose(getattr(mixer, name).detach().numpy(),
                                   jp[name][0], rtol=1e-6)


def test_model_from_arrays_rejects_a_wrong_tree():
    jcfg = jget_reduced("mamba2-1.3b")
    arrays = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = get_reduced("mamba2-1.3b")
    with pytest.raises(KeyError):
        T.model_from_arrays(cfg, {k: v for k, v in arrays.items()
                                  if k != "final_norm"}, device="cpu")
    bad = dict(arrays, embed=arrays["embed"][:, :8])
    with pytest.raises(ValueError):
        T.model_from_arrays(cfg, bad, device="cpu")


def test_registry_and_cache_specs():
    cfg = get_config("mamba2-1.3b")
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_nheads,
            cfg.ssm_state, cfg.ssm_chunk, cfg.vocab_size) == \
        (48, 2048, 4096, 64, 128, 256, 50280)
    assert get_config("seamless-m4t-large-v2").family == "encdec"
    assert get_config("qwen2-vl-72b").use_mrope
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    specs = IO.cache_specs(cfg, ShapeConfig("d", "decode", 32768, 4))
    assert specs["conv"] == ((48, 4, 3, 4352), torch.bfloat16)
    assert specs["ssm"] == ((48, 4, 64, 128, 64), torch.float32)


def test_engine_defaults_to_cuda():
    _, cfg, _, model = _pair("float32")
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, model)


def _cli(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-1.3b", *args], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)


def test_cli_serves_the_reduced_config_on_the_cpu():
    proc = _cli("--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "4", "--temperature",
                "0")
    assert proc.returncode == 0, proc.stderr
    assert "tok/s" in proc.stdout and "device=cpu" in proc.stdout


def test_cli_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")
    proc = _cli("--reduced")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
