"""Serving of the hybrid (zamba2-1.2b), MoE (qwen3-moe-30b-a3b,
moonshot-v1-16b-a3b) and the last two dense archs (phi3-medium-14b,
deepseek-67b) in the port, against the JAX package's.

Each arch runs at ``reduced()`` through both packages with the same
weights: the reference's ``T.init_params`` tree, carried into the port by
``model_from_arrays``.  ``zamba2-1.2b/rem`` is the reduced zamba2 at 5
layers (2 groups of 2 and a remainder layer with no shared block after
it).  On the CPU the prefill's attention and SSD scan are the kernels'
plain versions; the reference's model runs as its own CPU tests run it.
Tolerances and why (those of ``tests/test_torch_dense_serve.py`` and
``tests/test_torch_serve.py``):

* ``forward`` and ``prefill`` / ``decode_step`` in fp32: logits within
  1e-4 of the reference's (fp32 sums in another order through 3–5
  layers), KV caches within 1e-5, the conv/ssm cache within 1e-4, the
  MoE aux loss within 1e-5.  MoE routes at the config's capacity factor
  in ``forward``; prefill/decode run at capacity factor 8, where nothing
  drops, as ``tests/test_models.py:48-52`` does, since a drop depends on
  the count of tokens routed together.
* prefill → decode → the port's own ``forward``: fp32 within 1e-4; bf16
  within 2e-2 (prefill) and 5e-2 (decode), the reference test's bounds.
* ``ServeEngine.generate``, greedy, as ``tests/test_train_serve.py:82``:
  each token within 0.05 of the max logit of the reference's
  ``T.forward`` teacher-forced on the port's tokens in bf16, 1e-4 in
  fp32, where the tokens also equal the reference engine's.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.config.base import ShapeConfig
from repro_torch.configs import registry
from repro_torch.kernels import ops as kops
from repro_torch.models import io as IO
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
NEW_ARCHS = ["zamba2-1.2b", "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b",
             "phi3-medium-14b", "deepseek-67b"]
#: The archs of the parity tests: the new ones, and zamba2 with a remainder.
CASES = NEW_ARCHS[:1] + ["zamba2-1.2b/rem"] + NEW_ARCHS[1:]
#: (case, dtype) of the bf16-and-fp32 tests.  MoE runs in fp32 only: its
#: router's bf16 logits near-tie, and a bf16 decode rounds the hidden state
#: otherwise than a bf16 forward, so a token can go to another expert, a
#: jump of O(1) in its logits.  The reference shows it too: its own bf16
#: decode of reduced moonshot-v1-16b-a3b (these prompts, capacity factor
#: 8) is 0.51 off its own forward at the fourth step.
DTYPE_CASES = [(c, d) for c in CASES for d in ("float32", "bfloat16")
               if d == "float32" or registry.get_reduced(
                   c.partition("/")[0]).family != "moe"]


def _configs(case: str, dtype: str, cf=None):
    arch, _, variant = case.partition("/")
    jcfg = jregistry.get_reduced(arch).replace(dtype=dtype)
    cfg = registry.get_reduced(arch).replace(dtype=dtype)
    if variant == "rem":
        jcfg, cfg = jcfg.replace(num_layers=5), cfg.replace(num_layers=5)
    if cf is not None and cfg.family == "moe":
        jcfg = jcfg.replace(capacity_factor=cf)
        cfg = cfg.replace(capacity_factor=cf)
    return jcfg, cfg


def _pair(case: str, dtype: str, *, cf=None, seed: int = 0):
    jcfg, cfg = _configs(case, dtype, cf)
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    arrays = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, cfg, params, T.model_from_arrays(cfg, arrays, device="cpu")


def _prompts(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _np(t) -> np.ndarray:
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


def _cache_tol(name: str) -> float:
    return 1e-4 if name in ("conv", "ssm") else 1e-5


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_reference_logits_and_aux(case):
    jcfg, cfg, params, model = _pair(case, "float32", seed=3)
    tokens = _prompts(cfg, (2, 21), seed=1)        # ragged against chunk 16
    jlg, jaux = JT.forward(jcfg, params, {"tokens": jnp.asarray(tokens)})
    lg, aux = T.forward(cfg, model, {"tokens": tokens})
    assert lg.dtype == torch.float32 and lg.shape == (2, 21, cfg.vocab_size)
    np.testing.assert_allclose(_np(lg), _np(jlg), atol=1e-4)
    assert abs(float(aux) - float(jaux)) <= 1e-5
    assert (float(aux) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("case,dtype", DTYPE_CASES)
def test_prefill_decode_forward_consistency(case, dtype):
    S, steps = 16, 4
    jcfg, cfg, params, model = _pair(case, dtype, cf=8.0)
    tokens = _prompts(cfg, (2, S + steps - 1), seed=1)
    jfull = _np(JT.forward(jcfg, params, {"tokens": jnp.asarray(tokens)})[0])
    tfull = _np(T.forward(cfg, model, {"tokens": tokens})[0])
    pre = tokens[:, :S - 1]
    lg, cache = T.prefill(cfg, model, {"tokens": pre})
    assert lg.dtype == torch.float32 and lg.shape == (2, cfg.vocab_size)
    specs = IO.cache_specs(cfg, ShapeConfig("p", "prefill", S - 1, 2))
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == \
        {k: (s.shape, s.dtype) for k, s in specs.items()}
    fp32 = dtype == "float32"
    for want in (jfull, tfull):
        np.testing.assert_allclose(_np(lg), want[:, S - 2],
                                   atol=1e-4 if fp32 else 2e-2)
    if fp32:
        jlg, jcache = JT.prefill(jcfg, params, {"tokens": jnp.asarray(pre)})
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=1e-4)
        assert set(cache) == set(jcache)
        for name in cache:
            np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                       atol=_cache_tol(name), err_msg=name)

    # grow to capacity as the engines do, then decode the remaining tokens
    cap = S + steps
    full = ServeEngine(cfg, model, max_len=cap, device="cpu")._grow_cache(
        cache, 2)
    if fp32:
        jcache = JServeEngine(jcfg, params, max_len=cap)._grow_cache(
            jcache, 2)
    for step in range(steps):
        pos = S - 1 + step
        tok = tokens[:, pos:pos + 1]
        lg, full = T.decode_step(cfg, model, torch.from_numpy(tok), full, pos)
        for want in (jfull, tfull):
            np.testing.assert_allclose(_np(lg), want[:, pos],
                                       atol=1e-4 if fp32 else 5e-2)
        if fp32:
            jlg, jcache = JT.decode_step(jcfg, params, jnp.asarray(tok),
                                         jcache, jnp.asarray(pos, jnp.int32))
            np.testing.assert_allclose(_np(lg), _np(jlg), atol=1e-4)
            for name in full:
                np.testing.assert_allclose(_np(full[name]),
                                           _np(jcache[name]),
                                           atol=_cache_tol(name),
                                           err_msg=f"{name} step {step}")


@pytest.mark.parametrize("case,dtype", DTYPE_CASES)
def test_serve_engine_matches_reference_forward_greedy(case, dtype):
    """Engine generation == greedy argmax over the reference's repeated
    full forwards, teacher-forced on the port's tokens; in fp32 also the
    reference engine's tokens.  MoE at capacity factor 8 (no drops)."""
    tol = 1e-4 if dtype == "float32" else 0.05
    jcfg, cfg, params, model = _pair(case, dtype, cf=8.0)
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


@pytest.mark.parametrize("case", CASES)
def test_param_leaves_follow_reference_flatten_order(case):
    _, cfg, params, model = _pair(case, "float32")
    leaves = T.param_leaves(cfg, model)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    assert [leaf.path for leaf in leaves] == \
        [tuple(k.key for k in path) for path, _ in flat]
    for leaf, (_, want) in zip(leaves, flat):
        got = torch.stack(leaf.tensors) if leaf.stacked else leaf.tensors[0]
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_model_from_arrays_rejects_a_wrong_tree(arch):
    jcfg, cfg = _configs(arch, "float32")
    arrays = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    with pytest.raises(KeyError):
        T.model_from_arrays(cfg, {k: v for k, v in arrays.items()
                                  if k != "final_norm"}, device="cpu")
    layers = dict(arrays["layers"])
    inner = "moe" if cfg.family == "moe" else (
        "ssm" if cfg.family == "hybrid" else "mlp")
    layers[inner] = {k: v for k, v in layers[inner].items()
                     if k != sorted(layers[inner])[0]}
    with pytest.raises(KeyError):
        T.model_from_arrays(cfg, dict(arrays, layers=layers), device="cpu")
    bad = dict(arrays, embed=arrays["embed"][:, :8])
    with pytest.raises(ValueError):
        T.model_from_arrays(cfg, bad, device="cpu")
    if cfg.family == "hybrid":
        with pytest.raises(KeyError):
            T.model_from_arrays(cfg, {k: v for k, v in arrays.items()
                                      if k != "shared"}, device="cpu")
        shared = dict(arrays["shared"], ln1=arrays["shared"]["ln1"][:4])
        with pytest.raises(ValueError):
            T.model_from_arrays(cfg, dict(arrays, shared=shared),
                                device="cpu")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_params_draws_the_reference_tree(arch):
    """Same leaves and shapes as the reference's tree; the reference's
    scales (embed 0.02, dense weights fan_in^-½, expert weights E^-½)."""
    cfg = registry.get_reduced(arch).replace(vocab_size=4096)
    gen = torch.Generator().manual_seed(0)
    model = T.init_params(cfg, generator=gen, device="cpu")
    jparams = JT.init_params(jregistry.get_reduced(arch).replace(
        vocab_size=4096), jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    leaves = T.param_leaves(cfg, model)
    assert [leaf.path for leaf in leaves] == \
        [tuple(k.key for k in path) for path, _ in flat]
    for leaf, (_, want) in zip(leaves, flat):
        got = torch.stack(leaf.tensors) if leaf.stacked else leaf.tensors[0]
        assert tuple(got.shape) == want.shape, leaf.path
    assert abs(float(model.embed.detach().std()) - 0.02) < 1e-3
    blk = model.shared if cfg.family == "hybrid" else model.layers[0]
    assert abs(float(blk.attn.wq.detach().std()) - cfg.d_model ** -0.5) < 0.02
    assert float(blk.ln1.min()) == float(blk.ln1.max()) == 1.0
    if cfg.family == "moe":
        assert abs(float(blk.moe.w1.std()) - cfg.num_experts ** -0.5) < 0.02
        assert abs(float(blk.moe.router.std()) - cfg.d_model ** -0.5) < 0.02
    if cfg.family in ("hybrid", "moe"):
        assert all(p.requires_grad for p in model.parameters())
    if cfg.family == "hybrid":
        assert len(model.layers) == cfg.num_layers
        assert isinstance(model.layers[0], T.SSMBlock)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_configs_equal_the_reference_field_for_field(arch):
    for got, want in ((registry.get_config(arch), jregistry.get_config(arch)),
                      (registry.get_reduced(arch),
                       jregistry.get_reduced(arch))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert registry.ARCHS[arch] is registry.get_config(arch)


def test_full_configs_published_widths():
    c = registry.get_config("zamba2-1.2b")
    assert (c.family, c.num_layers, c.d_model, c.ssm_state, c.attn_every,
            c.num_heads, c.head_dim) == ("hybrid", 38, 2048, 64, 6, 32, 64)
    c = registry.get_config("qwen3-moe-30b-a3b")
    assert (c.num_experts, c.moe_top_k, c.vocab_size, c.d_ff,
            c.num_heads * c.head_dim, c.d_model) == \
        (128, 8, 151936, 768, 4096, 2048)
    c = registry.get_config("moonshot-v1-16b-a3b")
    assert (c.num_experts, c.moe_top_k, c.num_layers) == (64, 6, 48)
    c = registry.get_config("phi3-medium-14b")
    assert (c.num_heads, c.num_kv_heads, c.head_dim) == (40, 10, 128)
    c = registry.get_config("deepseek-67b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.d_ff, c.vocab_size) == (95, 8192, 64, 8, 22016, 102400)


def test_hybrid_and_moe_cache_specs_at_full_width():
    shape = ShapeConfig("serve", "decode", 4128, 4)
    specs = IO.cache_specs(registry.get_config("zamba2-1.2b"), shape)
    bf16 = torch.bfloat16
    assert specs == {"conv": ((38, 4, 3, 4096 + 128), bf16),
                     "ssm": ((38, 4, 64, 64, 64), torch.float32),
                     "attn_k": ((6, 4, 32, 4128, 64), bf16),
                     "attn_v": ((6, 4, 32, 4128, 64), bf16)}
    specs = IO.cache_specs(registry.get_config("qwen3-moe-30b-a3b"), shape)
    assert specs == {"k": ((48, 4, 4, 4128, 128), bf16),
                     "v": ((48, 4, 4, 4128, 128), bf16)}


def test_grow_cache_grows_the_hybrid_kv_along_s_only():
    _, cfg, _, model = _pair("zamba2-1.2b", "float32")
    _, cache = T.prefill(cfg, model, {"tokens": _prompts(cfg, (2, 6))})
    full = ServeEngine(cfg, model, max_len=11, device="cpu")._grow_cache(
        cache, 2)
    assert full["attn_k"].shape == (2, 2, 4, 11, 16)
    for name in ("attn_k", "attn_v"):
        assert torch.equal(full[name][:, :, :, :6], cache[name])
        assert not full[name][:, :, :, 6:].any()
    for name in ("conv", "ssm"):
        assert full[name].shape == cache[name].shape
        assert torch.equal(full[name], cache[name])


def test_hybrid_prefill_runs_one_scan_per_layer_and_the_shared_block_per_group(
        monkeypatch):
    """5 layers at attn_every 2: 5 SSD scans, the shared attention after
    layers 2 and 4 (not after the remainder layer), each with the shared
    block's one set of weights (one cached cast)."""
    _, cfg, _, model = _pair("zamba2-1.2b/rem", "bfloat16")
    calls = []
    for name in ("ssd_scan", "flash_attention"):
        fn = getattr(kops, name)
        monkeypatch.setattr(kops, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    _, cache = T.prefill(cfg, model, {"tokens": _prompts(cfg, (2, 8))})
    assert calls == ["ssd_scan"] * 2 + ["flash_attention"] + \
        ["ssd_scan"] * 2 + ["flash_attention"] + ["ssd_scan"]
    assert cache["attn_k"].shape[0] == 2 and cache["conv"].shape[0] == 5
    casts = model.shared.attn.__dict__["_param_casts"]
    assert len(casts) == 4            # wq, wk, wv, wo: one bf16 cast each


def test_decode_needs_pos_for_the_attention_families():
    for case in ("zamba2-1.2b", "qwen3-moe-30b-a3b"):
        _, cfg, _, model = _pair(case, "float32")
        cache = IO.zero_cache(cfg, ShapeConfig("d", "decode", 4, 2),
                              device="cpu")
        with pytest.raises(ValueError, match="pos"):
            T.decode_step(cfg, model, np.zeros((2, 1), np.int32), cache)


def _cli(arch, *args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         *args], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cli_serves_the_reduced_config_on_the_cpu(arch):
    proc = _cli(arch, "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "4", "--temperature",
                "0")
    assert proc.returncode == 0, proc.stderr
    assert f"arch={arch}" in proc.stdout and "device=cpu" in proc.stdout
    assert "tok/s" in proc.stdout


def test_cli_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")
    proc = _cli("zamba2-1.2b", "--reduced")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
