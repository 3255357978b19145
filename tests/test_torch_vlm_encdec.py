"""Serving of the vlm (qwen2-vl-72b, M-RoPE) and encdec
(seamless-m4t-large-v2, encoder plus cross-attention) families in the
port, against the JAX package's.

Each arch runs at ``reduced()`` through both packages with the same
weights: the reference's ``T.init_params`` tree, carried into the port by
``model_from_arrays``.  On the CPU the prefill's attention is the
``flash_attention`` kernel's plain version; the reference's model runs
as its own CPU tests run it.  The vlm cases feed M-RoPE streams whose t,
h and w differ (random, B × 3 × S); the engine feeds text positions
(t = h = w).  The encdec cases run frames both as long as the prompt and
of another length.  Tolerances and why:

* ``apply_mrope``: against the reference within 1.2e-5 (fp32, |x| ≤ 5,
  positions below 4096).  Not bitwise: ``theta ** x`` of the
  frequencies and ``sin`` / ``cos`` of the angles come from another
  library (XLA's against torch's).  Two or three of the frequencies
  differ by 2.3e-10 (one ulp), which moves an angle by at most 4096 ×
  2.3e-10 ≈ 9.5e-7, and sin / cos differ by an ulp (6e-8) on ≈ 5 % of
  the angles: |Δ| ≤ (|x₁| + |x₂|)(9.5e-7 + 6e-8) + 2 ulp(5) ≈ 1.1e-5.
  Bitwise, within the port: each section rotates by ``apply_rope`` at
  that section's stream, so t = h = w equals ``apply_rope``.
* ``forward``, ``prefill`` and ``decode_step`` in fp32: logits within
  1e-4 of the reference's (fp32 sums in another order through 2–3
  layers), the KV and cross caches within 1e-5.
* prefill → decode → forward: fp32 within 1e-4; bf16 within 2e-2
  (prefill) and 5e-2 (decode), ``tests/test_torch_families.py``'s
  bounds, which are the reference test's.  For encdec the decode side
  holds only where the frames fill the grown cross cache (enc_len =
  max_len): see the caveat below.
* ``ServeEngine.generate``: in fp32 the tokens equal the reference
  engine's and the prefill logits are within 1e-4 of them; in bf16 each
  token within 0.05 of the max logit of the reference's ``forward``
  teacher-forced on the port's tokens (encdec with enc_len = max_len).
* The reference caveat: the engines grow ``cross_k`` / ``cross_v`` to
  max_len with zeros, and decode's cross-attention reads them all, so the
  reference engine's first decode logits are more than 1e-2 off its own
  teacher-forced ``forward`` (0.178 at these sizes), and the port's
  engine follows the reference's engine within 1e-4.
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
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.config.base import SHAPES, ShapeConfig
from repro_torch.configs import registry
from repro_torch.kernels import ops as kops
from repro_torch.models import io as IO
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
VLM, ENCDEC = "qwen2-vl-72b", "seamless-m4t-large-v2"
ARCHS = [VLM, ENCDEC]
#: (arch, frames' length or None for the prompt's) of the parity tests.
CASES = [(VLM, None), (ENCDEC, None), (ENCDEC, 9)]


def _pair(arch: str, dtype: str, seed: int = 0):
    jcfg = jregistry.get_reduced(arch).replace(dtype=dtype)
    cfg = registry.get_reduced(arch).replace(dtype=dtype)
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    arrays = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, cfg, params, T.model_from_arrays(cfg, arrays, device="cpu")


def _batch(cfg, B, S, enc_len=None, seed=1) -> dict:
    """Tokens, distinct M-RoPE streams (vlm) or frames (encdec)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B, S)).astype(np.int32)}
    if cfg.use_mrope:
        batch["positions"] = rng.integers(0, 4 * S, (B, 3, S)).astype(
            np.int32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rng.standard_normal(
            (B, enc_len or S, cfg.d_model)).astype(np.float32)
    return batch


def _jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _case_id(case) -> str:
    arch, enc_len = case
    return arch + (f"/enc{enc_len}" if enc_len else "")


# --------------------------------------------------------------- M-RoPE
@pytest.mark.parametrize("D", [16, 64, 128])
def test_apply_mrope_matches_reference_on_distinct_streams(D):
    rng = np.random.default_rng(D)
    x = rng.uniform(-5, 5, (2, 3, 11, D)).astype(np.float32)
    pos3 = rng.integers(0, 4096, (2, 3, 11)).astype(np.int32)
    assert len({tuple(pos3[0, i]) for i in range(3)}) == 3
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3))
    want = np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3)))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1.2e-5)
    # each section rotates by its own stream, as apply_rope does, bitwise
    half, start = D // 2, 0
    for i, n in enumerate(L.mrope_sections(D)):
        ref = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos3[:, i]))
        for lo in (start, half + start):
            assert torch.equal(got[..., lo:lo + n], ref[..., lo:lo + n]), i
        start += n
    # t = h = w: apply_rope bit for bit, in fp32 and bf16
    same = np.ascontiguousarray(np.broadcast_to(pos3[:, :1], pos3.shape))
    for dt in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dt)
        assert torch.equal(L.apply_mrope(xt, torch.from_numpy(same)),
                           L.apply_rope(xt, torch.from_numpy(pos3[:, 0])))


@pytest.mark.parametrize("D", [8, 16, 64, 80, 128])
def test_mrope_sections_are_the_reference_split(D):
    assert L.mrope_sections(D) == JL.mrope_sections(D)
    assert sum(L.mrope_sections(D)) == D // 2
    assert L.mrope_sections(128) == (16, 24, 24)


# ------------------------------------------------------ model parity
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_forward_matches_reference_logits(case):
    arch, enc_len = case
    jcfg, cfg, params, model = _pair(arch, "float32", seed=3)
    batch = _batch(cfg, 2, 13, enc_len)
    jlg, _ = JT.forward(jcfg, params, _jbatch(batch))
    lg, aux = T.forward(cfg, model, batch)
    assert lg.dtype == torch.float32 and lg.shape == (2, 13, cfg.vocab_size)
    np.testing.assert_allclose(_np(lg), _np(jlg), atol=1e-4)
    assert float(aux) == 0.0


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_prefill_and_decode_match_reference(case):
    """prefill (logits and every cache tensor), the engines' cache growth,
    then 3 decode steps, each against the reference's, in fp32."""
    arch, enc_len = case
    S, steps = 10, 3
    jcfg, cfg, params, model = _pair(arch, "float32")
    batch = _batch(cfg, 2, S, enc_len)
    jlg, jcache = JT.prefill(jcfg, params, _jbatch(batch))
    lg, cache = T.prefill(cfg, model, batch)
    assert lg.dtype == torch.float32 and lg.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(_np(lg), _np(jlg), atol=1e-4)
    specs = IO.cache_specs(cfg, ShapeConfig("p", "prefill", S, 2))
    assert set(cache) == set(jcache) == set(specs)
    for name, t in cache.items():
        want = specs[name].shape
        if name.startswith("cross"):
            want = want[:3] + (enc_len or S,) + want[4:]
        assert (tuple(t.shape), t.dtype) == (want, specs[name].dtype), name
        np.testing.assert_allclose(_np(t), _np(jcache[name]), atol=1e-5,
                                   err_msg=name)
    cap = S + steps + 1
    full = ServeEngine(cfg, model, max_len=cap, device="cpu")._grow_cache(
        cache, 2)
    jfull = JServeEngine(jcfg, params, max_len=cap)._grow_cache(jcache, 2)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (steps, 2, 1))
    for step in range(steps):
        tok = toks[step].astype(np.int32)
        jlg, jfull = JT.decode_step(jcfg, params, jnp.asarray(tok), jfull,
                                    jnp.asarray(S + step, jnp.int32))
        lg, full = T.decode_step(cfg, model, torch.from_numpy(tok), full,
                                 S + step)
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=1e-4,
                                   err_msg=f"step {step}")
        for name in full:
            np.testing.assert_allclose(_np(full[name]), _np(jfull[name]),
                                       atol=1e-5, err_msg=f"{name} {step}")


def _text_positions(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32), (B, 3, S)).copy()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_forward_consistency(arch, dtype):
    """prefill → decode against the reference's and the port's own
    forward over the same tokens.  vlm on distinct M-RoPE streams, whose
    decode positions continue the t stream... the engine's text layout,
    so decode's one position (broadcast to t, h and w) is the forward's;
    encdec with frames as long as the grown cache (no zero pad)."""
    S, steps = 12, 4
    cap = S + steps
    jcfg, cfg, params, model = _pair(arch, dtype)
    full_batch = _batch(cfg, 2, S + steps - 1, enc_len=cap)
    if cfg.use_mrope:
        full_batch["positions"] = _text_positions(2, S + steps - 1)
    tokens = full_batch["tokens"]
    jfull = _np(JT.forward(jcfg, params, _jbatch(full_batch))[0])
    tfull = _np(T.forward(cfg, model, full_batch)[0])
    pre = dict(full_batch, tokens=tokens[:, :S - 1])
    if cfg.use_mrope:
        pre["positions"] = _text_positions(2, S - 1)
    lg, cache = T.prefill(cfg, model, pre)
    fp32 = dtype == "float32"
    for want in (jfull, tfull):
        np.testing.assert_allclose(_np(lg), want[:, S - 2],
                                   atol=1e-4 if fp32 else 2e-2)
    full = ServeEngine(cfg, model, max_len=cap, device="cpu")._grow_cache(
        cache, 2)
    for step in range(steps):
        pos = S - 1 + step
        lg, full = T.decode_step(cfg, model,
                                 torch.from_numpy(tokens[:, pos:pos + 1]),
                                 full, pos)
        for want in (jfull, tfull):
            np.testing.assert_allclose(_np(lg), want[:, pos],
                                       atol=1e-4 if fp32 else 5e-2,
                                       err_msg=f"step {step}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_engine_matches_reference(arch, dtype):
    """Greedy generation: in fp32 the reference engine's tokens and
    prefill logits; in bf16 each token within 0.05 of the max logit of
    the reference's forward teacher-forced on the port's tokens.  encdec
    frames fill max_len, so the forward is what decode computes."""
    B, Lp, new = 2, 8, 4
    jcfg, cfg, params, model = _pair(arch, dtype)
    prompts = _batch(cfg, B, Lp)["tokens"]
    extra = None
    if cfg.is_encoder_decoder:
        extra = {"enc_embeds": _batch(cfg, B, Lp, enc_len=Lp + new)[
            "enc_embeds"]}
    res = ServeEngine(cfg, model, max_len=Lp + new, device="cpu").generate(
        prompts, max_new_tokens=new, extra_inputs=extra)
    assert res.tokens.shape == (B, new) and res.tokens.dtype == np.int32
    assert res.prefill_logits.shape == (B, cfg.vocab_size)
    if dtype == "float32":
        jres = JServeEngine(jcfg, params, max_len=Lp + new).generate(
            prompts, max_new_tokens=new, extra_inputs=extra)
        np.testing.assert_array_equal(res.tokens, jres.tokens)
        np.testing.assert_allclose(res.prefill_logits, jres.prefill_logits,
                                   atol=1e-4)
        return
    seq = prompts.copy()
    for step in range(new):
        batch = {"tokens": seq}
        if cfg.use_mrope:
            batch["positions"] = _text_positions(B, seq.shape[1])
        if extra:
            batch.update(extra)
        lg, _ = JT.forward(jcfg, params, _jbatch(batch))
        last = np.asarray(lg[:, -1, :])
        tok = res.tokens[:, step]
        for b in range(B):
            assert last[b, tok[b]] >= last[b].max() - 0.05, (step, b)
        seq = np.concatenate([seq, tok[:, None]], axis=1)


def test_engine_follows_the_reference_padded_cross_cache():
    """The reference caveat, pinned: reduced seamless, 2 × 8 prompt, 8
    frames, max_len 14.  The engines' first decode step reads a cross
    cache zero past the 8 frames; the reference's logits there are more
    than 1e-2 off its own teacher-forced forward (and near the decode
    over the unpadded cross cache only where it has no pad), and the
    port's follow the reference's within 1e-4."""
    B, Lp, cap = 2, 8, 14
    jcfg, cfg, params, model = _pair(ENCDEC, "float32")
    batch = _batch(cfg, B, Lp, seed=0)
    jb = _jbatch(batch)
    jlg, jcache = JT.prefill(jcfg, params, jb)
    tok = np.asarray(jnp.argmax(jlg, axis=-1))[:, None].astype(np.int32)
    jgrown = JServeEngine(jcfg, params, max_len=cap)._grow_cache(jcache, B)
    jdec, _ = JT.decode_step(jcfg, params, jnp.asarray(tok), jgrown,
                             jnp.asarray(Lp, jnp.int32))
    # the same step over the cross cache as long as the frames: no pad
    exact = dict(jgrown, cross_k=jcache["cross_k"],
                 cross_v=jcache["cross_v"])
    jexact, _ = JT.decode_step(jcfg, params, jnp.asarray(tok), exact,
                               jnp.asarray(Lp, jnp.int32))
    fwd, _ = JT.forward(jcfg, params, _jbatch(dict(
        batch, tokens=np.concatenate([batch["tokens"], tok], axis=1))))
    teacher = _np(fwd)[:, -1]
    assert np.abs(_np(jdec) - teacher).max() > 1e-2
    assert np.abs(_np(jexact) - teacher).max() < 1e-4
    lg, cache = T.prefill(cfg, model, batch)
    assert torch.equal(torch.argmax(lg, dim=-1)[:, None],
                       torch.from_numpy(tok).long())
    grown = ServeEngine(cfg, model, max_len=cap, device="cpu")._grow_cache(
        cache, B)
    assert grown["cross_k"].shape[3] == cap
    assert not grown["cross_k"][:, :, :, Lp:].any()
    dec, _ = T.decode_step(cfg, model, torch.from_numpy(tok), grown, Lp)
    np.testing.assert_allclose(_np(dec), _np(jdec), atol=1e-4)


# ------------------------------------------------- kernels on the path
def _count_attention(monkeypatch) -> list:
    calls = []
    fn = kops.flash_attention

    def counted(q, k, v, *, causal=True, scale=None):
        calls.append((causal, q.shape[2], k.shape[2]))
        return fn(q, k, v, causal=causal, scale=scale)
    monkeypatch.setattr(kops, "flash_attention", counted)
    return calls


def test_encdec_prefill_and_decode_run_flash_attention_per_role(
        monkeypatch):
    """Prefill: the encoder's non-causal attention over the frames per
    encoder layer, then per decoder layer its causal self-attention and
    its cross-attention (prompt queries, frame keys); each decode step:
    one cross-attention of one query over the grown cache per layer (the
    self-attention is ``decode_attention``)."""
    _, cfg, _, model = _pair(ENCDEC, "bfloat16")
    calls = _count_attention(monkeypatch)
    eng = ServeEngine(cfg, model, max_len=12, device="cpu")
    frames = _batch(cfg, 2, 6, enc_len=9)["enc_embeds"]
    eng.generate(_batch(cfg, 2, 6)["tokens"], max_new_tokens=3,
                 extra_inputs={"enc_embeds": frames})
    E, D = cfg.enc_layers, cfg.num_layers
    assert calls == [(False, 9, 9)] * E + [(True, 6, 6), (False, 6, 9)] * D \
        + [(False, 1, 12)] * D * 2
    casts = model.dec_layers[0].cross_attn.__dict__["_param_casts"]
    assert sorted(name for name, _ in casts) == ["wk", "wo", "wq", "wv"]


def test_vlm_prefill_runs_flash_attention_once_per_layer(monkeypatch):
    _, cfg, _, model = _pair(VLM, "bfloat16")
    calls = _count_attention(monkeypatch)
    ServeEngine(cfg, model, max_len=12, device="cpu").generate(
        _batch(cfg, 2, 7)["tokens"], max_new_tokens=3)
    assert calls == [(True, 7, 7)] * cfg.num_layers


# ------------------------------------------- parameters and configs
@pytest.mark.parametrize("arch", ARCHS)
def test_param_leaves_follow_reference_flatten_order(arch):
    _, cfg, params, model = _pair(arch, "float32")
    leaves = T.param_leaves(cfg, model)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    assert [leaf.path for leaf in leaves] == \
        [tuple(k.key for k in path) for path, _ in flat]
    for leaf, (_, want) in zip(leaves, flat):
        got = torch.stack(leaf.tensors) if leaf.stacked else leaf.tensors[0]
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_the_reference_tree(arch):
    cfg = registry.get_reduced(arch).replace(vocab_size=4096)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
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
    if cfg.family == "encdec":
        assert isinstance(model, T.EncDecLM)
        assert (len(model.enc_layers), len(model.dec_layers)) == \
            (cfg.enc_layers, cfg.num_layers)
        blk = model.dec_layers[0]
        for attn in (blk.self_attn, blk.cross_attn,
                     model.enc_layers[0].attn):
            assert abs(float(attn.wq.std()) - cfg.d_model ** -0.5) < 0.03
        assert float(blk.ln3.min()) == float(blk.ln3.max()) == 1.0
        assert all(p.requires_grad for p in model.parameters())
    else:
        assert isinstance(model, T.DenseLM)
        assert abs(float(model.layers[0].attn.wq.detach().std())
                   - cfg.d_model ** -0.5) < 0.03


def test_model_from_arrays_rejects_a_wrong_encdec_tree():
    jcfg = jregistry.get_reduced(ENCDEC)
    cfg = registry.get_reduced(ENCDEC)
    arrays = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    for drop in ("enc_layers", "dec_layers", "lm_head"):
        with pytest.raises(KeyError):
            T.model_from_arrays(cfg, {k: v for k, v in arrays.items()
                                      if k != drop}, device="cpu")
    dec = dict(arrays["dec_layers"])
    dec["cross_attn"] = {k: v for k, v in dec["cross_attn"].items()
                         if k != "wk"}
    with pytest.raises(KeyError):
        T.model_from_arrays(cfg, dict(arrays, dec_layers=dec), device="cpu")
    enc = dict(arrays["enc_layers"], ln1=arrays["enc_layers"]["ln1"][:1])
    with pytest.raises(ValueError):
        T.model_from_arrays(cfg, dict(arrays, enc_layers=enc), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    for got, want in ((registry.get_config(arch), jregistry.get_config(arch)),
                      (registry.get_reduced(arch),
                       jregistry.get_reduced(arch))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert registry.ARCHS[arch] is registry.get_config(arch)


def test_registry_takes_every_reference_arch():
    assert registry.NOT_YET_PORTED == {}
    assert set(registry.ARCHS) == set(jregistry.ARCHS)
    for arch in jregistry.ARCHS:
        assert registry.get_config(arch).name == arch
    assert SHAPES.keys() == {"train_4k", "prefill_32k", "decode_32k",
                             "long_500k"}
    for arch, cfg in registry.ARCHS.items():
        for shape in SHAPES.values():
            assert registry.cell_applicable(cfg, shape)[0] == \
                jregistry.cell_applicable(jregistry.get_config(arch),
                                          jregistry.SHAPES[shape.name])[0]
    cells = list(registry.iter_cells(include_skipped=True))
    assert len(cells) == 10 * 4
    assert sum(ok for *_, ok, _ in cells) == \
        sum(ok for *_, ok, _ in jregistry.iter_cells(include_skipped=True))


def test_full_configs_published_shapes_and_cache_specs():
    c = registry.get_config(VLM)
    assert (c.family, c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.head_dim, c.d_ff, c.vocab_size, c.use_mrope) == \
        ("vlm", 80, 8192, 64, 8, 128, 29568, 152064, True)
    e = registry.get_config(ENCDEC)
    assert (e.family, e.enc_layers, e.num_layers, e.d_model, e.num_heads,
            e.num_kv_heads, e.head_dim, e.d_ff, e.vocab_size) == \
        ("encdec", 24, 24, 1024, 16, 16, 64, 8192, 256206)
    assert round(e.param_count() / 1e9, 2) == 2.03
    shape = ShapeConfig("serve", "decode", 4128, 4)
    bf16 = torch.bfloat16
    kv = ((80, 4, 8, 4128, 128), bf16)
    assert IO.cache_specs(c, shape) == {"k": kv, "v": kv}
    kv = ((24, 4, 16, 4128, 64), bf16)
    assert IO.cache_specs(e, shape) == {
        "self_k": kv, "self_v": kv, "cross_k": kv, "cross_v": kv}
    with pytest.raises(ValueError, match="unknown"):
        IO.cache_specs(c.replace(family="rnn"), shape)
    with pytest.raises(ValueError, match="unknown"):
        T.init_params(c.replace(family="rnn"), generator=torch.Generator(),
                      device="cpu")


# ----------------------------------------------------------- refusals
def test_missing_inputs_raise():
    _, cfg, _, model = _pair(VLM, "float32")
    batch = _batch(cfg, 2, 5)
    del batch["positions"]
    with pytest.raises(ValueError, match="positions"):
        T.prefill(cfg, model, batch)
    with pytest.raises(ValueError, match="positions"):
        T.prefill(cfg, model, dict(batch, positions=np.zeros((2, 5), int)))
    cache = IO.zero_cache(cfg, ShapeConfig("d", "decode", 4, 2),
                          device="cpu")
    with pytest.raises(ValueError, match="pos"):
        T.decode_step(cfg, model, np.zeros((2, 1), np.int32), cache)
    _, cfg, _, model = _pair(ENCDEC, "float32")
    eng = ServeEngine(cfg, model, max_len=8, device="cpu")
    prompts = _batch(cfg, 2, 4)["tokens"]
    with pytest.raises(ValueError, match="enc_embeds"):
        eng.generate(prompts, max_new_tokens=2)
    frames = _batch(cfg, 2, 4, enc_len=9)["enc_embeds"]
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(prompts, max_new_tokens=2,
                     extra_inputs={"enc_embeds": frames})
    with pytest.raises(ValueError, match="enc_embeds"):
        T.forward(cfg, model, {"tokens": prompts})


def _cli(arch, *args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         *args], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_reduced_config_on_the_cpu(arch):
    proc = _cli(arch, "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "4", "--temperature",
                "0")
    assert proc.returncode == 0, proc.stderr
    assert f"arch={arch}" in proc.stdout and "device=cpu" in proc.stdout
    assert "tok/s" in proc.stdout
