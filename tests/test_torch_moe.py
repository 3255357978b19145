"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``, its mesh-free path).

Both layers run on the same numpy-seeded weights and inputs (x standard
normal, as ``tests/test_models.py:123-133`` draws it).  Tolerances and
why:

* ``capacity``: equal, for a grid of token counts and capacity factors.
* ``moe_layer`` in fp32, where pairs drop (capacity factors 1.0 and
  0.5): y within 1e-5 + 1e-6·|y| of the reference's elementwise (|y|
  reaches ≈ 55 here, where one fp32 ulp is 3.8e-6; the two packages'
  softmax and router products round differently in the last bits), the
  aux loss within 1e-5, the same count of drops.
* Ties: with the router forced to tie exactly, the port's top-k ids equal
  ``lax.top_k``'s (the lower id first) and its drop set equals the one
  the reference's rule gives on those ids; y as above.
* Determinism: two calls give the same bits.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jget_config
from repro.configs.registry import get_reduced as jget_reduced
from repro.models import moe as JM
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.models import moe as M

ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]


def _pair(arch: str, cf: float, seed: int = 0):
    jcfg = jget_reduced(arch).replace(capacity_factor=cf)
    cfg = get_reduced(arch).replace(capacity_factor=cf)
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_moe_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, params, _port(cfg, params)


def _port(cfg, params) -> M.MoEParams:
    p = M.MoEParams(cfg, device="cpu")
    with torch.no_grad():
        for name, value in params.items():
            getattr(p, name).copy_(torch.from_numpy(np.array(value)))
    return p


def _x(cfg, seed=0, T=64, positive=False):
    x = np.random.default_rng(seed).standard_normal(
        (2, T // 2, cfg.d_model)).astype(np.float32)
    return np.abs(x) if positive else x


def _drop_set(ids: np.ndarray, E: int, cap: int) -> set:
    """The (token, choice) pairs the reference's ``_moe_local`` drops for
    top-k ids ``ids`` (T, k): a place ≥ cap in token-major, choice-minor
    order, and the pair in slot (0, 0) when a dropped pair follows it
    (the reference clamps a dropped pair's write to slot (0, 0))."""
    T, k = ids.shape
    seen = np.zeros(E, np.int64)
    drops, first0, last_drop = set(), None, -1
    for i, e in enumerate(ids.reshape(-1)):
        if seen[e] >= cap:
            drops.add(divmod(i, k))
            last_drop = i
        elif e == 0 and seen[e] == 0:
            first0 = i
        seen[e] += 1
    if first0 is not None and first0 < last_drop:
        drops.add(divmod(first0, k))
    return drops


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_capacity_matches_reference(arch, size):
    cfg, jcfg = ((get_reduced(arch), jget_reduced(arch)) if size == "reduced"
                 else (get_config(arch), jget_config(arch)))
    for cf in (0.5, 1.0, 1.25, 8.0, cfg.num_experts / cfg.moe_top_k):
        for T in (1, 2, 3, 7, 16, 64, 100, 4096, 4104, 16384):
            assert M.capacity(T, cfg.replace(capacity_factor=cf)) == \
                JM.capacity(T, jcfg.replace(capacity_factor=cf))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [1.0, 0.5])
def test_moe_layer_matches_reference_where_pairs_drop(arch, cf):
    jcfg, cfg, params, p = _pair(arch, cf)
    x = _x(cfg)
    jy, jaux = JM.moe_layer(params, jnp.asarray(x), jcfg)
    p.drop_log = log = []
    y, aux = M.moe_layer(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-5
    assert 0.5 < float(aux) < 4.0      # balanced-ish routing at init
    T, k = 64, cfg.moe_top_k
    r = M.route(torch.from_numpy(x).reshape(T, -1), p, cfg,
                M.capacity(T, cfg))
    ids = np.asarray(jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x).reshape(T, -1) @ params["router"], axis=-1), k)[1])
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    want = _drop_set(ids, cfg.num_experts, M.capacity(T, cfg))
    got = {divmod(i, k) for i in np.flatnonzero(~r.keep.numpy())}
    assert got == want and len(want) > 0
    assert [(int(d), n) for d, n in log] == [(len(want), T * k)]


@pytest.mark.parametrize("tie", ["all", "pair"])
def test_forced_router_tie_gives_the_reference_drop_set(tie):
    """``all``: a zero router, every expert ties for every token, so each
    token picks experts 0..k−1 and expert 0 overflows (its slot (0, 0)
    overwritten by the later drops).  ``pair``: x > 0 and every router
    column −1 but experts 3 and 5 (0), which tie at the top for every
    token; a top-k that put 5 first would fill the buffers in another
    order."""
    jcfg, cfg, params, _ = _pair("qwen3-moe-30b-a3b", 1.0)
    router = np.zeros_like(params["router"])
    if tie == "pair":
        router -= 1.0
        router[:, [3, 5]] = 0.0
    params = dict(params, router=router)
    p = _port(cfg, params)
    x = _x(cfg, seed=2, positive=True)
    T, k, E = 64, cfg.moe_top_k, cfg.num_experts
    cap = M.capacity(T, cfg)
    ids = np.asarray(jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x).reshape(T, -1) @ router, axis=-1), k)[1])
    assert (ids == ([0, 1] if tie == "all" else [3, 5])).all()
    r = M.route(torch.from_numpy(x).reshape(T, -1), p, cfg, cap)
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    want = _drop_set(ids, E, cap)
    assert {divmod(i, k) for i in np.flatnonzero(~r.keep.numpy())} == want
    assert len(want) == 2 * (T - cap) + (tie == "all")
    jy, jaux = JM.moe_layer(params, jnp.asarray(x), jcfg)
    y, aux = M.moe_layer(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-5
    dropped = np.abs(y.numpy().reshape(T, -1)).max(axis=1) == 0
    assert dropped.sum() == T - cap          # tokens cap.. drop both choices


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_calls_give_the_same_bits(dtype):
    _, cfg, _, p = _pair("moonshot-v1-16b-a3b", 1.0, seed=1)
    x = torch.from_numpy(_x(cfg, seed=1)).to(dtype)
    y1, a1 = M.moe_layer(p, x, cfg)
    y2, a2 = M.moe_layer(p, x, cfg)
    assert y1.dtype == dtype and torch.equal(y1, y2) and torch.equal(a1, a2)


def test_drop_log_counts_each_call_while_set():
    _, cfg, _, p = _pair("qwen3-moe-30b-a3b", 8.0)
    x = torch.from_numpy(_x(cfg))
    assert p.drop_log is None
    M.moe_layer(p, x, cfg)
    p.drop_log = log = []
    M.moe_layer(p, x, cfg)
    M.moe_layer(p, x[:, :4], cfg)
    p.drop_log = None
    M.moe_layer(p, x, cfg)
    assert [(int(d), n) for d, n in log] == [(0, 64 * 2), (0, 8 * 2)]
