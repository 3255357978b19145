"""LM training in the port (dense family, FLEXA and AdamW, TrainLoop,
checkpoints, CLI) against the JAX package's, at reduced size on the CPU.

Weights cross with ``model_from_arrays`` from the reference's
``T.init_params`` tree; batches come from both packages'
``TokenPipeline``.  Tolerances and why:

* fp32: the loss within 1e-5 relative, every leaf's gradient within 1e-5
  of its largest entry (fp32 sums in another order; measured ≈ 2e-6);
  3 ``step_fn`` steps on each side, losses and parameters within 1e-5;
* bf16: the loss within 2e-2 relative (the two frameworks round bf16
  products and the embedding gradient at other places);
* ``TokenPipeline``: bitwise (the numpy generator is a copy);
* a checkpoint written by one package and resumed by the other: the
  resumed losses within 1e-4 of the writer's own resume.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import get_reduced as jget_reduced
from repro.data.synthetic import TokenPipeline as JTokenPipeline
from repro.distributed import compression as JCOMP
from repro.models import transformer as JT
from repro.train.loop import TrainLoop as JTrainLoop
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import ckpt as CK
from repro_torch.config.base import TrainConfig
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.distributed import compression as COMP
from repro_torch.models import transformer as T
from repro_torch.train.loop import StragglerMonitor, TrainLoop

ROOT = Path(__file__).resolve().parents[1]


def _pair(arch: str, dtype: str, seed: int = 0):
    jcfg = jget_reduced(arch).replace(dtype=dtype)
    cfg = get_reduced(arch).replace(dtype=dtype)
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    arrays = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, cfg, params, T.model_from_arrays(cfg, arrays, device="cpu")


def _leaf_values(leaves):
    return [np.stack([t.detach().numpy() for t in leaf.tensors])
            if leaf.stacked else leaf.tensors[0].detach().numpy()
            for leaf in leaves]


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", ["stablelm-3b", "yi-6b"])
def test_loss_and_grads_match_reference_fp32(arch):
    jcfg, cfg, params, model = _pair(arch, "float32")
    batch = JTokenPipeline(jcfg, 2, 40, seed=0)(0)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, _jbatch(batch)), has_aux=True)(params)
    loss, aux = T.loss_fn(cfg, model, batch, remat=True)
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(aux["aux"]) == 0.0
    flat, _ = jax.tree_util.tree_flatten_with_path(jg)
    leaves = T.param_leaves(cfg, model)
    assert len(leaves) == len(flat) == 12
    for (path, g), leaf in zip(flat, leaves):
        assert tuple(p.key for p in path) == leaf.path
        grad = np.stack([t.grad.numpy() for t in leaf.tensors]) \
            if leaf.stacked else leaf.tensors[0].grad.numpy()
        g = np.asarray(g)
        assert grad.shape == g.shape
        assert np.abs(grad - g).max() <= 1e-5 * np.abs(g).max(), leaf.path


@pytest.mark.parametrize("arch", ["stablelm-3b", "yi-6b"])
def test_loss_matches_reference_bf16(arch):
    jcfg, cfg, params, model = _pair(arch, "bfloat16")
    batch = JTokenPipeline(jcfg, 2, 40, seed=1)(0)
    jl, _ = JT.loss_fn(jcfg, params, _jbatch(batch))
    loss, _ = T.loss_fn(cfg, model, batch)
    assert abs(float(loss) - float(jl)) <= 2e-2 * abs(float(jl))


def test_remat_changes_nothing():
    """Checkpointed layers give the same loss and gradients, bit for bit
    (the recompute runs the same ops on the same inputs)."""
    _, cfg, _, model = _pair("stablelm-3b", "float32")
    batch = TokenPipeline(cfg, 2, 24, seed=0)(0)
    grads = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        loss, _ = T.loss_fn(cfg, model, batch, remat=remat)
        loss.backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


#: AdamW entries whose reference √v̂ after a step is below this share of
#: their leaf's median are ill-conditioned (see the test below).
ADAMW_ILL_SHARE = 1e-3


@pytest.mark.parametrize("optimizer", ["flexa", "adamw"])
def test_step_fn_matches_reference_for_three_steps(optimizer):
    """Losses and parameters within 1e-5 of the reference.  AdamW divides
    each entry's step by that entry's own √v̂, so an entry whose gradient
    is near zero carries the gradient's relative rounding into its step
    (measured 1.5e-5 on one of 12288 entries).  Those entries, where the
    reference's √v̂ falls below ``ADAMW_ILL_SHARE`` of its leaf's median
    at some step, are held at 0.1·lr = 1e-4 and may be at most 0.1 % of
    a leaf; every other entry is held at 1e-5, below the 1e-4·|x| a step
    of weight decay moves it."""
    jcfg, cfg, params, model = _pair("stablelm-3b", "float32")
    kw = dict(optimizer=optimizer, lr=1e-3)
    jtcfg = JTrainConfig(**kw)
    jloop = JTrainLoop(jcfg, jtcfg, batch=2, seq_len=32)
    loop = TrainLoop(cfg, TrainConfig(**kw), batch=2, seq_len=32,
                     device="cpu")
    jopt, jcomp = jloop.opt_init(params), JCOMP.init_state(params)
    leaves = T.param_leaves(cfg, model)
    opt, comp = loop.opt_init(leaves), COMP.CompressionState(None)
    ill = [np.zeros(np.shape(x), bool)
           for x in jax.tree_util.tree_leaves(params)]
    for step in range(3):
        np.testing.assert_array_equal(loop.batch(step)["tokens"].numpy(),
                                      jloop.pipe(step)["tokens"])
        params, jopt, jcomp, jm = jloop.step_fn(
            params, jopt, jcomp, _jbatch(jloop.pipe(step)))
        model, opt, comp, m = loop.step_fn(model, opt, comp,
                                           loop.batch(step))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
        if optimizer == "adamw":
            for k, nu in enumerate(jax.tree_util.tree_leaves(jopt.nu)):
                sv = np.sqrt(np.asarray(nu) / (1 - jtcfg.betas[1] ** (step
                                                                       + 1)))
                ill[k] |= sv < ADAMW_ILL_SHARE * np.median(sv)
        for got, want, loose in zip(_leaf_values(leaves),
                                    jax.tree_util.tree_leaves(params), ill):
            assert loose.mean() <= 1e-3
            err = np.abs(got - np.asarray(want))
            assert err[~loose].max(initial=0.0) <= 1e-5
            assert err[loose].max(initial=0.0) <= 1e-4
        if optimizer == "flexa":
            # the same mask and τ; the means round in another order
            for k in ("flexa/sel_frac", "flexa/tau_mean"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           rtol=1e-6)


@pytest.mark.parametrize("seed,step,host", [(0, 0, 0), (7, 3, 0), (7, 3, 1),
                                            (11, 50, 0)])
@pytest.mark.parametrize("arch", ["stablelm-3b", "yi-6b"])
def test_token_pipeline_is_the_reference_bit_for_bit(arch, seed, step, host):
    jp = JTokenPipeline(jget_reduced(arch), 4, 33, seed=seed, host_id=host,
                        n_hosts=2)
    tp = TokenPipeline(get_reduced(arch), 4, 33, seed=seed, host_id=host,
                       n_hosts=2)
    want, got = jp(step), tp(step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    full = TokenPipeline(get_config(arch), 2, 64, seed=seed)(step)
    np.testing.assert_array_equal(full["tokens"], JTokenPipeline(
        jget_config(arch), 2, 64, seed=seed)(step)["tokens"])


# ------------------------------------------------------------------ #
# The reference's loop tests (tests/test_train_serve.py), on the port #
# ------------------------------------------------------------------ #
def test_train_loop_loss_decreases(tmp_path):
    cfg = get_reduced("stablelm-3b")
    tcfg = TrainConfig(optimizer="flexa", steps=30, log_every=100,
                       ckpt_dir=str(tmp_path), ckpt_every=10,
                       ckpt_async=False)
    loop = TrainLoop(cfg, tcfg, batch=4, seq_len=64, device="cpu")
    loop.run()
    losses = [m["loss"] for m in loop.metrics_log]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert loop.ckpt.latest_step() == 30      # periodic + final


def test_train_loop_resume_continues(tmp_path):
    cfg = get_reduced("yi-6b")
    tcfg = TrainConfig(optimizer="adamw", lr=1e-3, steps=10, log_every=100,
                       ckpt_dir=str(tmp_path), ckpt_every=5,
                       ckpt_async=False)
    loop1 = TrainLoop(cfg, tcfg, batch=2, seq_len=32, device="cpu")
    loop1.run(steps=5)
    assert loop1.ckpt.latest_step() == 5
    loop2 = TrainLoop(cfg, tcfg, batch=2, seq_len=32, device="cpu")
    loop2.run(steps=10)
    steps_run = [m["step"] for m in loop2.metrics_log]
    assert steps_run[0] == 6 and steps_run[-1] == 10
    # a run resumed at its last step runs nothing and keeps the checkpoint
    loop3 = TrainLoop(cfg, tcfg, batch=2, seq_len=32, device="cpu")
    loop3.run(steps=10)
    assert loop3.metrics_log == [] and loop3.ckpt.latest_step() == 10


def test_straggler_monitor():
    m = StragglerMonitor(factor=2.0)
    for _ in range(10):
        m.observe(0.1)
    assert m.observe(0.5) is True
    assert m.slow_steps == 1
    assert m.observe(0.1) is False


def test_grad_compression_in_loop():
    """topk + the γ-scaled error-feedback carry descends."""
    cfg = get_reduced("stablelm-3b")
    tcfg = TrainConfig(optimizer="flexa", steps=20, log_every=100,
                       grad_compression="topk", grad_topk_frac=0.25)
    loop = TrainLoop(cfg, tcfg, batch=4, seq_len=64, device="cpu")
    loop.run()
    losses = [m["loss"] for m in loop.metrics_log]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


@pytest.mark.parametrize("kind", ["topk", "int8"])
def test_compression_matches_reference(kind):
    """compress over stacked leaves, with the feedback carry, equals the
    reference's on the same gradients (top-k and the int8 scale span a
    whole leaf in both)."""
    _, cfg, params, model = _pair("stablelm-3b", "float32")
    rng = np.random.default_rng(5)
    jgrads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
        params)
    leaves = T.param_leaves(cfg, model)
    grads = []
    for leaf, g in zip(leaves, jax.tree_util.tree_leaves(jgrads)):
        g = torch.from_numpy(np.array(g))
        grads.append(list(g) if leaf.stacked else [g])
    jc, jst = JCOMP.compress(jgrads, JCOMP.init_state(params), kind=kind,
                             topk_frac=0.1, feedback_scale=0.3)
    c, st = COMP.compress(grads, COMP.init_state(leaves), kind=kind,
                          topk_frac=0.1, feedback_scale=0.3)
    for got, want, r, jr in zip(c, jax.tree_util.tree_leaves(jc),
                                st.residual, jax.tree_util.tree_leaves(
                                    jst.residual)):
        np.testing.assert_allclose(np.stack([t.numpy() for t in got]),
                                   np.asarray(want).reshape(
                                       (len(got),) + got[0].shape),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.stack([t.numpy() for t in r]),
                                   np.asarray(jr).reshape(
                                       (len(r),) + r[0].shape),
                                   rtol=0, atol=1e-6)
    assert COMP.wire_bytes(grads, kind, 0.1) == JCOMP.wire_bytes(
        jgrads, kind, 0.1)


def test_multi_device_settings_are_refused():
    cfg = get_reduced("stablelm-3b")
    for kw in (dict(pipeline=True), dict(strategy="zero3"),
               dict(microbatch=2), dict(pp_microbatches=4)):
        with pytest.raises(NotImplementedError, match="multi-device"):
            TrainLoop(cfg, TrainConfig(**kw), device="cpu")


# ------------------------------------------------------------------ #
# Checkpoints across the two packages                                #
# ------------------------------------------------------------------ #
def _losses(log):
    return [(m["step"], m["loss"]) for m in log]


@pytest.mark.parametrize("optimizer", ["adamw", "flexa"])
def test_checkpoints_cross_between_packages(tmp_path, optimizer):
    """yi-6b reduced, fp32: one package trains 5 steps and checkpoints;
    the other resumes to step 10 from a copy of the directory, within
    1e-4 of the writer's own resume.  AdamW starts from the reference's
    checkpoint, FLEXA from the port's."""
    jcfg = jget_reduced("yi-6b").replace(dtype="float32")
    cfg = get_reduced("yi-6b").replace(dtype="float32")
    a, b = tmp_path / "writer", tmp_path / "reader"
    kw = dict(optimizer=optimizer, lr=1e-3, steps=10, log_every=100,
              ckpt_every=5, ckpt_async=False, ckpt_dir=str(a))
    make_j = lambda d: JTrainLoop(jcfg, JTrainConfig(**dict(  # noqa: E731
        kw, ckpt_dir=str(d))), batch=2, seq_len=32)
    make_t = lambda d: TrainLoop(cfg, TrainConfig(**dict(  # noqa: E731
        kw, ckpt_dir=str(d))), batch=2, seq_len=32, device="cpu")
    writer, reader = (make_j, make_t) if optimizer == "adamw" \
        else (make_t, make_j)
    writer(a).run(steps=5)
    shutil.copytree(a, b)
    own = writer(a)
    own.run(steps=10)
    other = reader(b)
    other.run(steps=10)
    want, got = _losses(own.metrics_log), _losses(other.metrics_log)
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(6, 11))
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=0, atol=1e-4)
    # the reader's final checkpoint holds the same leaves as the writer's
    for name in sorted(p.name for p in (a / "step_00000010").glob("*.npy")):
        np.testing.assert_allclose(np.load(b / "step_00000010" / name),
                                   np.load(a / "step_00000010" / name),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_checkpointer_roundtrip_retention_and_torn_write(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    arrays = [np.arange(12.0).reshape(3, 4), np.asarray(3, np.int32)]
    for s in (1, 2, 3):
        ck.save(s, arrays)
    ck.save_async(4, arrays)
    ck.wait()
    assert ck.latest_step() == 4
    assert sorted(p.name for p in tmp_path.glob("step_????????")) == [
        "step_00000003", "step_00000004"]
    (tmp_path / "step_00000005.tmp").mkdir()        # a torn write
    got, step = ck.restore([(3, 4), ()])
    assert step == 4 and got[1].dtype == np.int32
    np.testing.assert_array_equal(got[0], arrays[0])
    with pytest.raises(ValueError):
        ck.restore([(4, 3), ()])


def test_train_state_layout_is_the_references(tmp_path):
    """The leaves a FLEXA diag-Q state writes: 12 stacked parameter
    leaves, the 6 controller fields, 12 q_ema leaves — the reference's
    tree_flatten of (params, FlexaOptState)."""
    jcfg, cfg, params, model = _pair("stablelm-3b", "float32")
    from repro.core import optimizer as JO
    jinit, _ = JO.flexa_optimizer(JTrainConfig(flexa_diag_q=True))
    want = jax.tree_util.tree_leaves((params, jinit(params)))
    loop = TrainLoop(cfg, TrainConfig(flexa_diag_q=True), device="cpu")
    leaves = T.param_leaves(cfg, model)
    opt = loop.opt_init(leaves)
    got = CK.train_state_arrays(leaves, opt)
    assert CK.train_state_shapes(leaves, opt) == [g.shape for g in got]
    assert [(g.shape, g.dtype) for g in got] == [
        (np.asarray(w).shape, np.asarray(w).dtype) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


# ------------------------------------------------------------------ #
# CLI                                                                #
# ------------------------------------------------------------------ #
def _cli(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "stablelm-3b", *args], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)


def test_cli_trains_the_reduced_config_on_the_cpu():
    proc = _cli("--reduced", "--device", "cpu", "--steps", "3", "--batch",
                "2", "--seq", "16", "--log-every", "1")
    assert proc.returncode == 0, proc.stderr
    assert "device=cpu" in proc.stdout and "step     3 loss" in proc.stdout


def test_cli_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")
    proc = _cli("--reduced", "--steps", "1")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
