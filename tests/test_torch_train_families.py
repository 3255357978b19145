"""LM training of the ssm (mamba2), hybrid (zamba2), moe (qwen3-moe,
moonshot), vlm (qwen2-vl) and encdec (seamless) families in the port
against the JAX package's, at reduced size on the CPU.

Weights cross with ``model_from_arrays`` from the reference's
``T.init_params`` tree; batches come from both packages'
``TokenPipeline`` (which emits ``positions`` for the vlm and
``enc_embeds`` for encdec).  On the CPU the port's SSD scan is autograd
of its plain version and the reference differentiates its jnp oracle
(chunk 16 here, where the oracle is finite).  Tolerances and why, as
``tests/test_torch_train.py`` holds the dense family:

* fp32: the loss within 1e-5 relative, every leaf's gradient within 1e-5
  of its largest entry (fp32 sums in another order; measured ≤ 5.2e-6);
  3 FLEXA ``step_fn`` steps on each side, losses within 1e-5 and
  parameters within ``STEP_PARAM_TOL``: 1e-5 for mamba2, 1e-4 for
  zamba2, whose trajectory amplifies rounding: the reference itself,
  started from parameters perturbed by 1e-7 relative, moves 4.4e-5 by
  step 3 (mamba2: 6.7e-6), and the port differs from it by 2.9e-5 (the
  embedding);
* bf16: the loss within 2e-2 relative (the two frameworks round bf16
  products at other places; MoE routing may flip an expert at a
  near-tie);
* remat: the same loss and gradients bit for bit (the recompute runs the
  same ops on the same inputs);
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
from repro.configs.registry import get_reduced as jget_reduced
from repro.data.synthetic import TokenPipeline as JTokenPipeline
from repro.distributed import compression as JCOMP
from repro.models import transformer as JT
from repro.train.loop import TrainLoop as JTrainLoop
from repro_torch.config.base import TrainConfig
from repro_torch.configs.registry import get_reduced
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.distributed import compression as COMP
from repro_torch.models import transformer as T
from repro_torch.train.loop import TrainLoop

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["mamba2-1.3b", "zamba2-1.2b", "qwen3-moe-30b-a3b",
         "moonshot-v1-16b-a3b", "qwen2-vl-72b", "seamless-m4t-large-v2"]
SSM_ARCHS = ["mamba2-1.3b", "zamba2-1.2b"]
#: Parameters after 3 FLEXA steps, against the reference's (see above).
STEP_PARAM_TOL = {"mamba2-1.3b": 1e-5, "zamba2-1.2b": 1e-4}


def _pair(arch: str, dtype: str, seed: int = 0):
    jcfg = jget_reduced(arch).replace(dtype=dtype)
    cfg = get_reduced(arch).replace(dtype=dtype)
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    arrays = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, cfg, params, T.model_from_arrays(cfg, arrays, device="cpu")


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _leaf_values(leaves):
    return [np.stack([t.detach().numpy() for t in leaf.tensors])
            if leaf.stacked else leaf.tensors[0].detach().numpy()
            for leaf in leaves]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_fp32(arch):
    jcfg, cfg, params, model = _pair(arch, "float32")
    batch = JTokenPipeline(jcfg, 2, 40, seed=0)(0)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, _jbatch(batch)), has_aux=True)(params)
    loss, aux = T.loss_fn(cfg, model, batch, remat=True)
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(float(aux["aux"]) - float(jaux["aux"])) <= 1e-5 * max(
        1.0, abs(float(jaux["aux"])))
    if cfg.family == "moe":
        assert float(aux["aux"]) > 0.5        # the layers' sum, weighted in
    flat, _ = jax.tree_util.tree_flatten_with_path(jg)
    leaves = T.param_leaves(cfg, model)
    assert len(leaves) == len(flat)
    for (path, g), leaf in zip(flat, leaves):
        assert tuple(p.key for p in path) == leaf.path
        grad = np.stack([t.grad.numpy() for t in leaf.tensors]) \
            if leaf.stacked else leaf.tensors[0].grad.numpy()
        g = np.asarray(g)
        assert grad.shape == g.shape
        assert np.abs(g).max() > 0, leaf.path
        assert np.abs(grad - g).max() <= 1e-5 * np.abs(g).max(), leaf.path


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference_bf16(arch):
    jcfg, cfg, params, model = _pair(arch, "bfloat16")
    batch = JTokenPipeline(jcfg, 2, 40, seed=1)(0)
    jl, _ = JT.loss_fn(jcfg, params, _jbatch(batch))
    loss, _ = T.loss_fn(cfg, model, batch)
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 2e-2 * abs(float(jl))
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_step_fn_matches_reference_for_three_steps(arch):
    """FLEXA: losses within 1e-5 of the reference, parameters within
    ``STEP_PARAM_TOL``, the same selection share and mean τ."""
    jcfg, cfg, params, model = _pair(arch, "float32")
    kw = dict(optimizer="flexa", lr=1e-3)
    jloop = JTrainLoop(jcfg, JTrainConfig(**kw), batch=2, seq_len=32)
    loop = TrainLoop(cfg, TrainConfig(**kw), batch=2, seq_len=32,
                     device="cpu")
    jopt, jcomp = jloop.opt_init(params), JCOMP.init_state(params)
    leaves = T.param_leaves(cfg, model)
    opt, comp = loop.opt_init(leaves), COMP.CompressionState(None)
    for step in range(3):
        np.testing.assert_array_equal(loop.batch(step)["tokens"].numpy(),
                                      jloop.pipe(step)["tokens"])
        params, jopt, jcomp, jm = jloop.step_fn(
            params, jopt, jcomp, _jbatch(jloop.pipe(step)))
        model, opt, comp, m = loop.step_fn(model, opt, comp,
                                           loop.batch(step))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
        for got, want in zip(_leaf_values(leaves),
                             jax.tree_util.tree_leaves(params)):
            assert np.abs(got - np.asarray(want)).max() <= \
                STEP_PARAM_TOL[arch]
        for k in ("flexa/sel_frac", "flexa/tau_mean"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_remat_changes_nothing(arch):
    _, cfg, _, model = _pair(arch, "float32")
    batch = TokenPipeline(cfg, 2, 24, seed=0)(0)
    out = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        loss, _ = T.loss_fn(cfg, model, batch, remat=remat)
        loss.backward()
        out.append([loss.detach()] + [p.grad.clone()
                                      for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def _losses(log):
    return [(m["step"], m["loss"]) for m in log]


@pytest.mark.parametrize("optimizer", ["adamw", "flexa"])
def test_mamba2_checkpoints_cross_between_packages(tmp_path, optimizer):
    """mamba2-1.3b reduced, fp32: one package trains 5 steps and
    checkpoints; the other resumes to step 10 from a copy of the
    directory, within 1e-4 of the writer's own resume.  AdamW starts from
    the reference's checkpoint, FLEXA from the port's."""
    jcfg = jget_reduced("mamba2-1.3b").replace(dtype="float32")
    cfg = get_reduced("mamba2-1.3b").replace(dtype="float32")
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
    for name in sorted(p.name for p in (a / "step_00000010").glob("*.npy")):
        np.testing.assert_allclose(np.load(b / "step_00000010" / name),
                                   np.load(a / "step_00000010" / name),
                                   rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "seamless-m4t-large-v2"])
def test_cli_trains_the_reduced_config_on_the_cpu(arch):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "16", "--log-every", "1"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "device=cpu" in proc.stdout and "step     3 loss" in proc.stdout
