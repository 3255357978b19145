"""Fault-tolerant training loop, as ``repro.train.loop``.

* **checkpoint/restart** — periodic (+ final, + on-signal) atomic
  checkpoints of (params, opt_state) in the reference's format
  (:mod:`repro_torch.checkpoint.ckpt`); on start, auto-resume from the
  newest valid checkpoint (``TrainConfig.resume``), including one the
  JAX package wrote;
* **signal safety** — SIGTERM/SIGINT set a flag; the loop finishes the
  in-flight step, checkpoints, and exits cleanly;
* **straggler monitor** — per-step wall times feed an EWMA; steps slower
  than ``factor``× the EWMA are counted and logged;
* **gradient compression** hooks (:mod:`repro_torch.distributed.
  compression`);
* deterministic, restart-stable data order (the pipeline is keyed by the
  step index).

One step (:attr:`TrainLoop.step_fn`, the reference's
``step_fn(params, opt_state, comp_state, batch)``, with the model as
``params``): the loss and its backward, then the optimizer, which
updates the parameters in place.  The host reads one value per step,
the loss, as the reference does.  Runs on one device, the card by
default; the reference's mesh (``mesh``, ``dp_axes``) waits for the
multi-device step (ROADMAP Queue 1 step 12).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint import ckpt as CK
from repro_torch.config.base import ModelConfig, TrainConfig
from repro_torch.core.optimizer import get_optimizer
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.distributed import compression as COMP
from repro_torch.models import transformer as T

#: TrainConfig fields that only the reference's multi-device step
#: builders read; the single-device loop refuses other values.
MULTI_DEVICE_FIELDS = ("microbatch", "pipeline", "pp_microbatches",
                       "strategy")


@dataclass
class StragglerMonitor:
    factor: float = 2.0
    ewma: float = 0.0
    alpha: float = 0.1
    slow_steps: int = 0
    history: list = field(default_factory=list)

    def observe(self, dt: float) -> bool:
        slow = self.ewma > 0 and dt > self.factor * self.ewma
        self.ewma = dt if self.ewma == 0 else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        if slow:
            self.slow_steps += 1
        self.history.append(dt)
        return slow


class TrainLoop:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, *,
                 batch: int = 8, seq_len: int = 128, device="cuda"):
        defaults = TrainConfig()
        for name in MULTI_DEVICE_FIELDS:
            if getattr(tcfg, name) != getattr(defaults, name):
                raise NotImplementedError(
                    f"TrainConfig.{name}={getattr(tcfg, name)!r} needs the "
                    "multi-device step builders, not yet ported (ROADMAP "
                    "Queue 1 step 12)")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.pipe = TokenPipeline(cfg, batch, seq_len, seed=tcfg.seed)
        self.opt_init, self.opt_update = get_optimizer(tcfg)
        self.ckpt = CK.Checkpointer(tcfg.ckpt_dir, keep=tcfg.ckpt_keep) \
            if tcfg.ckpt_dir else None
        self.monitor = StragglerMonitor()
        self._stop = False
        self.metrics_log: list[dict] = []
        self.use_comp = tcfg.grad_compression != "none"

        def step_fn(params, opt_state, comp_state, batch):
            model = params
            model.zero_grad(set_to_none=True)
            loss, metrics = T.loss_fn(self.cfg, model, batch,
                                      remat=tcfg.remat)
            loss.backward()
            leaves = T.param_leaves(self.cfg, model)
            grads = [[t.grad for t in leaf.tensors] for leaf in leaves]
            model.zero_grad(set_to_none=True)    # `grads` holds them now
            loss = loss.detach()
            if self.use_comp:
                # γ-scaled error feedback γᵏ(1−γᵏ) for FLEXA; AdamW keeps
                # the classical unit-scale carry.
                g = getattr(opt_state, "gamma", None)
                fb = g * (1.0 - g) if g is not None else 1.0
                grads, comp_state = COMP.compress(
                    grads, comp_state, kind=tcfg.grad_compression,
                    topk_frac=tcfg.grad_topk_frac, feedback_scale=fb)
            _, new_opt, opt_metrics = self.opt_update(
                grads, opt_state, leaves, loss)
            metrics = {k: v.detach() for k, v in metrics.items()}
            return model, new_opt, comp_state, \
                dict(metrics, **opt_metrics, loss=loss)

        self.step_fn = step_fn

    # ------------------------------------------------------------- #
    def _install_signals(self):
        def handler(signum, frame):
            self._stop = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not on main thread (tests)

    def batch(self, step: int) -> dict:
        """The pipeline's batch of ``step`` as int32 tensors on the
        loop's device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.pipe(step).items()}

    def init_state(self, generator: torch.Generator | None = None):
        """(model, opt_state, comp_state) at step 0: weights drawn from
        ``generator`` (default ``torch.Generator(device)`` seeded with
        ``TrainConfig.seed``) on the loop's device.  The compression carry
        exists only when compression is on (the reference allocates a zero
        carry, a copy of the model in fp32, either way)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.tcfg.seed)
        model = T.init_params(self.cfg, generator=generator,
                              device=self.device)
        leaves = T.param_leaves(self.cfg, model)
        comp_state = COMP.init_state(leaves) if self.use_comp \
            else COMP.CompressionState(residual=None)
        return model, self.opt_init(leaves), comp_state

    def run(self, steps: int | None = None,
            generator: torch.Generator | None = None):
        tcfg = self.tcfg
        steps = steps if steps is not None else tcfg.steps
        model, opt_state, comp_state = self.init_state(generator)
        leaves = T.param_leaves(self.cfg, model)
        start_step = 0

        if self.ckpt is not None and tcfg.resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                arrays, _ = self.ckpt.restore(
                    CK.train_state_shapes(leaves, opt_state), step=latest)
                opt_state = CK.load_train_state(arrays, leaves, opt_state)
                start_step = latest
        self._install_signals()

        step = start_step - 1       # a resume at `steps` runs no step
        for step in range(start_step, steps):
            batch = self.batch(step)
            t0 = time.perf_counter()
            model, opt_state, comp_state, metrics = self.step_fn(
                model, opt_state, comp_state, batch)
            loss = float(metrics["loss"])       # sync point
            dt = time.perf_counter() - t0
            slow = self.monitor.observe(dt)
            rec = {"step": step + 1, "loss": loss, "time": dt,
                   "slow": slow}
            self.metrics_log.append(rec)
            if (step + 1) % tcfg.log_every == 0:
                print(f"step {step+1:5d} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms{' SLOW' if slow else ''})",
                      flush=True)
            if self.ckpt is not None and (step + 1) % tcfg.ckpt_every == 0:
                arrays = CK.train_state_arrays(leaves, opt_state)
                if tcfg.ckpt_async:
                    self.ckpt.save_async(step + 1, arrays)
                else:
                    self.ckpt.save(step + 1, arrays)
            if self._stop:
                print(f"signal received — checkpointing at step {step+1} "
                      "and exiting", flush=True)
                break

        if self.ckpt is not None:
            self.ckpt.wait()
            self.ckpt.save(max(start_step, min(step + 1, steps)),
                           CK.train_state_arrays(leaves, opt_state))
        return model, opt_state
