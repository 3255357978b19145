"""Checkpointing, as ``repro.checkpoint.ckpt``: atomic, async-capable,
in the reference's on-disk format, so a directory written by either
package resumes in the other.

Format: one directory per step —

    <dir>/step_00000123/
        manifest.json       # leaf names, shapes, dtypes, step, wall time
        leaf_NNNNN.npy      # one file per leaf of the reference's pytree
    <dir>/LATEST            # atomically-renamed pointer file

The leaves are those of the reference's ``(params, opt_state)`` tree in
its ``tree_flatten`` order (:func:`train_state_arrays`): the parameter
leaves (a layer leaf stacked over the layers on axis 0), then
``FlexaOptState`` as gamma, tau, v_prev, consec_dec, n_tau_changes,
step[, the q_ema leaves], or ``AdamWState`` as mu…, nu…, step.

* **Atomicity** — writes land in ``step_X.tmp`` and are renamed only
  after the manifest fsync; ``LATEST`` is swapped by a rename.
* **Async** — ``save_async`` takes arrays already on the host (the copy
  off the card is the blocking part, done by the caller) and writes them
  in a background thread.
* **Retention** — the ``keep`` most recent checkpoints are retained,
  older ones reaped after a successful write (never before).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.optimizer import AdamWState, FlexaOptState


def _leaf_names(n: int):
    return [f"leaf_{i:05d}" for i in range(n)]


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- #
    def save(self, step: int, arrays: list) -> Path:
        """Blocking atomic save of host ``arrays`` (numpy, in order)."""
        return self._write(step, [np.asarray(a) for a in arrays])

    def save_async(self, step: int, arrays: list) -> None:
        """Write host ``arrays`` in a background thread."""
        self.wait()
        host = [np.asarray(a) for a in arrays]
        self._thread = threading.Thread(
            target=self._write, args=(step, host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        names = _leaf_names(len(host_leaves))
        for name, arr in zip(names, host_leaves):
            np.save(tmp / f"{name}.npy", arr)
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": [{"name": n, "shape": list(a.shape),
                        "dtype": str(a.dtype)}
                       for n, a in zip(names, host_leaves)],
        }
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                       # atomic publish
        latest_tmp = self.dir / "LATEST.tmp"
        latest_tmp.write_text(final.name)
        latest_tmp.rename(self.dir / "LATEST")  # atomic pointer swap
        self._gc()
        return final

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_????????"))
        for old in ckpts[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(old, ignore_errors=True)

    # ------------------------------------------------------------- #
    def latest_step(self) -> int | None:
        ptr = self.dir / "LATEST"
        if not ptr.exists():
            return None
        name = ptr.read_text().strip()
        if not (self.dir / name / "manifest.json").exists():
            # pointer ahead of a reaped/corrupt dir: fall back to scan
            ckpts = sorted(self.dir.glob("step_????????"))
            if not ckpts:
                return None
            name = ckpts[-1].name
        return int(name.split("_")[1])

    def restore(self, shapes: list, step: int | None = None):
        """The arrays of checkpoint ``step`` (the latest by default), as
        numpy, checked against the expected ``shapes`` (one per leaf, in
        order) → (arrays, step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        out = []
        for name, shape in zip(_leaf_names(len(shapes)), shapes):
            arr = np.load(path / f"{name}.npy")
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(
                    f"checkpoint leaf {name} shape {arr.shape} != "
                    f"expected {tuple(shape)}")
            out.append(arr)
        return out, step


# ----------------------------------------------------------------- #
# The training state as the reference's (params, opt_state) leaves   #
# ----------------------------------------------------------------- #
def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").numpy()


def _grouped(leaves, groups) -> list:
    """Per-leaf tensor lists (``groups``) as host arrays, a stacked leaf's
    tensors stacked on axis 0."""
    return [np.stack([_host(t) for t in ts]) if leaf.stacked
            else _host(ts[0]) for leaf, ts in zip(leaves, groups)]


def _opt_groups(opt_state) -> tuple[list, list]:
    """(scalars and vectors, per-leaf tensor groups) of an optimizer
    state, in the reference's flatten order."""
    if isinstance(opt_state, FlexaOptState):
        head = [opt_state.gamma, opt_state.tau, opt_state.v_prev,
                opt_state.consec_dec, opt_state.n_tau_changes,
                opt_state.step]
        return head, list(opt_state.q_ema or [])
    if isinstance(opt_state, AdamWState):
        return [], list(opt_state.mu) + list(opt_state.nu)
    raise TypeError(f"unknown optimizer state {type(opt_state).__name__}")


def train_state_arrays(params, opt_state) -> list[np.ndarray]:
    """Host copies of every leaf of ``(params, opt_state)``, in the
    reference's order.  ``params`` is the list of
    :class:`~repro_torch.models.transformer.Leaf`."""
    head, groups = _opt_groups(opt_state)
    out = _grouped(params, [leaf.tensors for leaf in params])
    out += [_host(t) for t in head]
    # q_ema has one group per leaf, AdamW's mu then nu two
    out += _grouped(params * 2, groups)
    if isinstance(opt_state, AdamWState):
        out.append(_host(opt_state.step))
    return out


def train_state_shapes(params, opt_state) -> list[tuple]:
    """The shape of each leaf :func:`train_state_arrays` writes."""
    def shape(leaf, ts):
        s = tuple(ts[0].shape)
        return (len(ts),) + s if leaf.stacked else s
    head, groups = _opt_groups(opt_state)
    shapes = [shape(leaf, leaf.tensors) for leaf in params]
    shapes += [tuple(t.shape) for t in head]
    shapes += [shape(leaf, ts) for leaf, ts in zip(params * 2, groups)]
    if isinstance(opt_state, AdamWState):
        shapes.append(tuple(opt_state.step.shape))
    return shapes


@torch.no_grad()
def load_train_state(arrays: list, params, opt_state):
    """Copy checkpoint ``arrays`` into the parameters (in place) and
    return the optimizer state they hold, on the parameters' device, in
    ``opt_state``'s type and dtypes."""
    it = iter(arrays)

    def put_group(leaf, ts):
        arr = next(it)
        for li, t in enumerate(ts):
            t.copy_(torch.from_numpy(np.array(arr[li] if leaf.stacked
                                              else arr)))

    for leaf in params:
        put_group(leaf, leaf.tensors)
    head, groups = _opt_groups(opt_state)

    def tensor_like(ref):
        return torch.from_numpy(np.array(next(it))).to(
            device=ref.device, dtype=ref.dtype)

    fields = [tensor_like(t) for t in head]
    for leaf, ts in zip(params * 2, groups):
        put_group(leaf, ts)
    if isinstance(opt_state, FlexaOptState):
        return FlexaOptState(*fields, q_ema=opt_state.q_ema)
    return opt_state._replace(step=tensor_like(opt_state.step))
