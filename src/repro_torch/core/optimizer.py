"""FLEXA as a large-model training optimizer, as ``repro.core.optimizer``
(the paper's Algorithm 1 with parameter *leaves* as blocks), and the
AdamW baseline.

Mapping, as in the reference:

* block xᵢ     = one leaf of the reference's parameter tree.  The port
                 keeps one tensor per layer, so a layer leaf (the 32
                 layers' ``wq``) is a :class:`~repro_torch.models.
                 transformer.Leaf` of 32 tensors: it has one τᵢ, one
                 Eᵢ² = Σ over its tensors, in layer order, of Σ(z − x)²,
                 and is selected or dropped as a whole;
* best response = x̂ᵢ = prox_{g/dᵢ}(xᵢ − ∇ᵢF/dᵢ), dᵢ = τᵢ·qᵢ, computed per
                 tensor by :func:`repro_torch.kernels.ops.
                 flexa_best_response` (the CUDA kernel on the card);
* Eᵢ           = ‖x̂ᵢ − xᵢ‖₂;  Sᵏ = greedy ρ-rule over leaves (or all);
* γᵏ           = Eq. (4);  τ = the §4 double/halve controller on the loss.

``update(grads, state, params, loss)`` takes ``params`` as a list of
leaves and ``grads`` as the matching list of lists of tensors, and
writes the new values into the parameters in place under
``torch.no_grad()`` (the reference returns new arrays; updating in place
saves a copy of the model), returning ``(params, new_state, metrics)``.
Nothing in it reads a value back to the host: τ, γ, the mask and every
Eᵢ² stay on the device, and the kernels read τᵢ and γ·mᵢ through device
pointers.  Where the reference keeps every zᵢ until the mask is known
(one fp32 copy of the model), the port keeps only each tensor's Eᵢ²:
once the mask is known it updates each tensor with
:func:`repro_torch.kernels.ops.flexa_apply` (the fused ``apply_update``
kernel on the card), which recomputes zᵢ in registers and rounds as
x + γ·mᵢ·(zᵢ − x) did when zᵢ was kept.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.config.base import TrainConfig
from repro_torch.core import stepsize
from repro_torch.kernels import ops as kops


class FlexaOptState(NamedTuple):
    gamma: torch.Tensor         # scalar γᵏ
    tau: torch.Tensor           # (n_blocks,) per-leaf τᵢ
    v_prev: torch.Tensor        # previous loss (τ controller)
    consec_dec: torch.Tensor
    n_tau_changes: torch.Tensor
    step: torch.Tensor
    q_ema: Any                  # grad² EMA, per leaf a list of tensors (or None)


MAX_TAU_CHANGES = 60


def path_name(path: tuple) -> str:
    """The reference's path string, ``"/".join(str(DictKey))``:
    ``("layers", "ln1")`` → ``"['layers']/['ln1']"``."""
    return "/".join(f"['{k}']" for k in path)


def _l1_mask(path: tuple) -> bool:
    """ℓ1 regularization applies to weight matrices, not embeddings/norms.

    The reference's rule on its path string, kept as it is: ``embed`` and
    ``final_norm`` are excluded, and so is nothing else — the layer norms
    ``ln1``/``ln2`` contain none of the words and get ℓ1.
    """
    name = path_name(path).lower()
    return not any(s in name for s in ("embed", "norm", "scale", "bias"))


def _d(tau_i: torch.Tensor, qs, j: int):
    """dᵢ of a leaf's j-th tensor: τᵢ, or τᵢ·qᵢ with diag-Q."""
    return tau_i if qs is None else tau_i * qs[j]


def _zeros_like_leaves(params) -> list:
    return [[torch.zeros_like(x, dtype=torch.float32) for x in leaf.tensors]
            for leaf in params]


def flexa_optimizer(cfg: TrainConfig):
    """Returns (init_fn, update_fn).

    ``update_fn(grads, state, params, loss)`` → (params, new_state,
    metrics), the parameters updated in place.  The loss (a 0-d device
    tensor) drives the §4 τ-controller.
    """

    def init(params) -> FlexaOptState:
        dev = params[0].tensors[0].device
        f32, i32 = torch.float32, torch.int32
        return FlexaOptState(
            gamma=torch.tensor(cfg.flexa_gamma0, dtype=f32, device=dev),
            tau=torch.full((len(params),), cfg.flexa_tau0, dtype=f32,
                           device=dev),
            v_prev=torch.tensor(float("inf"), dtype=f32, device=dev),
            consec_dec=torch.tensor(0, dtype=i32, device=dev),
            n_tau_changes=torch.tensor(0, dtype=i32, device=dev),
            step=torch.tensor(0, dtype=i32, device=dev),
            q_ema=_zeros_like_leaves(params) if cfg.flexa_diag_q else None,
        )

    @torch.no_grad()
    def update(grads, state: FlexaOptState, params, loss):
        # Optional diagonal Qᵢ (A6-compliant: q ≥ q_min > 0 uniformly).
        if cfg.flexa_diag_q:
            new_q_ema = [[0.99 * q + 0.01 * (g.to(torch.float32) ** 2)
                          for q, g in zip(qs, gs)]
                         for qs, gs in zip(state.q_ema, grads)]
            bias = 1.0 - 0.99 ** (state.step.to(torch.float32) + 1.0)
            leaves_q = [[torch.sqrt(q / bias) + 1e-8 for q in qs]
                        for qs in new_q_ema]
        else:
            new_q_ema = None
            leaves_q = [None] * len(params)

        # Per-tensor best response; Eᵢ² summed over the leaf's tensors,
        # each z dropped at once.
        cs, Es = [], []
        for i, (leaf, gs, qs) in enumerate(zip(params, grads, leaves_q)):
            tau_i = state.tau[i]
            c = cfg.flexa_l1 if (cfg.flexa_l1 > 0 and _l1_mask(leaf.path)) \
                else 0.0
            e2 = None
            for j, (x, g) in enumerate(zip(leaf.tensors, gs)):
                _, e = kops.flexa_best_response(x, g, _d(tau_i, qs, j), c)
                e2 = e if e2 is None else e2 + e
            cs.append(c)
            Es.append(e2)
        E = torch.sqrt(torch.stack(Es))              # ‖x̂ᵢ−xᵢ‖₂ per leaf
        M = torch.max(E)

        if cfg.flexa_select == "all":
            mask = torch.ones_like(E)
        else:
            mask = (E >= cfg.flexa_rho * M).to(E.dtype)

        # x + (γ·maskᵢ)·(z − x) into the parameter, z recomputed.
        gamma = state.gamma
        for i, (leaf, gs, qs) in enumerate(zip(params, grads, leaves_q)):
            gm = gamma * mask[i]
            for j, (x, g) in enumerate(zip(leaf.tensors, gs)):
                kops.flexa_apply(x, g, _d(state.tau[i], qs, j), cs[i], gm,
                                 out=x)
        del leaves_q

        # §4 τ-controller on the training loss (finite-change budget).
        can = state.n_tau_changes < MAX_TAU_CHANGES
        adapt = bool(cfg.flexa_tau_adapt)
        loss = loss.detach().to(torch.float32)
        up = loss > state.v_prev
        increased = up & can & adapt
        consec = torch.where(up, 0, state.consec_dec + 1)
        halve = (consec >= 10) & can & adapt
        tau = torch.where(increased, state.tau * 2.0, state.tau)
        tau = torch.where(halve, tau * 0.5, tau)
        consec = torch.where(halve, 0, consec)
        nch = state.n_tau_changes + increased.to(torch.int32) \
            + halve.to(torch.int32)

        new_state = FlexaOptState(
            gamma=stepsize.gamma_next(gamma, cfg.flexa_theta),
            tau=tau, v_prev=loss, consec_dec=consec, n_tau_changes=nch,
            step=state.step + 1, q_ema=new_q_ema)
        metrics = {"flexa/E_max": M, "flexa/sel_frac": torch.mean(mask),
                   "flexa/gamma": gamma, "flexa/tau_mean": torch.mean(tau)}
        return params, new_state, metrics

    return init, update


# --------------------------------------------------------------------- #
# AdamW baseline (the non-paper optimizer the examples compare against). #
# --------------------------------------------------------------------- #
class AdamWState(NamedTuple):
    mu: Any                     # per leaf, a list of fp32 tensors
    nu: Any
    step: torch.Tensor


def adamw_optimizer(cfg: TrainConfig):
    b1, b2 = cfg.betas
    eps = 1e-8

    def init(params) -> AdamWState:
        dev = params[0].tensors[0].device
        return AdamWState(mu=_zeros_like_leaves(params),
                          nu=_zeros_like_leaves(params),
                          step=torch.tensor(0, dtype=torch.int32, device=dev))

    @torch.no_grad()
    def update(grads, state: AdamWState, params, loss):
        del loss
        t = state.step + 1
        tf = t.to(torch.float32)
        mus, nus = [], []
        for leaf, gs, ms, vs in zip(params, grads, state.mu, state.nu):
            mus.append([])
            nus.append([])
            for x, g, m, v in zip(leaf.tensors, gs, ms, vs):
                g = g.to(torch.float32)
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                mhat = m / (1 - b1 ** tf)
                vhat = v / (1 - b2 ** tf)
                xf = x.to(torch.float32)
                step = cfg.lr * (mhat / (torch.sqrt(vhat) + eps)
                                 + cfg.weight_decay * xf)
                x.copy_(xf - step)
                mus[-1].append(m)
                nus[-1].append(v)
        return params, AdamWState(mu=mus, nu=nus, step=t), {}

    return init, update


def get_optimizer(cfg: TrainConfig):
    if cfg.optimizer == "flexa":
        return flexa_optimizer(cfg)
    if cfg.optimizer == "adamw":
        return adamw_optimizer(cfg)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
