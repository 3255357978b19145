"""Token-choice top-k MoE layer, as ``repro.models.moe`` on its mesh-free
path (``moe_layer`` with ``mesh=None``).  The expert-parallel path waits
for ROADMAP Queue 1 step 12 (multi-device).

Routing: a softmax router (logits in the activation dtype, softmax in
fp32), top-k, renormalised gates, the Switch load-balance aux loss, a
fixed per-expert capacity C = ceil(T·k/E·cf) rounded up to a multiple
of 4, and overflow dropping: the (token, choice) pairs take places in
their expert's buffer by a cumulative count in token-major, choice-minor
order, and a pair at place ≥ C is dropped.  Then one gather → (E, C, D),
the SwiGLU expert products as batched matmuls (the reference computes
them as einsums, outside any Pallas kernel), and the combine.

Two places where the port makes the reference's order explicit:

* **Top-k ties.**  ``lax.top_k`` puts the lower expert id first among
  equal probabilities; ``torch.topk`` promises no order.  The port takes
  the first k of a stable descending sort, which keeps the lower id
  first.  The order decides the places in the buffers and so the drops.
* **The combine.**  The reference scatter-adds the expert outputs into
  an fp32 (T, D) buffer.  A scatter-add on the card is a float atomic,
  whose order changes from run to run.  The port gathers each token's k
  outputs (zero for a dropped pair) and sums them in fp32 in a fixed
  order, that of the expert ids: the order in which the reference's
  scatter adds them on the CPU, and two runs give the same bits.

The reference's scatter into the capacity buffers also writes its
placeholder (the zero row, gate 0) into slot (0, 0) for every dropped
pair: it clamps a dropped pair's index to (0, 0), and only an index out
of bounds is dropped.  The last write wins, in the order of the pairs,
as XLA's scatter applies them on the CPU.  So when a dropped pair comes
after the pair in slot (0, 0), that pair is dropped too.  The port keeps
this, so that its drop set is the reference's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.models import layers as L


class MoEParams(nn.Module):
    """``init_moe_params``' tree: ``router`` (d, E) and the expert
    weights ``w1``, ``w3`` (E, d, d_ff) and ``w2`` (E, d_ff, d), fp32,
    requiring grad.

    ``drop_log``: None, or a list to which each :func:`moe_layer` call on
    these weights appends (dropped pairs as a 0-d device tensor, pairs
    routed)."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                            device=device))
        self.router = param(d, e)
        self.w1 = param(e, d, f)
        self.w3 = param(e, d, f)
        self.w2 = param(e, f, d)
        self.drop_log: list | None = None


@torch.no_grad()
def init_moe_params(moe: MoEParams, *, generator: torch.Generator
                    ) -> MoEParams:
    """Fill ``moe`` with ``init_dense`` draws (N(0, shape[0]⁻¹), as the
    reference draws them: E⁻¹ for the expert weights) from
    ``generator``, in the reference's order router, w1, w3, w2."""
    for name in ("router", "w1", "w3", "w2"):
        w = getattr(moe, name)
        w.copy_(L.init_dense(tuple(w.shape), generator=generator,
                             device=w.device))
    return moe


def capacity(tokens_local: int, cfg: ModelConfig) -> int:
    c = math.ceil(tokens_local * cfg.moe_top_k / cfg.num_experts
                  * cfg.capacity_factor)
    return max(4, -(-c // 4) * 4)        # round up to a multiple of 4


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` of each row: the k largest, descending, the lower
    index first among equal values."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


class Routing(NamedTuple):
    """Where the T tokens' k choices go: ``ids`` (T, k) experts in
    choice order, ``gates`` (T, k) fp32 renormalised, ``pos`` (T·k,) the
    place of each pair in its expert's buffer (token-major, choice-minor),
    ``keep`` (T·k,) the pairs that stay (the others are dropped), ``aux``
    the load-balance loss."""

    ids: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor


def route(x: torch.Tensor, p: MoEParams, cfg: ModelConfig, cap: int,
          router: torch.Tensor | None = None) -> Routing:
    """The reference's routing of x (T, D) at capacity ``cap``, by
    ``router`` (the router weights in x's dtype; the cached cast of
    ``p.router`` when None).  The gates and the aux loss carry gradient to
    the router; the ids, places and drops are integers."""
    T = x.shape[0]
    E, k = cfg.num_experts, cfg.moe_top_k
    if router is None:
        router = L.cast_param(p, "router", x.dtype)
    logits = (x @ router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gates, ids = _top_k(probs, k)                              # (T, k)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)

    flat_e = ids.reshape(-1)                                   # (T·k,)
    onehot = F.one_hot(flat_e, E)                              # (T·k, E)
    # Switch-style load-balance aux: E · Σ mean prob · share of choices
    fe = torch.sum(onehot, dim=0).to(torch.float32) / T / k
    aux = E * torch.sum(torch.mean(probs, dim=0) * fe)

    pos = torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=1) - 1
    keep = pos < cap
    # the reference's clamped writes: a dropped pair after the pair in
    # slot (0, 0) overwrites it with the placeholder
    order = torch.arange(T * k, device=x.device)
    last_drop = torch.max(torch.where(keep, -1, order))
    keep = keep & ~((flat_e == 0) & (pos == 0) & (order < last_drop))
    return Routing(ids, gates, pos, keep, aux)


def _moe_local(x: torch.Tensor, p: MoEParams, cfg: ModelConfig, cap: int,
               weight):
    """The reference's ``_moe_local`` over all experts: x (T, D) →
    (combine (T, D) in x's dtype, aux loss fp32 0-d); ``weight(name)``
    gives ``router``, ``w1``, ``w3``, ``w2`` in x's dtype.  Gradient
    reaches the router through the gates, which ``gbuf`` carries into
    the combine, and through the aux loss; a dropped pair's gate is 0
    and gets none."""
    T, D = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    dt = x.dtype
    dev = x.device
    r = route(x, p, cfg, cap, weight("router"))
    flat_e, pos, keep = r.ids.reshape(-1), r.pos, r.keep
    if p.drop_log is not None:
        p.drop_log.append((T * k - keep.sum(), T * k))

    slot = torch.where(keep, flat_e * cap + pos, E * cap)      # E·cap: none
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    buf = torch.full((E * cap + 1,), T, dtype=torch.long, device=dev)
    buf[slot] = torch.where(keep, flat_t, T)   # distinct slots but the last
    gbuf = torch.zeros(E * cap + 1, dtype=torch.float32, device=dev)
    gbuf[slot] = torch.where(keep, r.gates.reshape(-1), 0.0)
    buf, gbuf = buf[:-1].view(E, cap), gbuf[:-1].view(E, cap)

    x_pad = torch.cat([x, torch.zeros((1, D), dtype=dt, device=dev)])
    xg = x_pad[buf]                                            # (E, C, D)
    w1, w3, w2 = (weight(n) for n in ("w1", "w3", "w2"))
    a = torch.bmm(xg, w1)
    h = a * torch.sigmoid(a) * torch.bmm(xg, w3)       # silu as XLA forms it
    out = torch.bmm(h, w2) * gbuf[..., None].to(dt)            # (E, C, D)

    # combine: each token's k outputs in expert-id order, fp32 sums
    out = torch.cat([out.reshape(E * cap, D),
                     torch.zeros((1, D), dtype=dt, device=dev)])
    by_expert = torch.argsort(r.ids, dim=1)        # the k ids are distinct
    picked = out[torch.gather(slot.view(T, k), 1, by_expert)]  # (T, k, D)
    y = torch.zeros((T, D), dtype=torch.float32, device=dev)
    for j in range(k):
        y += picked[:, j].to(torch.float32)
    return y.to(dt), r.aux


def moe_layer(p: MoEParams, x: torch.Tensor, cfg: ModelConfig, *,
              cached: bool = False):
    """MoE FFN over x: (B, S, D) → (y (B, S, D), aux loss), all B·S
    tokens routed together at capacity ``capacity(B·S, cfg)``.  Weights
    are cast to x's dtype through autograd (:func:`L.cast`), as training
    wants, or with ``cached`` (serving) through the cached
    :func:`L.cast_param`."""
    B, S, D = x.shape
    if cached:
        def weight(name):
            return L.cast_param(p, name, x.dtype)
    else:
        def weight(name):
            return L.cast(getattr(p, name), x.dtype)
    y, aux = _moe_local(x.reshape(B * S, D), p, cfg, capacity(B * S, cfg),
                        weight)
    return y.reshape(B, S, D), aux
