"""Plain torch versions of the port's kernels (the semantic definitions).

``flexa_best_response_ref`` is the contract of
:func:`repro_torch.kernels.flexa_prox.best_response`: z bit for bit, e2
up to summation order; ``flexa_apply_ref`` (the FLEXA optimizer's
update), ``flexa_best_response_batched_ref`` and
``flexa_apply_batched_ref`` (steps S.2 and S.4 of the solver's
iteration) are those of ``apply_update``, ``batched_best_response`` and
``batched_apply_update`` there, with the roundings of the code they
replaced written out.
``gather_rows_ref`` / ``scatter_rows_ref`` are the contracts the CUDA
kernels of :mod:`repro_torch.kernels.flexa_prox` meet bit for bit,
written as the reference's ``repro.kernels.ref`` oracle is: an index
with −1 mapped to 0, then ``torch.where``; ``compact_best_response_ref``
(their gather, then ``flexa_best_response_ref``) is that of
``compact_best_response`` there: z bit for bit, e2 up to summation
order.  ``gauss_seidel_sweep_ref`` is the contract of
:mod:`repro_torch.kernels.gauss_seidel` up to the summation order of its
dot products.  ``ssd_scan_ref`` is the
contract of :mod:`repro_torch.kernels.ssd_scan` up to summation order;
``ssd_scan_ragged`` runs it on any S, padded as the reference's
dispatch pads, and ``ssd_scan_bwd`` (autograd of it) is the contract of
``ssd_scan.ssd_scan_bwd`` up to summation order; ``ssd_decode_ref`` is
the single-token step, which has no kernel.  ``flash_attention_ref`` is
the contract of :mod:`repro_torch.kernels.flash_attention` up to
summation order.  The
dispatch (:mod:`repro_torch.kernels.ops`) runs these for tensors on the
CPU only.
"""
from __future__ import annotations

import numpy as np
import torch


def flexa_best_response_ref(x: torch.Tensor, g: torch.Tensor, d, c
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best response + squared error norm for one block tensor.

    z  = prox_{(c/d)·‖·‖₁}(x − g/d)  = soft-threshold,
    e2 = Σ (z − x)²   (the squared error bound Eᵢ²).

    ``d`` is a positive scalar (a float or a 0-d tensor) or a tensor of
    x's shape (the diag-Q case); ``c`` a scalar, 0 disabling the ℓ1 term.
    Computed in fp32 whatever the input dtype.  Both quotients are true
    divisions of fp32 values, as the reference's ``c / d`` with a weakly
    typed ``c`` is: torch's ``float / tensor`` would multiply by a
    reciprocal instead, which rounds differently.
    """
    xf, z = _response(x, g, d, c)
    e2 = torch.sum((z - xf) ** 2)
    return z, e2


def _response(x, g, d, c):
    """(x in fp32, z) of :func:`flexa_best_response_ref`, without e2."""
    f32 = torch.float32
    xf = x.to(f32)
    gf = g.to(f32)
    d = torch.as_tensor(d, dtype=f32, device=x.device)
    w = xf - gf / d
    t = torch.as_tensor(c, dtype=f32, device=x.device) / d
    return xf, torch.sign(w) * torch.clamp_min(torch.abs(w) - t, 0.0)


def flexa_apply_ref(x, g, d, c, gamma_mask, out=None) -> torch.Tensor:
    """Fused damped masked update  x + γ·m·(x̂(x) − x)  in x's dtype.

    The FLEXA optimizer's update term for term: z as
    :func:`flexa_best_response_ref` computes it, then (z − x), then
    · ``gamma_mask`` (γ·mᵢ premultiplied: a float or a 0-d tensor), then
    x +, each rounded in fp32, and the sum rounded once to x's dtype.
    Written into ``out`` (``x`` itself for the optimizer's in-place
    update) when given, else into a new tensor.
    """
    xf, z = _response(x, g, d, c)
    z.sub_(xf).mul_(gamma_mask).add_(xf)
    if out is None:
        return z.to(x.dtype)
    return out.copy_(z)


def _instance_col(v, B: int, name: str):
    """A per-instance scalar as the batched plain versions broadcast it:
    a float or 0-d tensor as it is, a (B,) tensor as a (B, 1) column."""
    if isinstance(v, torch.Tensor) and v.dim() > 0:
        if v.shape != (B,):
            raise ValueError(f"{name} must be a scalar or (B,) = ({B},), "
                             f"got {tuple(v.shape)}")
        return v.reshape(B, 1)
    return v


def _batched_response(x, g, d, c):
    """(x (B, n) in fp32, z (B, n)) of the batched plain versions."""
    f32 = torch.float32
    B = x.shape[0]
    xf = x.reshape(B, -1).to(f32)
    gf = g.reshape(B, -1).to(f32)
    if isinstance(d, torch.Tensor) and d.dim() > 1:
        if d.shape != x.shape:
            raise ValueError(f"dense d must match x {tuple(x.shape)}, got "
                             f"{tuple(d.shape)}")
        d = d.reshape(B, -1)
    else:
        d = _instance_col(torch.as_tensor(d, dtype=f32, device=x.device),
                          B, "d")
    w = xf - gf / d
    t = (1.0 / d) * _instance_col(c, B, "c")
    return xf, torch.sign(w) * torch.clamp_min(torch.abs(w) - t, 0.0)


def flexa_best_response_batched_ref(x, g, d, c
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-instance best response over a (B, ...) bucket → (z fp32 of x's
    shape, e2 (B,)).

    ``d`` is (), (B,) or dense of x's shape; ``c`` a float, a 0-d or a
    (B,) tensor.  The FLEXA solver's step S.2 as it was written in the
    chain (``w = x − g/d``, then the prox at weight (1/d)·c): the
    threshold is the product of the reciprocal and c, not the oracle's
    c / d.  The two differ in the last bit for some d, and the λ-path's
    tolerance sits at the fp32 noise floor, so the solver keeps its own
    rounding (``tests/test_torch_batch_cv.py`` pins the difference).
    """
    xf, z = _batched_response(x, g, d, c)
    e2 = ((z - xf) ** 2).sum(-1)
    return z.reshape(x.shape), e2


def flexa_apply_batched_ref(x, g, d, c, gamma_mask) -> torch.Tensor:
    """Fused batched update  x + γᵢ·mᵢ·(x̂(x) − x)  in x's dtype.

    z as :func:`flexa_best_response_batched_ref` computes it; then the
    solver's step S.4 under the full rule, ``x + γ·(z − x)``, with
    ``gamma_mask`` a float, a 0-d or a (B,) tensor (γᵢ·mᵢ per instance).
    """
    B = x.shape[0]
    xf, z = _batched_response(x, g, d, c)
    new = xf + _instance_col(gamma_mask, B, "gamma_mask") * (z - xf)
    return new.to(x.dtype).reshape(x.shape)


def gather_rows_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[k] = src[idx[k]] for idx[k] ≥ 0, zeros for −1 padding (fp32)."""
    idx = idx.to(torch.int64)
    taken = src.to(torch.float32)[torch.clamp_min(idx, 0)]
    return torch.where((idx >= 0).unsqueeze(-1), taken,
                       torch.zeros((), dtype=torch.float32,
                                   device=src.device))


def scatter_rows_ref(vals: torch.Tensor, inv: torch.Tensor,
                     base: torch.Tensor) -> torch.Tensor:
    """out[i] = vals[inv[i]] where inv[i] ≥ 0, else base[i] (base's dtype).

    A gather of the inverse permutation: each output row is written once.
    """
    inv = inv.to(torch.int64)
    taken = vals[torch.clamp_min(inv, 0)].to(base.dtype)
    return torch.where((inv >= 0).unsqueeze(-1), taken, base)


def compact_best_response_ref(x: torch.Tensor, g: torch.Tensor, d, c,
                              idx: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused gather + best response over the active rows only.

    x, g (N, C) (fp32 or bf16, read as fp32); idx (K,) with −1 padding;
    d a scalar or dense (N, C), gathered through idx; c a scalar.  The
    reference's oracle: gather x and g (pad rows read zeros), give pad
    rows d = 1.0, then :func:`flexa_best_response_ref`.  So a pad row's
    z is exactly 0 and adds nothing to e2.  Returns (z (K, C) fp32, e2
    0-d fp32).
    """
    xc = gather_rows_ref(x, idx)
    gc = gather_rows_ref(g, idx)
    if not isinstance(d, torch.Tensor) or d.dim() == 0:
        dc = d
    else:
        idx = idx.to(torch.int64)
        taken = d.to(torch.float32)[torch.clamp_min(idx, 0)]
        dc = torch.where((idx >= 0).unsqueeze(-1), taken,
                         torch.ones((), dtype=torch.float32,
                                    device=d.device))
    return flexa_best_response_ref(xc, gc, dc, c)


def gauss_seidel_sweep_ref(At: torch.Tensor, colsq: torch.Tensor,
                           x: torch.Tensor, r: torch.Tensor, c
                           ) -> torch.Tensor:
    """One cyclic Gauss-Seidel sweep of the Lasso, in place; → max |δ|.

    For i = 0 … n−1, against the residual r = Ax − b as the earlier
    coordinates left it:

        gᵢ = 2·aᵢᵀr,  dᵢ = 2·colsqᵢ,  zᵢ = soft(xᵢ − gᵢ/dᵢ, c/dᵢ),
        δ = zᵢ − xᵢ,  r ← r + aᵢ·δ,  xᵢ ← zᵢ

    (the body of the reference's ``lax.fori_loop``,
    ``src/repro/baselines/gauss_seidel.py:37-50``).  ``At`` is Aᵀ, (n, m)
    (row i is column aᵢ), ``colsq`` the floored ‖aᵢ‖² (n,), x (n,) and r
    (m,) fp32, updated in place; ``c`` a float.  Both quotients are true
    fp32 divisions.  Returns max |δ| over the sweep as a 0-d fp32 tensor
    (NaN if any δ is NaN, as ``jnp.maximum``).  An eager loop of a few
    torch calls per coordinate: the plain version, for the CPU.
    """
    f32 = torch.float32
    ct = torch.as_tensor(c, dtype=f32, device=x.device)
    max_delta = torch.zeros((), dtype=f32, device=x.device)
    for i in range(At.shape[0]):
        a = At[i]
        xi = x[i]
        d = 2.0 * colsq[i]
        w = xi - (2.0 * torch.dot(a, r)) / d
        z = torch.sign(w) * torch.clamp_min(torch.abs(w) - ct / d, 0.0)
        delta = z - xi
        r.add_(a * delta)
        x[i] = z
        max_delta = torch.maximum(max_delta, torch.abs(delta))
    return max_delta


def attention_scale(D: int) -> float:
    """The default softmax scale D^-½ as the reference's oracle forms it:
    an fp32 division of 1 by the fp32 square root of D."""
    return float(np.float32(1.0) / np.sqrt(np.float32(D)))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale=None) -> torch.Tensor:
    """Naive O(S²) masked softmax attention — the oracle.

    q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with Hq % Hkv == 0.  Scores
    and softmax in fp32, GQA by repeating k and v, queries aligned to the
    end of the keys (offset Skv − Sq) under the causal mask; output cast
    back to q's dtype.  The score matrix is updated in place, so a call
    holds about two (B, Hq, Sq, Skv) fp32 tensors at its peak.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    if scale is None:
        scale = attention_scale(D)
    f32 = torch.float32
    kf = torch.repeat_interleave(k, rep, dim=1).to(f32)
    vf = torch.repeat_interleave(v, rep, dim=1).to(f32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), kf)
    logits.mul_(scale)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device=q.device)[None, :]
        logits.masked_fill_(kpos > qpos, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    del logits
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def ssd_scan_ref(x, dt, A, B, C, *, chunk: int = 64):
    """State-space dual (SSD) recurrence, chunked.

    Per head (state N, head dim P), with A < 0:
        h_t = exp(dt_t·A)·h_{t−1} + dt_t·(B_t ⊗ x_t),   y_t = C_tᵀ h_t

    x (Bt, S, H, P), dt (Bt, S, H), A (H,), B and C (Bt, S, N) (one
    B/C group); S a multiple of ``chunk``.  Returns y (Bt, S, H, P) in
    x's dtype and the final state h (Bt, H, N, P) fp32.

    The algebra of the reference's ``ref.ssd_scan_ref`` (intra-chunk
    quadratic term, per-chunk states, a scan over chunks), with one
    difference: the decay mask exp(s_t − s_u) is formed only for u ≤ t,
    as the TPU kernel forms it (``jnp.where`` before the product).  The
    reference's oracle multiplies exp(s_t − s_u) by the triangle after
    the exp; for u > t the exponent is positive, overflows to inf at
    chunk 256 with A = −16, and inf · 0 gives NaN there.
    """
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc = S // chunk
    f32 = torch.float32
    xf = x.to(f32).reshape(Bt, nc, chunk, H, P)
    dtf = dt.to(f32).reshape(Bt, nc, chunk, H)
    Bf = B.to(f32).reshape(Bt, nc, chunk, N)
    Cf = C.to(f32).reshape(Bt, nc, chunk, N)

    s = torch.cumsum(dtf * A.to(f32), dim=2)        # (Bt, nc, L, H)
    s_last = s[:, :, -1:, :]

    G = torch.einsum("bctn,bcun->bctu", Cf, Bf)     # (Bt, nc, L, L)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[:, :, None]
    diff = s[:, :, :, None, :] - s[:, :, None, :, :]  # (Bt, nc, L, L, H)
    M = torch.exp(diff.masked_fill(~tri, float("-inf")))   # 0 for u > t
    W = G[..., None] * M * dtf[:, :, None, :, :]
    y_intra = torch.einsum("bctuh,bcuhp->bcthp", W, xf)

    decay_u = torch.exp(s_last - s)                 # exp(s_L − s_u)
    Hc = torch.einsum("bcuh,bcun,bcuhp->bchnp", decay_u * dtf, Bf, xf)
    chunk_decay = torch.exp(s_last[:, :, 0, :])     # (Bt, nc, H)
    h = torch.zeros((Bt, H, N, P), dtype=f32, device=x.device)
    h_prevs = []
    for c in range(nc):                             # state before chunk c
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + Hc[:, c]
    h_prev = torch.stack(h_prevs, dim=1)            # (Bt, nc, H, N, P)

    y_inter = torch.einsum("bctn,bchnp->bcthp", Cf, h_prev) \
        * torch.exp(s)[..., None]
    y = (y_intra + y_inter).reshape(Bt, S, H, P)
    return y.to(x.dtype), h


def ssd_scan_ragged(x, dt, A, B, C, *, chunk: int):
    """:func:`ssd_scan_ref` on any S: padded to a chunk multiple with
    dt = 0 — algebraically inert: the decay exp(0·A) = 1 keeps the state
    and the update dt·(B ⊗ x) = 0 adds nothing — and y cut back to S, as
    the reference's ``ops.ssd_scan`` does."""
    S = x.shape[1]
    pad = (-S) % chunk
    if not pad:
        return ssd_scan_ref(x, dt, A, B, C, chunk=chunk)

    def padw(t):
        return torch.nn.functional.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])
    y, h = ssd_scan_ref(padw(x), padw(dt), A, padw(B), padw(C), chunk=chunk)
    return y[:, :S], h


def ssd_scan_bwd(x, dt, A, B, C, dy, dh_final=None, *, chunk: int):
    """Gradients of :func:`ssd_scan_ragged` → (dx, ddt, dA, dB, dC), by
    ``torch.autograd``, given dy (the gradient of y, in x's dtype) and
    ``dh_final`` (of the final state, fp32; None for zero).  dx, dB, dC
    come back in the inputs' dtype, ddt and dA in fp32.  The forward
    masks the decay with −inf before the exp, so the gradients stay
    finite where exp(s_t − s_u), u > t, would overflow (chunk 256,
    A = −16)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
        y, h = ssd_scan_ragged(*ins, chunk=chunk)
        outs, grads = [y], [dy.to(y.dtype)]
        if dh_final is not None:
            outs.append(h)
            grads.append(dh_final.to(h.dtype))
        return torch.autograd.grad(outs, ins, grads)


def ssd_decode_ref(x_t, dt_t, A, B_t, C_t, h):
    """Single-token SSD update (serving path).

    x_t (Bt, H, P), dt_t (Bt, H), B_t and C_t (Bt, N), h (Bt, H, N, P)
    fp32.  Returns y_t (Bt, H, P) in x_t's dtype and the new state.
    """
    f32 = torch.float32
    a = torch.exp(dt_t.to(f32) * A[None, :])                    # (Bt, H)
    upd = torch.einsum("bn,bhp->bhnp", B_t.to(f32),
                       x_t.to(f32) * dt_t[..., None])
    h_new = a[:, :, None, None] * h + upd
    y = torch.einsum("bn,bhnp->bhp", C_t.to(f32), h_new)
    return y.to(x_t.dtype), h_new
