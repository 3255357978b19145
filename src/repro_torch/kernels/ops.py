"""Kernel dispatch: the CUDA kernel for a tensor on the card, the plain
torch version for a tensor on the CPU, as ``repro.kernels.ops`` does.

The device of the data decides, and nothing else: there is no switch
that sends a CUDA tensor to the plain version, and a kernel that fails
to build or launch raises.  Index arrays are validated here (entries in
[−1, rows)) before the kernel sees them, on the host when they come from
the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flexa_prox as _fp
from repro_torch.kernels import gauss_seidel as _gs
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd


def _index(idx, n_rows: int, name: str, device) -> torch.Tensor:
    """``idx`` as a contiguous int32 tensor on ``device``, every entry in
    [−1, n_rows) (checked where the array lives: one read-back for an
    index already on the card)."""
    if not isinstance(idx, torch.Tensor):
        idx = torch.as_tensor(np.asarray(idx))
    if idx.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got shape {tuple(idx.shape)}")
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < -1 or hi >= n_rows:
            raise IndexError(f"{name} entries must lie in [-1, {n_rows}); "
                             f"got [{lo}, {hi}]")
    return idx.to(device=device, dtype=torch.int32).contiguous()


def _on(device: torch.device, *tensors) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensors on {t.device} and {device}")


def flexa_best_response(x: torch.Tensor, g: torch.Tensor, d, c):
    """z = soft(x − g/d, c/d) in fp32, e2 = Σ(z−x)².  Any-shape tensors.

    ``d`` a scalar (float or 0-d tensor) or a tensor of x's shape; ``c`` a
    host float.  On the card a float ``d`` is copied there first (the
    optimizer passes τᵢ as a 0-d tensor already on the card, so it never
    syncs), and x, g are made contiguous for the kernel.
    """
    _on(x.device, g)
    if x.device.type == "cpu":
        return ref.flexa_best_response_ref(x, g, d, c)
    if x.device.type == "cuda":
        return _fp.best_response(x.contiguous(), g.contiguous(),
                                 _on_card(d, x.device), float(c))
    raise ValueError(f"no best_response kernel for device {x.device}")


def _on_card(v, device) -> torch.Tensor:
    """A float or tensor argument as a contiguous tensor on ``device`` (a
    float is copied there as fp32: callers on a hot path pass tensors
    already on the card, so nothing syncs)."""
    if not isinstance(v, torch.Tensor):
        return torch.tensor(float(v), dtype=torch.float32, device=device)
    _on(device, v)
    return v.contiguous()


def _weight(c, device):
    """c of a batched call: a host float as it is (the kernel takes it by
    value, so a captured solver iteration copies nothing), a tensor on
    ``device``."""
    return _on_card(c, device) if isinstance(c, torch.Tensor) else float(c)


def flexa_apply(x: torch.Tensor, g: torch.Tensor, d, c, gamma_mask, *,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """x + γ·m·(x̂(x) − x) fused, in x's dtype, x̂ = soft(x − g/d, c/d).

    ``gamma_mask`` is γ·mᵢ premultiplied (a float or a 0-d tensor), ``d``
    a scalar or a tensor of x's shape, ``c`` a host float.  The result
    goes into ``out`` (``x`` itself for the optimizer's in-place update),
    or a new tensor when None.
    """
    _on(x.device, g)
    if x.device.type == "cpu":
        return ref.flexa_apply_ref(x, g, d, c, gamma_mask, out=out)
    if x.device.type == "cuda":
        return _fp.apply_update(x.contiguous(), g.contiguous(),
                                _on_card(d, x.device), float(c),
                                _on_card(gamma_mask, x.device), out=out)
    raise ValueError(f"no apply_update kernel for device {x.device}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A (B, ...) bucket as contiguous (B, n) rows (the tensor itself when
    it already is)."""
    if t.dim() == 2 and t.is_contiguous():
        return t
    return t.contiguous().reshape(t.shape[0], -1)


def _batched_d(d, x: torch.Tensor) -> torch.Tensor:
    d = _on_card(d, x.device)
    return _rows(d) if d.dim() > 1 else d


def flexa_best_response_batched(x: torch.Tensor, g: torch.Tensor, d, c):
    """Per-instance z = soft(x − g/d, (1/d)·c) and e2 over a (B, ...)
    bucket → (z fp32 of x's shape, e2 (B,)).

    ``d`` a scalar, (B,) or dense of x's shape; ``c`` a float or a 0-d or
    (B,) tensor — each instance of a bucket carries its own weight.  The
    threshold rounds as the solver's step S.2 does (see
    :func:`repro_torch.kernels.ref.flexa_best_response_batched_ref`).  No
    column padding: the CUDA kernel masks a ragged n itself.
    """
    dev = x.device
    _on(dev, g)
    if dev.type == "cpu":
        return ref.flexa_best_response_batched_ref(x, g, d, c)
    if dev.type == "cuda":
        z, e2 = _fp.batched_best_response(_rows(x), _rows(g),
                                          _batched_d(d, x), _weight(c, dev))
        return (z if x.dim() == 2 else z.view(x.shape)), e2
    raise ValueError(f"no batched_best_response kernel for device "
                     f"{x.device}")


def flexa_apply_batched(x: torch.Tensor, g: torch.Tensor, d, c,
                        gamma_mask) -> torch.Tensor:
    """Fused batched update x + γᵢ·mᵢ·(x̂ − x) over a (B, ...) bucket, in
    x's dtype; x̂ as :func:`flexa_best_response_batched` computes it and
    ``gamma_mask`` a float or a 0-d or (B,) tensor."""
    dev = x.device
    _on(dev, g)
    if dev.type == "cpu":
        return ref.flexa_apply_batched_ref(x, g, d, c, gamma_mask)
    if dev.type == "cuda":
        out = _fp.batched_apply_update(_rows(x), _rows(g), _batched_d(d, x),
                                       _weight(c, dev),
                                       _on_card(gamma_mask, dev))
        return out if x.dim() == 2 else out.view(x.shape)
    raise ValueError(f"no batched_apply_update kernel for device "
                     f"{x.device}")


def gather_blocks(src: torch.Tensor, idx) -> torch.Tensor:
    """Row gather: out[k] = src[idx[k]] (−1 ⇒ zero row), fp32.  src (N, C)."""
    idx = _index(idx, src.shape[0], "idx", src.device)
    if src.device.type == "cpu":
        return ref.gather_rows_ref(src, idx)
    if src.device.type == "cuda":
        return _fp.gather_rows(src.contiguous(), idx)
    raise ValueError(f"no gather_rows kernel for device {src.device}")


def scatter_blocks(vals: torch.Tensor, inv, base: torch.Tensor
                   ) -> torch.Tensor:
    """Inverse-permutation scatter: out[i] = vals[inv[i]] or base[i]."""
    _on(base.device, vals)
    inv = _index(inv, vals.shape[0], "inv", base.device)
    if base.device.type == "cpu":
        return ref.scatter_rows_ref(vals, inv, base)
    if base.device.type == "cuda":
        return _fp.scatter_rows(vals.contiguous(), inv, base.contiguous())
    raise ValueError(f"no scatter_rows kernel for device {base.device}")


def compact_best_response(x: torch.Tensor, g: torch.Tensor, d, c, idx):
    """Fused gather + best response over the rows ``idx`` picks (−1 ⇒ a
    pad row: z 0, nothing to e2) → (z (K, C) fp32, e2 0-d fp32).

    x, g (N, C); ``d`` a scalar or dense (N, C), gathered through idx;
    ``c`` a host float.  No path calls it: the reference's compacted path
    solves in compact space, with no gather per iteration.
    """
    _on(x.device, g)
    idx = _index(idx, x.shape[0], "idx", x.device)
    if x.device.type == "cpu":
        return ref.compact_best_response_ref(x, g, d, c, idx)
    if x.device.type == "cuda":
        return _fp.compact_best_response(x.contiguous(), g.contiguous(),
                                         _on_card(d, x.device), float(c),
                                         idx)
    raise ValueError(f"no compact_best_response kernel for device "
                     f"{x.device}")


def gauss_seidel_sweep(At: torch.Tensor, colsq: torch.Tensor,
                       x: torch.Tensor, r: torch.Tensor, c) -> torch.Tensor:
    """One cyclic Gauss-Seidel sweep of the Lasso over x's n coordinates,
    x and r = Ax − b updated in place → max |δ| (0-d fp32).

    ``At`` is Aᵀ (n, m), ``colsq`` the floored ‖aᵢ‖² (n,); ``c`` the ℓ1
    weight.  On the card one launch of the CUDA kernel; on the CPU the
    eager per-coordinate loop of the plain version.
    """
    _on(x.device, At, colsq, r)
    if x.device.type == "cpu":
        return ref.gauss_seidel_sweep_ref(At, colsq, x, r, c)
    if x.device.type == "cuda":
        return _gs.gauss_seidel_sweep(At, colsq, x, r, float(c))
    raise ValueError(f"no gauss_seidel_sweep kernel for device {x.device}")


class _SSDScan(torch.autograd.Function):
    """The CUDA scan under autograd: the forward kernel, which keeps its
    scratch (the state entering every chunk and the chunks' cumsums), and
    the backward kernel, which reads it."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, h, scratch = _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                      keep_scratch=True)
        ctx.save_for_backward(x, dt, A, B, C, scratch)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, B, C, scratch = ctx.saved_tensors
        grads = _ssd.ssd_scan_bwd(x, dt, A, B, C, dy, dh, chunk=ctx.chunk,
                                  scratch=scratch)
        return (*grads, None)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64):
    """Mamba2 SSD chunked scan → (y in x's dtype, final state fp32).

    Shapes as in :func:`repro_torch.kernels.ref.ssd_scan_ref`; S need
    not be a multiple of ``chunk``: the plain version pads with dt = 0
    as the reference does (:func:`~repro_torch.kernels.ref.ssd_scan_ragged`),
    and the CUDA kernel masks the ragged chunk itself.

    Differentiable: on the CPU autograd differentiates the plain version;
    on the card the scan runs through :class:`_SSDScan` (the CUDA
    forward, then the CUDA ``ssd_scan_bwd``), which without grad
    (serving, ``inference_mode``) records nothing and is the forward's
    one launch.
    """
    _on(x.device, dt, A, B, C)
    if x.device.type == "cpu":
        return ref.ssd_scan_ragged(x, dt, A, B, C, chunk=chunk)
    if x.device.type == "cuda":
        return _SSDScan.apply(x, dt, A, B, C, chunk)
    raise ValueError(f"no ssd_scan kernel for device {x.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale=None) -> torch.Tensor:
    """Causal (or not) GQA attention → (B, Hq, Sq, D) in q's dtype.

    q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D); queries aligned to the end
    of the keys.  A causal call with Sq > Skv raises on every device:
    there the oracle's first rows see no key (NaN) and the kernel's
    would be 0.  The TPU's ``block_q`` / ``block_k`` are not part of the
    interface: the CUDA kernel chooses its own tiles.
    """
    _on(q.device, k, v)
    if q.device.type == "cpu":
        _fa.check_shapes(q, k, v, causal)
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type == "cuda":                 # the wrapper checks shapes
        return _fa.flash_attention(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"no flash_attention kernel for device {q.device}")


def ssd_decode(x_t, dt_t, A, B_t, C_t, h):
    """Single-token SSD step: plain torch on every device (a few small
    products; the reference has no kernel for it)."""
    return ref.ssd_decode_ref(x_t, dt_t, A, B_t, C_t, h)
