"""Mamba2 (SSD) mixer, as ``repro.models.ssm``.

in_proj → [z | x | B | C | dt], causal depthwise conv on (x, B, C), the
SSD scan (:func:`repro_torch.kernels.ops.ssd_scan`: the CUDA kernel on
the card, plain torch on the host), per-head D skip, gated RMSNorm
(y ⊙ silu(z)), out_proj.  Single B/C group (ngroups = 1, the published
1.3b setting).  Decode keeps a (conv, ssm) state pair per layer: O(1)
per token.

:class:`SSMMixer` holds the reference's parameter dict as fp32
parameters of the same names and shapes (``w_in``/``w_out`` in the
reference's (in, out) layout), all requiring grad; :func:`ssm_layer`
and :func:`ssm_decode` are the reference's functions, with the mixer in
place of the dict.  :func:`ssm_layer` is the training forward: it casts
``w_in`` and ``w_out`` through autograd (:func:`L.cast`), and its scan
is differentiable (on the card the CUDA ``ssd_scan`` forward and its
CUDA backward).  Serving's :func:`ssm_prefill` and :func:`ssm_decode`
cast through the cached :func:`L.cast_param`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


class SSMMixer(nn.Module):
    """Parameters of one Mamba2 mixer (``init_ssm_params``' tree)."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d, din, nh, N = cfg.d_model, cfg.d_inner, cfg.ssm_nheads, \
            cfg.ssm_state
        conv_ch = din + 2 * N                   # conv over [x | B | C]

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                            device=device))
        # in_proj → [z (din) | x (din) | B (N) | C (N) | dt (nh)]
        self.w_in = param(d, 2 * din + 2 * N + nh)
        self.conv_w = param(cfg.ssm_conv_width, conv_ch)
        self.conv_b = param(conv_ch)
        self.A_log = param(nh)
        self.D = param(nh)
        self.dt_bias = param(nh)
        self.norm_scale = param(din)
        self.w_out = param(din, d)


@torch.no_grad()
def init_ssm_params(mixer: SSMMixer, *, generator: torch.Generator
                    ) -> SSMMixer:
    """Fill ``mixer`` with the reference's distributions (not its bits:
    the draws come from ``generator``): ``init_dense`` weights, conv_w
    N(0, 0.2²), and the closed forms of A_log, D and dt_bias."""
    w_in, w_out = mixer.w_in, mixer.w_out
    dev = w_in.device
    nh = mixer.A_log.shape[0]
    w_in.copy_(L.init_dense(tuple(w_in.shape), generator=generator,
                            device=dev))
    mixer.conv_w.normal_(0.0, 0.2, generator=generator)
    mixer.conv_b.zero_()
    mixer.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh,
                                               device=dev)))
    mixer.D.fill_(1.0)
    dt0 = torch.linspace(1e-3, 1e-1, nh, device=dev)
    mixer.dt_bias.copy_(torch.log(torch.expm1(dt0)))
    mixer.norm_scale.fill_(1.0)
    w_out.copy_(L.init_dense(tuple(w_out.shape), generator=generator,
                             device=dev))
    return mixer


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d + silu.  u (B, S, C); w (K, C); b (C,)."""
    K, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(K):
        out = out + pad[:, i: i + S, :].to(torch.float32) * w[i][None, None]
    return F.silu(out + b[None, None, :]).to(u.dtype)


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    din, N = cfg.d_inner, cfg.ssm_state
    z = proj[..., :din]
    xBC = proj[..., din: 2 * din + 2 * N]
    dt = proj[..., 2 * din + 2 * N:]
    return z, xBC, dt


def _scan_inputs(mixer: SSMMixer, xBC: torch.Tensor, dt_raw: torch.Tensor,
                 cfg: ModelConfig):
    """(x heads, dt, A, B, C) of the scan: x, B and C stay views of
    ``xBC`` (the kernel reads them through their strides)."""
    din, N = cfg.d_inner, cfg.ssm_state
    xs = xBC[..., :din]
    Bm = xBC[..., din: din + N]
    Cm = xBC[..., din + N:]
    dt = F.softplus(dt_raw.to(torch.float32) + mixer.dt_bias)
    A = -torch.exp(mixer.A_log)
    xh = xs.reshape(*xs.shape[:-1], cfg.ssm_nheads, cfg.ssm_headdim)
    return xh, dt, A, Bm, Cm


def _gate_out(mixer: SSMMixer, y: torch.Tensor, xh: torch.Tensor,
              z: torch.Tensor, cfg: ModelConfig, w_out: torch.Tensor
              ) -> torch.Tensor:
    """D skip, gated RMSNorm, out_proj by ``w_out`` (in y's dtype)."""
    D = mixer.D.to(y.dtype).view(*([1] * (y.dim() - 2)), -1, 1)
    y = y + D * xh.to(y.dtype)
    y = y.reshape(*y.shape[:-2], cfg.d_inner)
    y = L.rms_norm(y * F.silu(z), mixer.norm_scale, cfg.norm_eps)
    return y @ w_out


def _mixer(mixer: SSMMixer, x: torch.Tensor, cfg: ModelConfig, weight):
    """The SSD block over x (B, S, d_model), ``weight(name)`` giving
    ``w_in`` / ``w_out`` in x's dtype → (out, raw xBC, final state)."""
    proj = x @ weight("w_in")
    z, xBC_raw, dt_raw = _split_proj(cfg, proj)
    xBC = _causal_conv(xBC_raw, mixer.conv_w, mixer.conv_b)
    xh, dt, A, Bm, Cm = _scan_inputs(mixer, xBC, dt_raw, cfg)
    y, h_final = kops.ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    return _gate_out(mixer, y, xh, z, cfg, weight("w_out")), xBC_raw, \
        h_final


def ssm_prefill(mixer: SSMMixer, x: torch.Tensor, cfg: ModelConfig):
    """SSD block over x (B, S, d_model) → (out, decode cache entry), the
    weights cast through the cached :func:`L.cast_param`.

    The entry is the raw (pre-conv) xBC of the last K−1 positions and the
    scan's final state, as the reference's ``_ssm_prefill_layer`` keeps.
    """
    S = x.shape[1]
    out, xBC, h_final = _mixer(
        mixer, x, cfg, lambda name: L.cast_param(mixer, name, x.dtype))
    conv_tail = xBC[:, S - (cfg.ssm_conv_width - 1):, :].clone()
    return out, {"conv": conv_tail, "ssm": h_final}


def ssm_layer(mixer: SSMMixer, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """Training/forward SSD block over x: (B, S, d_model), ``w_in`` and
    ``w_out`` cast through autograd."""
    return _mixer(mixer, x, cfg,
                  lambda name: L.cast(getattr(mixer, name), x.dtype))[0]


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, *, device) -> dict:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_state,
                            cfg.ssm_headdim), dtype=torch.float32,
                           device=device),
    }


def ssm_decode(mixer: SSMMixer, x: torch.Tensor, cache: dict,
               cfg: ModelConfig):
    """Single-token SSD step.  x (B, 1, d_model); cache as
    :func:`init_ssm_cache` → (out (B, 1, d_model), new cache entry)."""
    proj = x[:, 0, :] @ L.cast_param(mixer, "w_in", x.dtype)
    z, xBC, dt_raw = _split_proj(cfg, proj)
    # conv state: window of the last K−1 inputs
    window = torch.cat([cache["conv"],
                        xBC[:, None, :].to(cache["conv"].dtype)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.to(torch.float32),
                            mixer.conv_w)
    xBC_t = F.silu(conv_out + mixer.conv_b[None, :]).to(x.dtype)
    xh, dt, A, Bm, Cm = _scan_inputs(mixer, xBC_t, dt_raw, cfg)
    y, h_new = kops.ssd_decode(xh, dt, A, Bm, Cm, cache["ssm"])
    out = _gate_out(mixer, y, xh, z, cfg,
                    L.cast_param(mixer, "w_out", y.dtype))[:, None, :]
    return out, {"conv": window[:, 1:, :], "ssm": h_new}

