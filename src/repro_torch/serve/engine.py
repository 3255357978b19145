"""LM text generation, as ``repro.serve.engine.ServeEngine``: batched
prefill, then decode of one token per step for the whole batch in
lock-step, greedy or temperature sampling (seeded), for the ``dense``,
``moe`` and ``vlm`` (KV cache, ``flash_attention`` in the prefill; vlm
with M-RoPE text positions t = h = w), ``ssm`` (conv window and SSD
state, ``ssd_scan`` in the prefill), ``hybrid`` (both: one KV cache per
application of the shared block) and ``encdec`` (the frames
``extra_inputs["enc_embeds"]`` through the encoder; a self and a cross
KV cache) families.

The reference jits prefill and decode once per (batch, length) bucket
and shards over a mesh; the port runs eagerly on one ``device``
(``"cuda"`` by default).  The solver engine (``SolverServeEngine``)
waits for ROADMAP Queue 1 step 10 (serving).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import io as IO
from repro_torch.models import transformer as T


@dataclass
class GenerationResult:
    tokens: np.ndarray        # (batch, generated)
    prefill_logits: np.ndarray


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: torch.nn.Module, *,
                 max_len: int = 256, device="cuda"):
        self.cfg = cfg
        self.model = model
        self.max_len = max_len
        self.device = resolve_device(device)
        where = {p.device for p in model.parameters()}
        if where != {self.device}:
            raise ValueError(f"model parameters on {sorted(map(str, where))}"
                             f", engine on {self.device}")

    def _grow_cache(self, cache: dict, batch: int) -> dict:
        """Re-home the prefill cache into max_len-capacity buffers: each
        prefill tensor is copied into the leading corner of its zeroed
        buffer (a KV cache (L, B, Hkv, Lp, dh) into (L, B, Hkv, max_len,
        dh); the ssm pair, whose shape has no length, as it is).

        encdec's ``cross_k`` / ``cross_v`` (L, B, Hkv, enc_len, dh) grow
        to max_len too, zero past enc_len, as the reference grows them.
        Decode's cross-attention reads every position, so those zero keys
        take softmax weight and its logits are not those of a forward
        over the same tokens: the reference's behaviour, which the port
        keeps (ROADMAP Queue 3, reference caveats)."""
        shape = ShapeConfig("serve", "decode", self.max_len, batch)
        full = IO.zero_cache(self.cfg, shape, device=self.device)
        for name, dst in full.items():
            src = cache[name]
            dst[tuple(slice(0, s) for s in src.shape)] = src.to(dst.dtype)
        return full

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, *, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 extra_inputs: dict | None = None) -> GenerationResult:
        """prompts: (batch, prompt_len) int32; for encdec
        ``extra_inputs={"enc_embeds": (batch, enc_len, d_model)}``
        (numpy or a tensor)."""
        B, Lp = prompts.shape
        if Lp + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {Lp} + {max_new_tokens} new tokens "
                             f"exceed max_len {self.max_len}")
        batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                           device=self.device)}
        if self.cfg.use_mrope:      # text: t = h = w = 0 … Lp − 1
            batch["positions"] = torch.arange(
                Lp, device=self.device).expand(B, 3, Lp)
        if self.cfg.is_encoder_decoder:
            if extra_inputs is None or "enc_embeds" not in extra_inputs:
                raise ValueError("encdec serving needs enc_embeds")
            enc = extra_inputs["enc_embeds"]
            if enc.shape[1] > self.max_len:
                raise ValueError(f"enc_embeds' {enc.shape[1]} frames exceed "
                                 f"max_len {self.max_len}, the cross cache's "
                                 "capacity")
            batch["enc_embeds"] = enc
        logits, cache = T.prefill(self.cfg, self.model, batch)
        cache = self._grow_cache(cache, B)

        gen = torch.Generator(device=self.device).manual_seed(seed)
        tok = self._sample(logits, temperature, gen)
        out = [tok]
        pos = Lp
        for _ in range(max_new_tokens - 1):
            lg, cache = T.decode_step(self.cfg, self.model, tok, cache, pos)
            tok = self._sample(lg, temperature, gen)
            out.append(tok)
            pos += 1
        return GenerationResult(
            tokens=torch.cat(out, dim=1).cpu().numpy(),
            prefill_logits=logits.cpu().numpy())

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                gen: torch.Generator) -> torch.Tensor:
        """(B, 1) int32: argmax, or argmax of logits/T + Gumbel noise
        (−log(−log u), u uniform in [tiny, 1), as ``jax.random.gumbel``
        draws it; the bits differ from JAX's)."""
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        g = -torch.log(-torch.log(u))
        return torch.argmax(logits / temperature + g,
                            dim=-1)[:, None].to(torch.int32)
