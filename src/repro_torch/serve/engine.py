"""Serving engines: LM generation and wave-batched solver serving.

1. :class:`ServeEngine` — LM text generation, as
   ``repro.serve.engine.ServeEngine``: batched prefill, then decode of
   one token per step for the whole batch in lock-step, greedy or
   temperature sampling (seeded), for the ``dense``, ``moe`` and ``vlm``
   (KV cache, ``flash_attention`` in the prefill; vlm with M-RoPE text
   positions t = h = w), ``ssm`` (conv window and SSD state, ``ssd_scan``
   in the prefill), ``hybrid`` (both: one KV cache per application of
   the shared block) and ``encdec`` (the frames
   ``extra_inputs["enc_embeds"]`` through the encoder; a self and a
   cross KV cache) families.  The reference jits prefill and decode once
   per (batch, length) bucket and shards over a mesh; the port runs
   eagerly on one ``device`` (``"cuda"`` by default).

2. :class:`SolverServeEngine` — many concurrent solve requests of any
   registered problem family: grouped by shape signature
   (:class:`~repro_torch.solvers.batched.BatchedProblemSpec`), chopped
   into power-of-two buckets up to ``max_batch``, padded by repeating
   the first request, and each bucket run to convergence by the lockstep
   batched driver (``make_batched_solver``: S.2 of every ℓ1 iteration is
   the CUDA ``batched_best_response`` on the card).  Each row runs its
   own instance's closures, so a bucket row — a padding clone too — is
   its solo run bit for bit under the deterministic rules.

:class:`SolveRequest` / :class:`SolveResponse` / :func:`validate_request`
are shared with the continuous runtime (``repro_torch.serve.continuous``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config.base import (ModelConfig, ServeConfig, ShapeConfig,
                                     SolverConfig)
from repro_torch.deprecation import warn_legacy
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import io as IO
from repro_torch.models import transformer as T
from repro_torch.obs import trace as obs_trace
from repro_torch.problems.families import get_family
from repro_torch.serve.metrics import ServeTelemetry
from repro_torch.solvers.batched import (BatchedProblemSpec,
                                         make_batched_solver)


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


# ===================================================================== #
# Batched solver serving                                                #
# ===================================================================== #
@dataclass
class SolveRequest:
    """One composite-minimization request:  min F(x) + c·g(x).

    ``family`` picks F (``repro_torch.problems.families``): the quadratic
    families ("lasso"/"group_lasso") read ``A`` as the design matrix and
    need ``b``; "logreg"/"svm" read ``A`` as the label-signed feature
    matrix Z and take no ``b``.  Arrays are host (numpy) arrays.

    ``priority``/``deadline`` are scheduling hints of the continuous
    runtime's admission queue; the wave engine ignores them.  ``x0`` is
    spliced in on admission (zeros if unset); ``warm_from`` (continuous
    only) uses the solution of that earlier request of the same engine
    as ``x0``, deferring admission until it finishes; ``active_mask`` is
    a per-coordinate {0,1} freeze mask; ``tol`` a per-request stopping
    tolerance (continuous only; None = the engine's ``SolverConfig.tol``).
    """
    A: np.ndarray               # (m, n) design / signed-feature matrix
    b: np.ndarray | None = None  # (m,) observations (quadratic families)
    c: float = 1.0              # regularization weight
    block_size: int = 1         # 1 ⇒ ℓ1; >1 ⇒ group-ℓ2 blocks
    family: str = ""            # "" ⇒ lasso/group_lasso by block_size
    x0: np.ndarray | None = None  # optional warm start
    priority: int = 0           # higher = admitted first ("priority" policy)
    deadline: float | None = None  # absolute time ("deadline" policy)
    warm_from: int | None = None   # req_id whose solution becomes x0
    active_mask: np.ndarray | None = None  # (n,) freeze mask (1 = live)
    tol: float | None = None    # per-request stopping tolerance

    @property
    def spec(self) -> BatchedProblemSpec:
        family = self.family or (
            "lasso" if self.block_size == 1 else "group_lasso")
        return BatchedProblemSpec(
            m=int(self.A.shape[0]), n=int(self.A.shape[1]),
            block_size=self.block_size,
            g_kind="l1" if self.block_size == 1 else "group_l2",
            family=family)

    def data_arrays(self, spec: BatchedProblemSpec) -> tuple:
        """The family data tuple (host fp32 arrays) this request
        contributes: ``A`` supplies the leading (m, n) array whatever the
        family calls it, ``b`` the observation vector."""
        keys = get_family(spec.family).data_keys
        out = []
        for j, k in enumerate(keys):
            if j == 0:
                out.append(np.asarray(self.A, np.float32))
            elif k == "b":
                out.append(np.asarray(self.b, np.float32))
            else:
                raise NotImplementedError(
                    f"SolveRequest has no field for data key {k!r} of "
                    f"family {spec.family!r}")
        return tuple(out)


@dataclass
class SolveResponse:
    """Per-request solver verdict (unbatched back out of the bucket)."""
    x: np.ndarray
    iters: int
    converged: bool
    stat: float                 # final ‖x̂(x)−x‖∞
    bucket: int                 # batch bucket / slab capacity served in
    #: "ok" for a normal completion (converged or max-iters);
    #: "diverged"/"stalled" when the watchdog quarantined the solve;
    #: "timeout" when the continuous engine evicted it past its deadline.
    status: str = "ok"


def validate_request(i: "int | None", r: SolveRequest,
                     spec: BatchedProblemSpec) -> None:
    """Shape/family checks shared by the wave and continuous engines,
    raised before any device work.  ``i`` is the request's position in a
    wave (``None`` for single-request submission)."""
    where = "request" if i is None else f"request {i}"
    needs_b = "b" in get_family(spec.family).data_keys
    if needs_b and np.shape(r.b) != (spec.m,):
        raise ValueError(
            f"{where}: family {spec.family!r} needs b of shape "
            f"({spec.m},), got {np.shape(r.b)}")
    if not needs_b and r.b is not None:
        raise ValueError(
            f"{where}: family {spec.family!r} takes no b")
    if r.x0 is not None and np.shape(r.x0) != (spec.n,):
        raise ValueError(
            f"{where}: x0 must have shape ({spec.n},), got "
            f"{np.shape(r.x0)}")
    if r.active_mask is not None and np.shape(r.active_mask) != (spec.n,):
        raise ValueError(
            f"{where}: active_mask must have shape ({spec.n},), got "
            f"{np.shape(r.active_mask)}")
    if r.warm_from is not None and r.x0 is not None:
        raise ValueError(
            f"{where}: warm_from and x0 are mutually exclusive")
    if r.tol is not None and not (float(r.tol) >= 0):
        raise ValueError(
            f"{where}: tol must be a non-negative float, got {r.tol!r}")


def _stack(rows, dev) -> torch.Tensor:
    return torch.from_numpy(np.stack(rows)).to(dev)


class SolverServeEngine:
    """Serve many concurrent FLEXA solves in padded power-of-two waves.

    Requests are grouped by :class:`BatchedProblemSpec`, each group
    chopped into buckets of at most ``max_batch`` (the smallest power of
    two that holds the remainder, ``max_batch`` itself on top), short
    buckets padded by repeating their first request; every bucket runs
    to convergence in :func:`make_batched_solver` (stragglers iterate,
    finished rows stay frozen).  ``stats`` reports requests, batches,
    padding, distinct (signature, bucket) pairs, mean bucket occupancy
    and padding waste; ``telemetry`` keeps the per-wave and per-request
    records.  Prefer the front door: ``FlexaClient(backend="wave")``.
    """

    def __init__(self, cfg: SolverConfig | None = None,
                 serve: ServeConfig | None = None, *,
                 telemetry: ServeTelemetry | None = None,
                 device=DEFAULT_DEVICE):
        warn_legacy("repro_torch.serve.SolverServeEngine",
                    'FlexaClient(backend="wave").run(...)')
        self.cfg = cfg or SolverConfig()
        self.serve = serve or ServeConfig()
        self.max_batch = int(self.serve.max_batch)
        self.device = resolve_device(device)
        self.telemetry = telemetry or ServeTelemetry()
        self.stats = {"requests": 0, "batches": 0, "padded": 0,
                      "signatures": 0, "occupancy": 0.0,
                      "padding_waste": 0.0}
        self._seen: set = set()
        #: Request ids of the most recent wave, aligned with the
        #: ``requests`` passed to :meth:`submit`.
        self.last_request_ids: list[int] = []
        self._row_iters = 0
        self._pad_row_iters = 0
        self._occupancy_sum = 0.0

    def _bucket(self, count: int) -> int:
        """Smallest power of two ≥ count, capped at ``max_batch``."""
        b = 1
        while b < count and b < self.max_batch:
            b *= 2
        return min(b, self.max_batch)

    def submit(self, requests: list[SolveRequest],
               arrivals: list[float] | None = None
               ) -> list[SolveResponse]:
        """Solve a wave of requests; responses align with request order.

        The whole wave is validated before any bucket runs (a malformed
        request rejects it atomically).  ``arrivals`` optionally backdates
        each request's telemetry arrival.
        """
        by_spec: dict[BatchedProblemSpec, list[int]] = {}
        for i, r in enumerate(requests):
            spec = r.spec
            validate_request(i, r, spec)
            if r.warm_from is not None:
                raise ValueError(
                    f"request {i}: warm_from is a continuous-engine "
                    "feature (the wave engine keeps no per-id results "
                    "to warm from); pass x0 explicitly")
            if r.tol is not None:
                raise ValueError(
                    f"request {i}: per-request tol is a continuous-"
                    "engine feature (the wave program compiles one "
                    "tolerance); configure SolverConfig.tol instead")
            by_spec.setdefault(spec, []).append(i)
        if arrivals is not None and len(arrivals) != len(requests):
            raise ValueError("arrivals must align with requests")

        tele = self.telemetry
        req_ids = [tele.next_request_id() for _ in requests]
        self.last_request_ids = list(req_ids)
        for i, r in enumerate(requests):
            tele.record_arrival(req_ids[i], r.spec.family, "wave",
                                t=None if arrivals is None
                                else arrivals[i])

        out: list[SolveResponse | None] = [None] * len(requests)
        dev = self.device
        for spec, idxs in by_spec.items():
            run = make_batched_solver(spec, self.cfg)
            pos = 0
            while pos < len(idxs):
                chunk = idxs[pos:pos + self.max_batch]
                pos += self.max_batch
                B = self._bucket(len(chunk))
                pad = B - len(chunk)
                rows = [requests[i] for i in chunk] \
                    + [requests[chunk[0]]] * pad
                per_req = [r.data_arrays(spec) for r in rows]
                data = tuple(_stack([a[j] for a in per_req], dev)
                             for j in range(len(per_req[0])))
                c = torch.tensor([float(r.c) for r in rows],
                                 dtype=torch.float32, device=dev)
                x0 = _stack([np.zeros(spec.n, np.float32) if r.x0 is None
                             else np.asarray(r.x0, np.float32)
                             for r in rows], dev)
                active = None
                if any(r.active_mask is not None for r in rows):
                    active = _stack([
                        np.ones(spec.n, np.float32) if r.active_mask is None
                        else np.asarray(r.active_mask, np.float32)
                        for r in rows], dev)

                for i in chunk:
                    tele.record_admit(req_ids[i])
                t0 = time.perf_counter()
                with obs_trace.span("serve.wave", cat="wave", bucket=B,
                                    n_real=len(chunk), padded=pad,
                                    family=spec.family):
                    final, converged = run(data, c, x0, active)
                    xs = final.x.cpu().numpy()   # device sync: wave done
                wall = time.perf_counter() - t0
                ks = final.k.cpu().numpy()
                stats_ = final.stat.cpu().numpy()
                conv = converged.cpu().numpy()
                for j, i in enumerate(chunk):
                    out[i] = SolveResponse(
                        x=xs[j], iters=int(ks[j]), converged=bool(conv[j]),
                        stat=float(stats_[j]), bucket=B)
                    tele.record_completion(req_ids[i], iters=int(ks[j]),
                                           converged=bool(conv[j]))
                tele.record_wave(bucket=B, n_real=len(chunk),
                                 iters=ks[:len(chunk)], wall_s=wall,
                                 device_iters_max=int(ks.max()),
                                 flops=(B * int(ks.max())
                                        * spec.m * spec.n))
                del data, final

                self.stats["requests"] += len(chunk)
                self.stats["batches"] += 1
                self.stats["padded"] += pad
                self._seen.add((spec, B))
                self._row_iters += B * int(ks.max())
                self._pad_row_iters += pad * int(ks.max())
                self._occupancy_sum += len(chunk) / B
        self.stats["signatures"] = len(self._seen)
        if self.stats["batches"]:
            self.stats["occupancy"] = \
                self._occupancy_sum / self.stats["batches"]
        if self._row_iters:
            self.stats["padding_waste"] = \
                self._pad_row_iters / self._row_iters
        return out  # type: ignore[return-value]
