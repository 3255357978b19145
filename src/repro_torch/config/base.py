"""Configuration dataclasses of the port (plain data, no torch import).

:class:`SolverConfig` is the reference's solver config field for field;
:class:`ClientConfig` keeps the fields the ``inline`` backend reads plus
``device`` — where the client runs its work (``"cuda"`` by default).
:class:`ModelConfig` and :class:`ShapeConfig` are the reference's LM
architecture and workload-cell configs field for field, and
:class:`TrainConfig` its optimizer and training-loop settings field for
field and default for default.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class SolverConfig:
    """Settings for the paper-faithful convex solver (Algorithm 1)."""

    rho: float = 0.5
    gamma0: float = 0.9
    theta: float = 1e-5
    tau0: float = 0.0               # 0 ⇒ paper default tr(AᵀA)/2n
    tau_adapt: bool = True
    tau_grow: float = 2.0
    tau_shrink: float = 0.5
    tau_patience: int = 10
    surrogate: str = "exact_block"  # "linear" | "exact_block" | "newton_cg"
    inexact_alpha1: float = 0.0     # εᵏ schedule (0 ⇒ exact subproblems)
    inexact_alpha2: float = 1.0
    max_iters: int = 2_000
    tol: float = 1e-6               # stop when ‖x̂(x)−x‖∞ ≤ tol
    jacobi: bool = False            # True ⇒ Sᵏ = 𝒩 (full parallel Jacobi)
    # --- Step S.3 selection rule (repro_torch.core.selection.make_mask) ---
    # "greedy" (paper FPA) | "full" | "southwell" | "topk" | "random" |
    # "hybrid" | "cyclic".
    selection: str = "greedy"
    sel_p: float = 0.25             # Bernoulli sketch probability
    sel_k: int = 8                  # k for the topk rule
    sel_chunks: int = 4             # cycle length for the cyclic rule
    seed: int = 0                   # torch.Generator seed (random rules)


@dataclass(frozen=True)
class ServeConfig:
    """Settings of the solver serving runtimes (``repro_torch.serve``),
    field for field the reference's.

    The wave engine (``SolverServeEngine``) reads ``max_batch``; the
    continuous engine (``ContinuousSolverEngine``) the slab and scheduler
    knobs.  The mesh fields are kept for the schema; the mesh engine is
    not ported yet (ROADMAP Queue 1 step 12).
    """

    # --- wave engine ---
    max_batch: int = 16         # power-of-two bucket cap per wave
    # --- continuous engine ---
    slab_capacity: int = 8      # live slots per (family × shape) slab
    chunk_iters: int = 16       # FLEXA iterations per chunk step
    # Admission-queue ordering: "fifo" (arrival order) | "priority"
    # (higher SolveRequest.priority first) | "deadline" (earliest
    # SolveRequest.deadline first; deadline-less requests last).
    policy: str = "fifo"
    # Slabs one scheduler tick services, in round-robin rotation across
    # ticks (0 = all of them): every slab is serviced at least once every
    # ceil(n_slabs / slabs_per_tick) ticks.
    slabs_per_tick: int = 0
    # --- mesh engine (not ported; ROADMAP Queue 1 step 12) ---
    mesh_devices: int = 0
    mesh_routing: str = "least_loaded"
    steal_threshold: int = 1
    # Drain-tail slab compaction: when the admission queue is empty and
    # the live-slot count drops a power-of-two capacity bucket, migrate
    # the stragglers into a narrower slab (and grow back on new
    # arrivals).  The port runs one eager program at every capacity, so
    # a migrated row keeps its trajectory bit for bit.
    compact_drain: bool = False
    # Numerical-health watchdog (repro_torch.obs.health): per-slot
    # verdicts (non-finite x / V / stat, stationarity stall) computed on
    # the device after each chunk; unhealthy slots are evicted with
    # status "diverged" / "stalled".  The verdicts read the iteration's
    # outputs and never write them, so healthy work is bitwise the same
    # with the watchdog on or off.
    watchdog: bool = False
    # Stall patience H: quarantine a slot once its ‖x̂(x)−x‖∞ has failed
    # to decrease for H consecutive chunks (within H+1 chunks of
    # admission).
    stall_patience: int = 10


@dataclass(frozen=True)
class ClientConfig:
    """One config for the front door (``repro_torch.client.FlexaClient``).

    ``backend`` names the execution backend: ``"inline"``, ``"wave"``,
    ``"continuous"`` or ``"remote"`` (a ``repro_torch.remote`` or
    ``repro.remote`` solver service over HTTP; ``"mesh"`` is not ported
    yet); ``serve`` carries the serving backends' knobs; ``device`` is
    where the client runs every workload — problems built on another
    device are moved there.  A remote client computes nothing: its
    ``device`` is resolved like any other (``"cuda"`` raises without
    CUDA), and its results are host arrays as every backend's are.
    """

    solver: SolverConfig = field(default_factory=SolverConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    backend: str = "inline"
    device: str = "cuda"
    # Base URL of the solver service the "remote" backend talks to,
    # e.g. "http://127.0.0.1:8781" — required when backend="remote",
    # ignored otherwise.
    remote_url: str = ""
    # Tenant identity the remote server applies quotas/SLO policy to
    # ("" = the server's default tenant).
    remote_tenant: str = ""
    # SLO class requested from the remote server ("" = the server's
    # default class; see repro_torch.remote.policy.SLO_CLASSES).
    remote_slo: str = ""

    def replace(self, **kw: Any) -> "ClientConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (one per ``--arch`` id).

    ``family`` selects the block stack: ``dense``, ``moe``, ``ssm``
    (attention-free Mamba2), ``hybrid``, ``encdec`` or ``vlm``, as in the
    reference; the port runs all six.
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- MoE ---
    num_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25

    # --- hybrid (zamba2) ---
    attn_every: int = 0

    # --- encoder-decoder (seamless) ---
    enc_layers: int = 0

    # --- positional encoding ---
    rope_theta: float = 10_000.0
    use_mrope: bool = False

    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    attn_window: int = 0
    source: str = ""

    @property
    def sub_quadratic(self) -> bool:
        """May run the 512k-context decode cell (SSM / hybrid only)."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_encoder_decoder(self) -> bool:
        return self.family == "encdec"

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """The reference's parameter-count estimate (``6·N·D`` rooflines,
        the training CLI's banner)."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = d * (self.num_heads * self.head_dim) \
            + 2 * d * (self.num_kv_heads * self.head_dim) \
            + (self.num_heads * self.head_dim) * d
        per_dense_mlp = 3 * d * self.d_ff
        n = emb
        if self.family in ("dense", "vlm"):
            n += self.num_layers * (per_attn + per_dense_mlp)
        elif self.family == "moe":
            e = self.moe_top_k if active_only else self.num_experts
            n += self.num_layers * (per_attn + e * 3 * d * self.d_ff)
        elif self.family == "ssm":
            din = self.d_inner
            per = d * 2 * din + d * din + din * 2 * self.ssm_state + din
            n += self.num_layers * per
        elif self.family == "hybrid":
            din = self.d_inner
            per = d * 2 * din + d * din + din * 2 * self.ssm_state + din
            n += self.num_layers * per + per_attn + per_dense_mlp
        elif self.family == "encdec":
            n += self.enc_layers * (per_attn + per_dense_mlp)
            n += self.num_layers * (2 * per_attn + per_dense_mlp)
        return n


@dataclass(frozen=True)
class ShapeConfig:
    """One workload cell: ``kind`` is ``train``, ``prefill`` or
    ``decode`` (one new token against a cache of ``seq_len``)."""

    name: str
    kind: str
    seq_len: int
    global_batch: int


#: The reference's workload cells (``repro.config.base.SHAPES``).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

@dataclass(frozen=True)
class TrainConfig:
    """Optimizer + training-loop settings (the reference's, field for
    field).  ``pipeline``, ``pp_microbatches``, ``strategy`` and
    ``microbatch`` are read by the reference's multi-device step builders
    only; the port's :class:`~repro_torch.train.loop.TrainLoop` raises if
    one of them is set away from its default."""

    optimizer: str = "flexa"  # "flexa" | "adamw"
    # --- FLEXA (Algorithm 1) ---
    flexa_rho: float = 0.5          # greedy selection factor ρ ∈ (0, 1]
    flexa_gamma0: float = 0.9       # γ⁰ for Eq. (4)
    flexa_theta: float = 1e-5       # θ  for Eq. (4)
    flexa_tau0: float = 1.0         # initial proximal weight τᵢ
    flexa_l1: float = 0.0           # c in G(x)=c‖x‖₁ (0 ⇒ G≡0)
    flexa_diag_q: bool = False      # diagonal Qᵢ curvature (beyond-paper)
    flexa_tau_adapt: bool = True    # double/halve rule from §4
    flexa_select: str = "greedy"    # "greedy" | "all" (full Jacobi)
    # --- AdamW baseline ---
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    weight_decay: float = 0.1
    # --- loop ---
    steps: int = 100
    log_every: int = 10
    seed: int = 0
    microbatch: int = 0             # 0 ⇒ no gradient accumulation
    remat: bool = True
    # --- fault tolerance ---
    ckpt_dir: str = ""
    ckpt_every: int = 50
    ckpt_keep: int = 3
    ckpt_async: bool = True
    resume: bool = True
    # --- distributed optimization tricks ---
    grad_compression: str = "none"  # "none" | "topk" | "int8"
    grad_topk_frac: float = 0.1
    pipeline: bool = False          # GPipe over the data axis (dense/vlm)
    pp_microbatches: int = 16
    strategy: str = "tp"            # "tp" | "zero3" (multi-device)

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
