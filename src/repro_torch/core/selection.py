"""Block-selection rules (Step S.3 of Algorithm 1).

Same rules and contracts as ``repro.core.selection``: greedy-ρ (the
paper's FPA), full Jacobi, Gauss-Southwell, top-k, and the
arXiv:1407.4504 random / hybrid / essentially-cyclic rules.  Every rule
returns a {0,1} float mask over the last axis of ``E``; leading axes are
independent instances (the batched engine's batch dimension).

Randomness comes from a ``torch.Generator`` seeded from ``cfg.seed``, or
from a sequence of generators, one per instance row (the serving slab's
per-request streams: row i draws from ``gen[i]`` alone, as a solo run
seeded alike would).  It does not reproduce JAX's threefry bits, so the
randomized rules are held to their properties (binary, non-empty,
sketch-relative greedy, cycle coverage), not to the reference's masks.
"""
from __future__ import annotations

import functools

import torch

#: Rules whose Sᵏ depends on a random draw (state carries a generator).
RANDOMIZED_RULES = ("random", "hybrid")

#: Every rule name `SolverConfig.selection` accepts.
RULES = ("greedy", "full", "jacobi", "southwell", "topk") + \
    RANDOMIZED_RULES + ("cyclic",)


def _one_hot(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """{0,1} mask shaped like ``like`` with a 1 at ``idx`` on the last axis."""
    return torch.zeros_like(like).scatter_(-1, idx.unsqueeze(-1), 1.0)


def greedy_mask(E: torch.Tensor, rho: float, M=None) -> torch.Tensor:
    """All blocks within factor ρ of the max error bound (``M`` may be
    supplied already reduced)."""
    if M is None:
        M = E.max(-1).values
    return (E >= rho * M.unsqueeze(-1)).to(E.dtype)


def full_mask(E: torch.Tensor) -> torch.Tensor:
    """Sᵏ = 𝒩 — the fully parallel Jacobi scheme."""
    return torch.ones_like(E)


def southwell_mask(E: torch.Tensor) -> torch.Tensor:
    """Exactly one block: the argmax (first on ties, as jnp.argmax)."""
    return _one_hot(torch.argmax(E, dim=-1), E)


def topk_mask(E: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest blocks; ties broken by block index via a stable
    descending argsort (never evicts a strictly larger block)."""
    if k >= E.shape[-1]:
        return torch.ones_like(E)
    idx = torch.argsort(-E, dim=-1, stable=True)[..., :k]
    return torch.zeros_like(E).scatter_(-1, idx, 1.0)


def random_mask(E: torch.Tensor, p: float, gen: torch.Generator
                ) -> torch.Tensor:
    """Bernoulli(p) sketch of the blocks; an empty draw is replaced by one
    uniformly random block, so Sᵏ is never empty.  ``gen`` may be a
    sequence of generators, one per row of ``E``."""
    if isinstance(gen, (list, tuple)):
        return torch.stack([random_mask(e, p, g) for e, g in zip(E, gen)])
    u = torch.rand(E.shape, generator=gen, device=E.device)
    m = (u < p).to(E.dtype)
    one = torch.randint(0, E.shape[-1], E.shape[:-1], generator=gen,
                        device=E.device)
    return torch.where(m.any(-1, keepdim=True), m, _one_hot(one, E))


def hybrid_mask(E: torch.Tensor, rho: float, p: float,
                gen: torch.Generator) -> torch.Tensor:
    """Greedy-ρ restricted to a Bernoulli(p) sketch: always contains the
    sketch argmax."""
    sketch = random_mask(E, p, gen)
    M_sketch = (E * sketch).max(-1, keepdim=True).values
    return sketch * (E >= rho * M_sketch).to(E.dtype)


@functools.lru_cache(maxsize=8)
def _chunk_of(n_blocks: int, n_chunks: int, seed: int,
              device: torch.device) -> torch.Tensor:
    """Block → chunk assignment of a seeded shuffled round-robin."""
    perm = torch.randperm(n_blocks,
                          generator=torch.Generator().manual_seed(seed))
    chunk_of = torch.empty(n_blocks, dtype=torch.int64)
    chunk_of[perm] = torch.arange(n_blocks) % n_chunks
    return chunk_of.to(device)


def cyclic_shuffle_mask(n_blocks: int, k, n_chunks: int, seed: int,
                        device=None) -> torch.Tensor:
    """Chunk ``k mod n_chunks`` of a shuffled round-robin block partition.

    The partition is a pure function of ``seed``, so the rule is a true
    cycle: chunks are disjoint, balanced to within one block, and any
    ``n_chunks`` consecutive iterations cover every block.  ``k`` may be
    a tensor with leading instance axes.
    """
    # Fewer blocks than chunks would leave some iterations with an empty
    # Sᵏ (x unchanged while γ still decays) — clamp the cycle length.
    n_chunks = max(1, min(n_chunks, n_blocks))
    k = torch.as_tensor(k, device=device)
    chunk_of = _chunk_of(n_blocks, n_chunks, seed, k.device)
    return (chunk_of == (k % n_chunks).unsqueeze(-1)).to(torch.float32)


def needs_generator(rule: str) -> bool:
    """Whether ``rule`` draws random numbers every iteration."""
    return rule in RANDOMIZED_RULES


def is_full(cfg) -> bool:
    """Whether ``cfg`` selects every block (Sᵏ = 𝒩) each iteration."""
    return cfg.jacobi or cfg.selection in ("full", "jacobi")


def make_mask(E: torch.Tensor, cfg, gen, k, M=None) -> torch.Tensor:
    """Dispatch Step S.3 on ``cfg.selection`` (``cfg.jacobi=True``
    overrides to the full rule).  ``gen`` feeds the randomized rules,
    ``k`` the cyclic rule, ``M`` is an optional precomputed max of E."""
    if is_full(cfg):
        return full_mask(E)
    rule = cfg.selection
    if rule == "greedy":
        return greedy_mask(E, cfg.rho, M)
    if rule == "southwell":
        return southwell_mask(E)
    if rule == "topk":
        return topk_mask(E, cfg.sel_k)
    if rule == "random":
        return random_mask(E, cfg.sel_p, gen)
    if rule == "hybrid":
        return hybrid_mask(E, cfg.rho, cfg.sel_p, gen)
    if rule == "cyclic":
        return cyclic_shuffle_mask(E.shape[-1], k, cfg.sel_chunks,
                                   cfg.seed, device=E.device)
    raise ValueError(f"unknown selection rule {rule!r}; one of {RULES}")
