"""Deterministic synthetic data pipeline, as ``repro.data.synthetic``
(the numpy generator copied verbatim, so batches are bit-identical to
the reference's for the same config, shape, seed and step).

Production posture without external datasets: a seeded, *shard-aware*
generator — every (step, host) pair maps to a disjoint, reproducible slice of
the stream, so restarts resume bit-identically (fault-tolerance requirement)
and data parallelism never duplicates samples.

The token distribution is a Zipf-ish mixture with enough structure (local
n-gram correlations) that a language model's loss visibly decreases — enough
signal for the end-to-end training examples.
"""
from __future__ import annotations

import numpy as np

from repro_torch.config.base import ModelConfig


class TokenPipeline:
    """Stateless batch generator: ``batch(step)`` is a pure function."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        v = cfg.vocab_size
        base = np.random.default_rng(seed)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks ** 1.1)
        self._probs /= self._probs.sum()
        # A fixed random bigram shift gives learnable local structure.
        self._shift = base.integers(1, v, size=1024)

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed, step, self.host_id))
        v = self.cfg.vocab_size
        toks = rng.choice(v, size=(self.batch, self.seq + 1),
                          p=self._probs).astype(np.int64)
        # half the positions continue deterministically from the previous
        # token — the learnable structure
        det = (toks[:, :-1] + self._shift[toks[:, :-1] % 1024]) % v
        gate = rng.random((self.batch, self.seq)) < 0.5
        toks[:, 1:] = np.where(gate, det, toks[:, 1:])
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.cfg.use_mrope:
            pos = np.broadcast_to(np.arange(self.seq, dtype=np.int32),
                                  (self.batch, self.seq))
            batch["positions"] = np.broadcast_to(
                pos[:, None, :], (self.batch, 3, self.seq)).copy()
        if self.cfg.is_encoder_decoder:
            batch["enc_embeds"] = rng.standard_normal(
                (self.batch, self.seq, self.cfg.d_model)).astype(np.float32)
        return batch
