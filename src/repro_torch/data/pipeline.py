"""Token data pipeline for LM training.

A copy of ``repro.data.pipeline`` (numpy only): a deterministic,
shardable synthetic token stream (no real corpora).  The stream is seeded
by (seed, step, host), so a restart resumes exactly and both packages give
the same batches; each host takes its own ``global_batch / n_hosts``
rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # Markov-ish structure so the LM loss actually decreases.
    n_states: int = 64


class TokenStream:
    """Iterator of {tokens,labels} numpy batches for one host."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        rng = np.random.default_rng(cfg.seed)
        # Shared low-entropy transition table => learnable structure.
        self.table = rng.integers(
            0, cfg.vocab, size=(cfg.n_states, 8), dtype=np.int32
        )

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.cfg.seed, step, self.host_id)
        )
        B, S = self.local_batch, self.cfg.seq_len
        state = rng.integers(0, self.cfg.n_states, size=(B, 1))
        toks = np.empty((B, S + 1), dtype=np.int32)
        noise = rng.integers(0, 8, size=(B, S + 1))
        cur = state[:, 0]
        for t in range(S + 1):
            toks[:, t] = self.table[cur, noise[:, t]]
            cur = (cur + toks[:, t]) % self.cfg.n_states
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
