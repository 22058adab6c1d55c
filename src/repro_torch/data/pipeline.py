"""Deterministic synthetic token pipeline with sharded host loading.

The port's copy of the reference's loader, NumPy only: its batches are
bit-identical to the reference's.  The token source is a seeded Zipfian
generator, so training runs are reproducible and self-contained.  Host h
of H gets rows [h*B/H, (h+1)*B/H) of the global batch.

Straggler mitigation hook: ``reissue(step, host)`` returns the same rows
for a backup host (work stealing), deterministic by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1


class SyntheticTokenSource:
    """Zipfian token stream (LM-ish marginals), deterministic per (seed,
    step, row)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks**1.1
        self.probs = probs / probs.sum()

    def batch(self, step: int, rows: range) -> dict[str, np.ndarray]:
        cfg = self.cfg
        out_tokens = np.empty((len(rows), cfg.seq_len + 1), np.int32)
        for i, row in enumerate(rows):
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, row]))
            out_tokens[i] = rng.choice(
                cfg.vocab_size, size=cfg.seq_len + 1, p=self.probs)
        return {
            "tokens": out_tokens[:, :-1],
            "labels": out_tokens[:, 1:].astype(np.int32),
        }


class ShardedLoader:
    """Per-host loader over the global batch."""

    def __init__(self, cfg: DataConfig, host_id: int):
        if cfg.global_batch % cfg.n_hosts != 0:
            raise ValueError(
                f"global_batch {cfg.global_batch} not divisible by "
                f"n_hosts {cfg.n_hosts}"
            )
        self.cfg = cfg
        self.host_id = host_id
        self.source = SyntheticTokenSource(cfg)
        per = cfg.global_batch // cfg.n_hosts
        self.rows = range(host_id * per, (host_id + 1) * per)

    def get(self, step: int) -> dict[str, np.ndarray]:
        return self.source.batch(step, self.rows)

    def reissue(self, step: int, straggler_host: int) -> dict[str, np.ndarray]:
        """Work stealing: produce the straggler's shard deterministically."""

        per = self.cfg.global_batch // self.cfg.n_hosts
        rows = range(straggler_host * per, (straggler_host + 1) * per)
        return self.source.batch(step, rows)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.get(step)
            step += 1
