"""Deterministic synthetic LM data pipeline.

A copy of ``repro.data.pipeline`` (numpy only; the JAX package cannot be
imported without jax), so the batches equal the JAX package's element for
element.

Two generators:
  * ``bigram`` (default): a fixed seed-derived vocabulary permutation P;
    sequences follow t[i+1] = P[t[i]] from a random start.  Any architecture
    learns it quickly (next token is a function of the current token), so
    training examples/tests show loss dropping far below the uniform
    baseline within tens of steps.
  * ``recurrence``: second-order integer recurrence
    t[i+1] = (a*t[i] + b*t[i-1] + c) mod V with per-sequence coefficients —
    a harder probe task.

Generation is host-side numpy, seeded, and shardable: each sequence index
derives its own PRNG stream (seed, epoch, index), so multi-host data
loading produces identical global batches regardless of host count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Literal

import numpy as np

from repro_torch.core.types import ModelConfig


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    seed: int = 0
    pattern: Literal["bigram", "recurrence"] = "bigram"
    num_patterns: int = 8

    def __post_init__(self):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 0xB16]))
        self._perm = rng.permutation(self.vocab_size)

    def _params_for(self, rng: np.random.Generator):
        a = rng.integers(1, self.num_patterns + 1)
        b = rng.integers(0, self.num_patterns)
        c = rng.integers(0, self.vocab_size)
        return int(a), int(b), int(c)

    def sequence(self, epoch: int, index: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, index]))
        v = self.vocab_size
        seq = np.empty(self.seq_len + 1, np.int64)
        if self.pattern == "bigram":
            seq[0] = rng.integers(0, v)
            for i in range(self.seq_len):
                seq[i + 1] = self._perm[seq[i]]
            return seq
        a, b, c = self._params_for(rng)
        seq[0] = rng.integers(0, v)
        seq[1] = rng.integers(0, v)
        for i in range(1, self.seq_len):
            seq[i + 1] = (a * seq[i] + b * seq[i - 1] + c) % v
        return seq

    def batch(self, epoch: int, start: int, batch_size: int
              ) -> Dict[str, np.ndarray]:
        seqs = np.stack([self.sequence(epoch, start + i)
                         for i in range(batch_size)])
        return {
            "tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32),
        }


def make_batches(cfg: ModelConfig, batch_size: int, seq_len: int,
                 seed: int = 0, epoch: int = 0
                 ) -> Iterator[Dict[str, np.ndarray]]:
    ds = SyntheticLM(cfg.vocab_size, seq_len, seed=seed)
    start = 0
    while True:
        yield ds.batch(epoch, start, batch_size)
        start += batch_size
