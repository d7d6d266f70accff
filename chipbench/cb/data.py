"""Training data: the benchmark's frozen copy of the port's bigram
generator (``repro_torch.data.pipeline.SyntheticLM``), and the feed that
draws its rows on the device.

A bigram row follows t[i+1] = P[t[i]] from a start token, P a permutation
of the vocabulary drawn from the seed.  ``SyntheticLM`` is the copy, kept
as it was when the benchmark was written, so that a change to the port's
pipeline cannot change the benchmark's data.  ``BigramFeed`` gives the
same rows without a Python loop over positions: a row is a stretch of P's
cycle through its start, so each row is one gather from P's cycles laid
end to end.  Row r of a run starts at ``starts[r % V]``, a permutation of
the vocabulary drawn from the seed: the first V rows of a run all differ.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class SyntheticLM:
    """The bigram rows of the port's generator: the permutation it draws
    from the seed, and a row from a start token."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0):
        self.vocab_size, self.seq_len, self.seed = vocab_size, seq_len, seed
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 0xB16]))
        self._perm = rng.permutation(self.vocab_size)

    def from_start(self, start: int) -> np.ndarray:
        """The bigram row of ``seq_len + 1`` tokens from ``start``."""
        seq = np.empty(self.seq_len + 1, np.int64)
        seq[0] = start
        for i in range(self.seq_len):
            seq[i + 1] = self._perm[seq[i]]
        return seq


def cycle_tables(perm: np.ndarray):
    """P's cycles laid end to end (``order``), and for each token the
    offset of its cycle in ``order``, the cycle's length and the token's
    place in it."""
    v = perm.shape[0]
    order = np.empty(v, np.int64)
    base = np.empty(v, np.int64)
    length = np.empty(v, np.int64)
    pos = np.empty(v, np.int64)
    seen = np.zeros(v, bool)
    at = 0
    for s in range(v):
        if seen[s]:
            continue
        cyc = [s]
        seen[s] = True
        t = perm[s]
        while t != s:
            cyc.append(t)
            seen[t] = True
            t = perm[t]
        n = len(cyc)
        idx = np.asarray(cyc, np.int64)
        order[at:at + n] = idx
        base[idx] = at
        length[idx] = n
        pos[idx] = np.arange(n)
        at += n
    return order, base, length, pos


class BigramFeed:
    """The global batch of each step, on ``device``: {"tokens", "labels"}
    (B, S) int64, row r of the run (step x B + b) the bigram row from
    ``starts[r % V]``."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int, seed: int,
                 device):
        self.lm = SyntheticLM(vocab_size, seq_len, seed=seed)
        self.batch_size, self.seq_len = batch, seq_len
        self.vocab_size = vocab_size
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0xFEED]))
        self.starts_np = rng.permutation(vocab_size)
        order, base, length, pos = cycle_tables(self.lm._perm)
        dev = torch.device(device)
        self._t = {k: torch.from_numpy(a).to(dev) for k, a in
                   (("order", order), ("base", base), ("length", length),
                    ("pos", pos), ("starts", self.starts_np))}
        self._ar = torch.arange(seq_len + 1, device=dev)
        self._rows = torch.arange(batch, device=dev)

    def start_tokens(self, step: int) -> np.ndarray:
        r = (step * self.batch_size + np.arange(self.batch_size)) \
            % self.vocab_size
        return self.starts_np[r]

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        t = self._t
        r = (self._rows + step * self.batch_size) % self.vocab_size
        s = t["starts"][r]
        idx = t["base"][s][:, None] + (t["pos"][s][:, None] + self._ar) \
            % t["length"][s][:, None]
        seq = t["order"][idx]
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def batch_np(self, step: int) -> Dict[str, np.ndarray]:
        """The same batch through the frozen generator's loop (tests)."""
        seqs = np.stack([self.lm.from_start(int(s))
                         for s in self.start_tokens(step)])
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
