"""Synthetic LM token pipeline: a learnable Markov stream (so CE
demonstrably falls below the unigram entropy during training) with
deterministic batching.  A copy of ``repro.data.tokens`` (host numpy only,
so the same seed gives the reference's tokens bit for bit)."""
from __future__ import annotations

import numpy as np


class MarkovTokens:
    """Order-1 Markov chain over ``vocab`` with ``n_states`` latent modes:
    cheap to sample, non-trivial to model, and a clear learnability signal."""

    def __init__(self, vocab: int, seed: int = 0, concentration: float = 0.3):
        rng = np.random.RandomState(seed)
        self.vocab = vocab
        k = min(vocab, 512)            # transition support per token
        self.support = rng.randint(0, vocab, size=(vocab, k))
        raw = rng.dirichlet(np.full(k, concentration), size=vocab)
        self.probs = raw.astype(np.float64)
        self.rng = rng

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len), np.int32)
        cur = self.rng.randint(0, self.vocab, size=batch)
        for t in range(seq_len):
            out[:, t] = cur
            rows = self.probs[cur]
            cum = rows.cumsum(axis=1)
            u = self.rng.rand(batch, 1)
            nxt_idx = (u < cum).argmax(axis=1)
            cur = self.support[cur, nxt_idx]
        return out


def batches(vocab: int, batch: int, seq_len: int, n_steps: int,
            seed: int = 0):
    gen = MarkovTokens(vocab, seed)
    for _ in range(n_steps):
        yield {"tokens": gen.sample(batch, seq_len)}
