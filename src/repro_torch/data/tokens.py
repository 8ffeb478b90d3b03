"""Synthetic LM token streams for the transformer training launchers (the
reference's ``data/tokens.py``, numpy only, so a batch is bit-equal to
the reference's for the same ``(vocab, seed, step)``).

Markov-chain token generator: deterministic per (seed, step), with enough
sequential structure that a small LM's loss visibly decreases, without a
real corpus.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class MarkovTokens:
    def __init__(self, vocab_size: int, order_states: int = 64, seed: int = 0):
        self.vocab = vocab_size
        rs = np.random.RandomState(seed)
        self.n_states = min(order_states, vocab_size)
        # sparse-ish transition structure: each state strongly prefers 4 tokens
        probs = np.full((self.n_states, vocab_size), 0.1 / vocab_size)
        for s in range(self.n_states):
            fav = rs.choice(vocab_size, size=4, replace=False)
            probs[s, fav] += 0.9 / 4
        self.probs = probs / probs.sum(1, keepdims=True)

    def batch(self, batch_size: int, seq_len: int,
              step: int) -> Dict[str, np.ndarray]:
        """``tokens`` (B, S) int32 and ``labels`` (B, S) int32, the tokens
        shifted by one."""
        rs = np.random.RandomState(step * 9176 + 17)
        out = np.zeros((batch_size, seq_len + 1), np.int32)
        state = rs.randint(0, self.n_states, batch_size)
        for t in range(seq_len + 1):
            u = rs.rand(batch_size, 1)
            cdf = np.cumsum(self.probs[state], 1)
            out[:, t] = (u < cdf).argmax(1)
            state = out[:, t] % self.n_states
        return {"tokens": out[:, :-1], "labels": out[:, 1:].astype(np.int32)}

    def stream(self, batch_size: int, seq_len: int,
               start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(batch_size, seq_len, step)
            step += 1
