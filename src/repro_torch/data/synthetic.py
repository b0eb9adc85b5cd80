"""Deterministic synthetic token stream (seeded Zipfian with Markov-ish
structure so tiny models can actually reduce loss on it): the port's own
copy of the JAX package's ``data/synthetic.py``, bit for bit."""

from __future__ import annotations

import numpy as np


class SyntheticStream:
    """Seeded, restartable token stream.

    Tokens follow a Zipf marginal with a first-order structure: with
    probability ``repeat_p`` the next token is a deterministic function of the
    previous one, which gives a learnable conditional distribution.
    """

    def __init__(self, vocab_size: int, seed: int = 0, zipf_a: float = 1.2,
                 repeat_p: float = 0.5):
        self.vocab_size = vocab_size
        self.seed = seed
        self.zipf_a = zipf_a
        self.repeat_p = repeat_p
        # precompute zipf pmf truncated to vocab
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        pmf = ranks ** (-zipf_a)
        self._pmf = pmf / pmf.sum()

    def batch(self, step: int, batch: int, seq_len: int) -> np.ndarray:
        """[batch, seq_len+1] int32 tokens, deterministic in (seed, step)."""
        rng = np.random.default_rng((self.seed, step))
        n = batch * (seq_len + 1)
        iid = rng.choice(self.vocab_size, size=n, p=self._pmf)
        use_prev = rng.random(n) < self.repeat_p
        out = iid.copy()
        # structured transition: t -> (3 t + 7) mod V
        prev = np.roll(out, 1)
        out = np.where(use_prev, (3 * prev + 7) % self.vocab_size, out)
        return out.reshape(batch, seq_len + 1).astype(np.int32)
