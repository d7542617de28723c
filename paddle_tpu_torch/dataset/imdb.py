"""IMDB sentiment reader (reference: python/paddle/dataset/imdb.py).
Synthetic offline: word-id sequences whose label depends on the balance of
"positive" vs "negative" token ranges — learnable by embedding+pool models."""

from __future__ import annotations

import numpy as np


def word_dict(vocab_size: int = 5148):
    return {f"w{i}": i for i in range(vocab_size)}


def _synthetic(n, vocab_size, seed):
    def reader():
        r = np.random.RandomState(seed)
        half = vocab_size // 2
        for _ in range(n):
            length = int(r.randint(20, 200))
            label = int(r.randint(0, 2))
            # positive reviews draw 70% of tokens from the upper half
            p_hi = 0.7 if label else 0.3
            hi = r.randint(half, vocab_size, length)
            lo = r.randint(2, half, length)
            pick = r.rand(length) < p_hi
            ids = np.where(pick, hi, lo).astype(np.int64)
            yield ids, label

    return reader


def train(word_idx=None):
    n_words = len(word_idx) if word_idx else 5148
    return _synthetic(4096, n_words, seed=31)


def test(word_idx=None):
    n_words = len(word_idx) if word_idx else 5148
    return _synthetic(512, n_words, seed=32)
