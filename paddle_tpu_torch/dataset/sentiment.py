"""NLTK movie-reviews sentiment reader (reference:
python/paddle/dataset/sentiment.py — 2000 polarity-labelled reviews).

Synthetic offline with the reference contract: ``train()``/``test()``
yield ``(word_ids, label)`` with label 0/1 and the corpus split sizes
(1600/400); ``get_word_dict()`` is frequency-ordered like the
reference's. Positive reviews oversample the upper token range, so
embedding+pool classifiers (book ch6) genuinely learn.
"""

from __future__ import annotations

import numpy as np

_VOCAB = 39768
NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000


def get_word_dict():
    """word -> id, ordered by (synthetic) frequency
    (reference: sentiment.py:56)."""
    return {f"w{i}": i for i in range(_VOCAB)}


def _reader(n, seed):
    def reader():
        r = np.random.RandomState(seed)
        half = _VOCAB // 2
        for _ in range(n):
            length = int(r.randint(30, 400))
            label = int(r.randint(0, 2))
            p_hi = 0.68 if label else 0.32
            hi = r.randint(half, _VOCAB, length)
            lo = r.randint(1, half, length)
            pick = r.rand(length) < p_hi
            yield np.where(pick, hi, lo).astype(np.int64).tolist(), label

    return reader


def train():
    return _reader(NUM_TRAINING_INSTANCES, 71)


def test():
    return _reader(NUM_TOTAL_INSTANCES - NUM_TRAINING_INSTANCES, 72)
