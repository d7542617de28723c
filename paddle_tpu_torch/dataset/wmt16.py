"""WMT16 en-de token-pair reader (reference: python/paddle/dataset/wmt16.py).

Synthetic offline generator: (src_ids, trg_ids, trg_next_ids) int sequences
with the reference's vocab contract (BOS=0, EOS=1, UNK=2) and a learnable
copy-ish mapping (trg token = f(src token)) so Transformer convergence tests
are meaningful. Lengths are bucketed for static shapes.
"""

from __future__ import annotations

import numpy as np

BOS, EOS, UNK = 0, 1, 2
RESERVED = 3


def _synthetic(n, src_vocab_size, trg_vocab_size, max_len, seed):
    # fixed random permutation mapping src token -> trg token
    perm = np.random.RandomState(13).permutation(
        max(src_vocab_size, trg_vocab_size)
    )

    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            length = int(r.randint(max(4, max_len // 4), max_len - 2))
            src = r.randint(RESERVED, src_vocab_size, length)
            trg_core = perm[src] % (trg_vocab_size - RESERVED) + RESERVED
            src_ids = np.concatenate([[BOS], src, [EOS]]).astype(np.int64)
            trg_ids = np.concatenate([[BOS], trg_core]).astype(np.int64)
            trg_next = np.concatenate([trg_core, [EOS]]).astype(np.int64)
            yield src_ids, trg_ids, trg_next

    return reader


def train(src_dict_size=10000, trg_dict_size=10000, src_lang="en", max_len=50):
    return _synthetic(20000, src_dict_size, trg_dict_size, max_len, seed=21)


def test(src_dict_size=10000, trg_dict_size=10000, src_lang="en", max_len=50):
    return _synthetic(1000, src_dict_size, trg_dict_size, max_len, seed=22)


def validation(src_dict_size=10000, trg_dict_size=10000, src_lang="en",
               max_len=50):
    return _synthetic(1000, src_dict_size, trg_dict_size, max_len, seed=23)
