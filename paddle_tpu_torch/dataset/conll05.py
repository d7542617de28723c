"""CoNLL-2005 SRL reader (reference: python/paddle/dataset/conll05.py).

Synthetic offline with the reference record contract — 9 parallel
sequences per sentence::

    (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
     predicate_ids, mark, label_ids)

where the five ctx_* sequences broadcast the verb's +-2 window over the
sentence length, ``mark`` flags that window, and labels are BIO
argument tags. Labels are generated as a deterministic function of the
token and its distance to the predicate, so SRL models (book ch7)
genuinely learn.
"""

from __future__ import annotations

import numpy as np

UNK_IDX = 0

_WORD_VOCAB = 44068
_PRED_VOCAB = 3162
# 'O' + B-/I- over A0..A4, V, AM-* style slots: the reference label
# dict has 59 entries
_N_LABELS = 59


def get_dict():
    """(word_dict, verb_dict, label_dict) — reference: conll05.py:205."""
    word_dict = {f"w{i}": i for i in range(_WORD_VOCAB)}
    verb_dict = {f"v{i}": i for i in range(_PRED_VOCAB)}
    label_dict = {f"l{i}": i for i in range(_N_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Fixed word embedding table (reference: conll05.py:218 — the
    downloaded emb file; here a deterministic matrix)."""
    return np.random.RandomState(61).normal(
        0, 0.1, (_WORD_VOCAB, 32)).astype(np.float32)


def _label_for(word, dist):
    # BIO structure around the verb: near tokens -> argument tags tied
    # to the word id (learnable), far tokens -> O (label 0)
    if dist == 0:
        return 1  # B-V analog
    if abs(dist) <= 3:
        return 2 + (word + abs(dist)) % (_N_LABELS - 2)
    return 0


def _reader(n, seed):
    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            length = int(r.randint(5, 30))
            words = r.randint(1, _WORD_VOCAB, length)
            vi = int(r.randint(0, length))
            pred = int(words[vi] % _PRED_VOCAB)

            def ctx(off):
                j = vi + off
                return int(words[j]) if 0 <= j < length else UNK_IDX

            mark = [1 if abs(i - vi) <= 2 else 0 for i in range(length)]
            labels = [_label_for(int(w), i - vi)
                      for i, w in enumerate(words)]
            wl = words.tolist()
            yield (wl, [ctx(-2)] * length, [ctx(-1)] * length,
                   [ctx(0)] * length, [ctx(1)] * length,
                   [ctx(2)] * length, [pred] * length, mark, labels)

    return reader


def test():
    return _reader(1024, 62)


# the reference ships only a test split; a train split is provided so
# convergence tests have data of the same contract
def train():
    return _reader(8192, 63)
