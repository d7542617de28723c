"""WMT14 en-fr reader (reference: python/paddle/dataset/wmt14.py).

Synthetic offline sharing the wmt16 generator machinery (same
BOS=0/EOS=1/UNK=2 contract, learnable token mapping) with the wmt14
API: ``train(dict_size)``/``test(dict_size)`` yield
``(src_ids, trg_ids, trg_next_ids)``; ``get_dict(dict_size, reverse)``
returns the (src, trg) vocabularies.
"""

from __future__ import annotations

from paddle_tpu_torch.dataset import wmt16 as _wmt16

BOS, EOS, UNK = _wmt16.BOS, _wmt16.EOS, _wmt16.UNK


def train(dict_size):
    return _wmt16._synthetic(19200, dict_size, dict_size, max_len=50,
                             seed=81)


def test(dict_size):
    return _wmt16._synthetic(960, dict_size, dict_size, max_len=50,
                             seed=82)


def gen(dict_size):
    return _wmt16._synthetic(960, dict_size, dict_size, max_len=50,
                             seed=83)


def get_dict(dict_size, reverse=True):
    """(src_dict, trg_dict); reverse=True gives id -> token
    (reference: wmt14.py:156)."""
    if reverse:
        d = {i: f"tok{i}" for i in range(dict_size)}
        for i, name in ((BOS, "<s>"), (EOS, "<e>"), (UNK, "<unk>")):
            d[i] = name
        return d, dict(d)
    d = {f"tok{i}": i for i in range(dict_size)}
    d.update({"<s>": BOS, "<e>": EOS, "<unk>": UNK})
    return d, dict(d)
