"""UCI housing regression reader (reference: python/paddle/dataset/uci_housing.py).
Synthetic offline: 13 features, linear target + noise."""

from __future__ import annotations

import numpy as np

FEATURES = 13
_W = np.random.RandomState(17).randn(FEATURES)


def _synthetic(n, seed):
    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            x = r.randn(FEATURES).astype(np.float32)
            y = np.float32(x @ _W + 0.1 * r.randn())
            yield x, np.array([y], dtype=np.float32)

    return reader


def train():
    return _synthetic(404, seed=41)


def test():
    return _synthetic(102, seed=42)
