"""CIFAR-10/100 readers (reference: python/paddle/dataset/cifar.py).
Synthetic offline generator: 3x32x32 floats, learnable labels."""

from __future__ import annotations

import numpy as np

SHAPE = (3, 32, 32)


def _synthetic(n, num_classes, seed):
    dim = int(np.prod(SHAPE))
    probes = np.random.RandomState(11).randn(dim, num_classes)

    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            img = r.uniform(-1, 1, SHAPE).astype(np.float32)
            label = int(np.argmax(img.reshape(-1) @ probes))
            yield img.reshape(-1), label

    return reader


def train10(data_dir=None):
    return _synthetic(8192, 10, seed=3)


def test10(data_dir=None):
    return _synthetic(1024, 10, seed=4)


def train100(data_dir=None):
    return _synthetic(8192, 100, seed=5)


def test100(data_dir=None):
    return _synthetic(1024, 100, seed=6)
