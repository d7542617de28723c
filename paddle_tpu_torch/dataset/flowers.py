"""Flowers-102 reader (reference: python/paddle/dataset/flowers.py).
Synthetic offline generator (no egress): 3x224x224 floats, 102 classes
with learnable linear-probe labels, matching the reference benchmark's
input contract (benchmark/fluid/fluid_benchmark.py resnet-on-flowers)."""

from __future__ import annotations

import numpy as np

SHAPE = (3, 224, 224)
NUM_CLASSES = 102


def _synthetic(n, seed):
    # probe on a downsampled view to keep label computation cheap
    probes = np.random.RandomState(17).randn(3 * 16 * 16, NUM_CLASSES)

    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            img = r.uniform(-1, 1, SHAPE).astype(np.float32)
            small = img[:, ::14, ::14].reshape(-1)  # [3*16*16]
            label = int(np.argmax(small @ probes))
            yield img, label

    return reader


def train(data_dir=None, use_xmap=True):
    return _synthetic(2048, seed=7)


def test(data_dir=None, use_xmap=True):
    return _synthetic(256, seed=8)


def valid(data_dir=None, use_xmap=True):
    return _synthetic(256, seed=9)
