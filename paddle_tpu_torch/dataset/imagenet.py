"""Synthetic ImageNet-shaped reader (reference:
benchmark/fluid/imagenet_reader.py, the benchmark harness's fake-data
mode). The same seeds give the same samples and batches as the JAX
package's reader; the batched variant feeds a training run without
per-sample Python overhead."""

from __future__ import annotations

import numpy as np

SHAPE = (3, 224, 224)
NUM_CLASSES = 1000


def train(n: int = 1024, seed: int = 21):
    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            img = r.uniform(-1, 1, SHAPE).astype(np.float32)
            yield img, int(r.randint(NUM_CLASSES))

    return reader


def batched(batch_size: int, steps: int, seed: int = 22,
            data_shape=SHAPE, class_dim=NUM_CLASSES):
    """Yields {feed_name: array} batches directly."""
    def reader():
        r = np.random.RandomState(seed)
        for _ in range(steps):
            yield {
                "data": r.uniform(
                    -1, 1, (batch_size,) + tuple(data_shape)
                ).astype(np.float32),
                "label": r.randint(
                    0, class_dim, (batch_size, 1)
                ).astype(np.int64),
            }

    return reader
