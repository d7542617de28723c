"""MNIST reader (reference: python/paddle/dataset/mnist.py).

Loads real IDX files from ``data_dir`` if present; otherwise serves a
deterministic synthetic set with the same shapes (784 floats in [-1, 1],
label 0-9) so the book-chapter training tests and benchmarks run offline.
The synthetic task is learnable (label = argmax of 10 fixed random linear
probes of the image) so convergence tests are meaningful.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

IMAGE_SIZE = 784
NUM_CLASSES = 10


def _synthetic(n: int, seed: int):
    rng = np.random.RandomState(seed)
    probes = np.random.RandomState(7).randn(IMAGE_SIZE, NUM_CLASSES)

    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            img = r.uniform(-1, 1, IMAGE_SIZE).astype(np.float32)
            label = int(np.argmax(img @ probes))
            yield img, label

    return reader


def _idx_reader(image_path: str, label_path: str):
    def reader():
        with gzip.open(image_path, "rb") as fi, gzip.open(label_path, "rb") as fl:
            fi.read(16)
            fl.read(8)
            while True:
                lbl = fl.read(1)
                if not lbl:
                    break
                img = np.frombuffer(fi.read(IMAGE_SIZE), dtype=np.uint8)
                img = img.astype(np.float32) / 127.5 - 1.0
                yield img, int(lbl[0])

    return reader


def _make(split: str, n: int, seed: int, data_dir=None):
    if data_dir:
        prefix = "train" if split == "train" else "t10k"
        ip = os.path.join(data_dir, f"{prefix}-images-idx3-ubyte.gz")
        lp = os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte.gz")
        if os.path.exists(ip) and os.path.exists(lp):
            return _idx_reader(ip, lp)
    return _synthetic(n, seed)


def train(data_dir=None):
    return _make("train", 8192, seed=1, data_dir=data_dir)


def test(data_dir=None):
    return _make("test", 1024, seed=2, data_dir=data_dir)
