"""Dataset API: in-memory and streaming dataset containers
(reference: python/paddle/fluid/dataset.py — DatasetFactory:21,
InMemoryDataset:215 with local/global shuffle:262, QueueDataset; C++
side framework/data_set.h:40,101 and the MultiSlotDataFeed channel
pipeline, framework/data_feed.h:353).

The JAX package's containers, host numpy only: datasets produce numpy
batches for the executor's step, files parse in worker processes
(multiprocess_reader), and a seeded shuffle gives the JAX package's
order. A global shuffle across several fleet workers waits for the
port's parallel modules (ROADMAP.md Queue 1, item 9); one worker
shuffles locally.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np


class DatasetFactory:
    """reference: fluid/dataset.py DatasetFactory.create_dataset."""

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError(f"unknown dataset class {datafeed_class!r}")


class DatasetBase:
    def __init__(self):
        self._filelist: List[str] = []
        self._parse_fn: Optional[Callable] = None
        self._batch_size = 1
        self._thread_num = 1
        self._use_var_names: List[str] = []

    # --- reference-parity configuration surface ---

    def set_filelist(self, filelist: Sequence[str]):
        self._filelist = list(filelist)

    def set_batch_size(self, batch_size: int):
        self._batch_size = int(batch_size)

    def set_thread(self, thread_num: int):
        self._thread_num = max(1, int(thread_num))

    def set_use_var(self, var_list):
        self._use_var_names = [
            v.name if hasattr(v, "name") else str(v) for v in var_list
        ]

    def set_parse_fn(self, fn: Callable[[str], Iterable[tuple]]):
        """``fn(line) -> sample tuple`` aligned with set_use_var order
        (replaces the reference's MultiSlotDataFeed proto config)."""
        self._parse_fn = fn

    # --- iteration ---

    def _sample_reader(self):
        if self._parse_fn is None:
            raise RuntimeError("set_parse_fn before iterating the dataset")

        def reader():
            for path in self._filelist:
                with open(path) as f:
                    for line in f:
                        line = line.rstrip("\n")
                        if line:
                            yield self._parse_fn(line)

        return reader

    def batch_reader(self):
        """-> callable yielding {var_name: stacked numpy batch}."""
        sample_reader = self._shuffled_reader()
        names = self._use_var_names

        def reader():
            buf: List[tuple] = []
            for s in sample_reader():
                buf.append(s)
                if len(buf) == self._batch_size:
                    yield self._stack(buf, names)
                    buf = []
            if buf:
                yield self._stack(buf, names)

        return reader

    @staticmethod
    def _stack(samples, names) -> Dict[str, np.ndarray]:
        cols = list(zip(*samples))
        if names and len(names) != len(cols):
            raise ValueError(
                f"samples have {len(cols)} slots but {len(names)} use_vars"
            )
        out = {}
        for i, col in enumerate(cols):
            key = names[i] if names else str(i)
            out[key] = np.stack([np.asarray(v) for v in col])
        return out

    def _shuffled_reader(self):
        return self._sample_reader()


class QueueDataset(DatasetBase):
    """Streaming dataset: files parse on worker processes and stream
    through a queue (reference: QueueDataset over MultiSlotDataFeed
    channels). No shuffle beyond file order."""

    def _shuffled_reader(self):
        if self._thread_num <= 1 or len(self._filelist) <= 1:
            return self._sample_reader()
        from paddle_tpu_torch.reader.decorator import multiprocess_reader

        per_worker = [
            self._filelist[i :: self._thread_num]
            for i in range(min(self._thread_num, len(self._filelist)))
        ]
        parse = self._parse_fn

        def make(files):
            def r():
                for path in files:
                    with open(path) as f:
                        for line in f:
                            line = line.rstrip("\n")
                            if line:
                                yield parse(line)

            return r

        return multiprocess_reader([make(fs) for fs in per_worker if fs])


class InMemoryDataset(DatasetBase):
    """Loads all samples to memory; supports local and fleet-wide global
    shuffle (reference: InMemoryDataset.load_into_memory /
    local_shuffle / global_shuffle:262)."""

    def __init__(self):
        super().__init__()
        self._samples: Optional[List[tuple]] = None
        self._seed = 0

    def load_into_memory(self):
        self._samples = list(self._sample_reader()())

    def set_shuffle_seed(self, seed: int):
        self._seed = int(seed)

    def local_shuffle(self):
        if self._samples is None:
            raise RuntimeError("load_into_memory before local_shuffle")
        random.Random(self._seed).shuffle(self._samples)

    def global_shuffle(self, fleet=None):
        """A single-worker fleet (or none) shuffles locally, as in the
        JAX package; exchanging shards across several workers waits for
        the port's fleet (ROADMAP.md Queue 1, item 9)."""
        if self._samples is None:
            raise RuntimeError("load_into_memory before global_shuffle")
        if fleet is None or fleet.worker_num() <= 1:
            self.local_shuffle()
            return
        raise NotImplementedError(
            "InMemoryDataset.global_shuffle across several fleet workers "
            "needs the port's fleet (ROADMAP.md Queue 1, item 9)")

    def release_memory(self):
        self._samples = None

    def _shuffled_reader(self):
        if self._samples is None:
            return self._sample_reader()
        samples = self._samples

        def reader():
            yield from samples

        return reader
