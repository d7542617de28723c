"""DataFeeder: sample lists -> feed dict of dense numpy batches
(reference: python/paddle/fluid/data_feeder.py).

The JAX package's feeder, host numpy only. LoD conversion is replaced by
pad-to-bucket: a variable-length sequence field is padded to a fixed
bucket and a companion ``<name>_len`` int array carries the true lengths,
so every batch has one feed signature (one captured step).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch import monitor as _monitor
from paddle_tpu_torch.framework import Variable


class DataFeeder:
    """``pad_to`` declares ragged fields: {var_name: bucket_len}. A declared
    field is ALWAYS padded/truncated to its bucket and always emits a
    companion ``<name>_len`` int64 array — fixed shapes (one captured step),
    no batch-dependent feed signature."""

    def __init__(
        self,
        feed_list: Sequence[Variable],
        place=None,
        program=None,
        pad_to: Optional[Dict[str, int]] = None,
    ):
        self.feed_vars = list(feed_list)
        self.place = place
        self.pad_to = dict(pad_to or {})

    def feed(self, iterable,
             critical_path: bool = True) -> Dict[str, np.ndarray]:
        """iterable: list of samples; each sample is a tuple aligned with
        feed_list. Returns {name: batched ndarray} (+ ``name_len`` for fields
        declared in ``pad_to``).

        With telemetry on, the batch-assembly time feeds
        ``pt_feed_build_seconds`` and — on the critical path — the
        boundedness verdict's input score: batching on the step loop's
        critical path is input-pipeline time even though nothing
        'waits'. Pass ``critical_path=False`` from a prefetch worker
        (overlapped assembly must not fake an input_bound verdict; the
        consumer's queue wait is the honest signal there)."""
        if not _monitor.enabled():
            return self._feed(iterable)
        t0 = time.perf_counter()
        out = self._feed(iterable)
        _monitor.feed_build(time.perf_counter() - t0,
                            critical_path=critical_path)
        return out

    def _feed(self, iterable) -> Dict[str, np.ndarray]:
        columns: List[List] = [[] for _ in self.feed_vars]
        for sample in iterable:
            if len(sample) != len(self.feed_vars):
                raise ValueError(
                    f"sample has {len(sample)} fields, expected "
                    f"{len(self.feed_vars)}"
                )
            for c, v in zip(columns, sample):
                c.append(np.asarray(v))
        out: Dict[str, np.ndarray] = {}
        for var, col in zip(self.feed_vars, columns):
            if var.name in self.pad_to:
                bucket = self.pad_to[var.name]
                tail = col[0].shape[1:]
                batch = np.zeros((len(col), bucket) + tail, dtype=col[0].dtype)
                lengths = np.zeros((len(col),), dtype=np.int64)
                for i, a in enumerate(col):
                    n = min(a.shape[0], bucket)
                    batch[i, :n] = a[:n]
                    lengths[i] = n
                out[var.name + "_len"] = lengths
            else:
                shapes = {a.shape for a in col}
                if len(shapes) != 1:
                    raise ValueError(
                        f"feed field '{var.name}' is ragged {sorted(shapes)[:3]}; "
                        f"declare it in DataFeeder(pad_to={{'{var.name}': L}}) "
                        f"to pad to a fixed bucket (a captured step needs static shapes)"
                    )
                batch = np.stack(col)
            dtype = np.dtype(var.dtype) if var.dtype else batch.dtype
            if batch.dtype != dtype:
                batch = batch.astype(dtype)
            want = var.shape
            if want is not None and len(want) == batch.ndim + 1 and want[-1] == 1:
                batch = batch[..., None]  # label column convention [N] -> [N,1]
            out[var.name] = batch
        return out
