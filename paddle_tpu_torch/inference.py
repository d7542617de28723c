"""Inference predictor API (reference: paddle/fluid/inference/api/ —
AnalysisConfig + AnalysisPredictor + create_paddle_predictor).

The port of the JAX package's ``inference.py``. A saved inference model
(``io.save_inference_model``'s ``__model__`` directory, or the int8
artifact of ``slim.calibration.save_int8_inference_model``) is loaded
once into a private Scope on ``CUDAPlace(0)`` (``Config.disable_gpu()``
opts into the CPU); each ``run`` goes through the Executor's compiled
step, which captures one CUDA graph per feed signature, the counterpart
of the JAX package's one executable per signature.
``Config.set_batch_buckets`` bounds those signatures to the bucket count;
``Config.enable_bf16`` runs the matmul-heavy ops in bf16.

Not ported yet: ``Config.enable_compile_cache`` (the persistent compile
cache and the flags plane) and ``Predictor.serving_engine`` (its
supervised engine); build a ``serving.ServingEngine(cfg, predictor)``
directly.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from paddle_tpu_torch import io as _io
from paddle_tpu_torch.executor import Executor, Scope, scope_guard
from paddle_tpu_torch.framework import CPUPlace, CUDAPlace
from paddle_tpu_torch.slim import calibration


class Config:
    """Predictor configuration (reference: AnalysisConfig)."""

    def __init__(self, model_dir: str,
                 model_filename: Optional[str] = None,
                 params_filename: Optional[str] = None):
        self.model_dir = model_dir
        self.model_filename = model_filename
        self.params_filename = params_filename
        self._use_gpu = True
        self._use_bf16 = False
        self._batch_buckets: tuple = ()

    def disable_gpu(self):
        """Run on the CPU (the JAX package's ``disable_tpu``)."""
        self._use_gpu = False
        return self

    def enable_bf16(self):
        """bf16 inference: the program's matmul-heavy ops run in bf16
        (amp.py's op sets)."""
        self._use_bf16 = True
        return self

    def set_batch_buckets(self, sizes):
        """Serve variable-size batches through a fixed set of batch
        shapes: ``run`` pads each batch up to the nearest bucket
        (chunking by the largest when it overflows), so the executor
        captures at most ``len(sizes)`` graphs instead of one per
        observed batch size."""
        sizes = sorted({int(s) for s in sizes})
        if not sizes or sizes[0] < 1:
            raise ValueError(f"batch buckets must be positive: {sizes}")
        self._batch_buckets = tuple(sizes)
        return self


class Predictor:
    """A loaded inference model and its executor (reference:
    AnalysisPredictor::Run)."""

    def __init__(self, config: Config):
        self._config = config
        self._closed = False
        self.scope = Scope()
        self._exe = Executor(CUDAPlace(0) if config._use_gpu else CPUPlace())
        with scope_guard(self.scope):
            if os.path.exists(os.path.join(config.model_dir,
                                           calibration.INT8_PARAMS_FILE)):
                # the int8 artifact: quantizable-op weights dequantized
                # from their int8 snapshot, the rest float32; the frozen
                # program carries the static-scale QDQ ops
                self.program, self._feed_names, self._fetch_vars = (
                    calibration.load_int8_inference_model(
                        config.model_dir, self._exe, scope=self.scope))
            else:
                self.program, self._feed_names, self._fetch_vars = (
                    _io.load_inference_model(
                        config.model_dir, self._exe,
                        model_filename=config.model_filename,
                        params_filename=config.params_filename))
        if config._use_bf16:
            self.program._amp = True

    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return [v.name for v in self._fetch_vars]

    def _as_feed(self, inputs) -> Dict[str, np.ndarray]:
        if isinstance(inputs, dict):
            feed = dict(inputs)
            missing = [n for n in self._feed_names if n not in feed]
            if missing:
                raise KeyError(f"missing inputs: {missing}")
            return feed
        if len(inputs) != len(self._feed_names):
            raise ValueError(
                f"expected {len(self._feed_names)} inputs "
                f"({self._feed_names}), got {len(inputs)}")
        return dict(zip(self._feed_names, inputs))

    def run(self, inputs: Union[Sequence[np.ndarray], Dict[str, np.ndarray]]
            ) -> List[np.ndarray]:
        """Positional (in ``get_input_names`` order) or name-keyed feeds
        -> the output arrays. The parameters stay on the device in the
        predictor's Scope. With ``Config.set_batch_buckets`` the batch is
        padded to the nearest bucket first."""
        feed = self._as_feed(inputs)
        if self._config._batch_buckets:
            return self._run_bucketed(feed)
        return self._run_exact(feed)

    def _run_exact(self, feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        if self._closed:
            raise RuntimeError("Predictor.run after close()")
        return self._exe.run(self.program, feed=feed,
                             fetch_list=self._fetch_vars, scope=self.scope)

    def _run_bucketed(self, feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        buckets = self._config._batch_buckets

        def pick(remaining: int):
            take = min(remaining, buckets[-1])
            return take, next(s for s in buckets if s >= take)

        return self._run_padded_chunks(feed, pick)

    def _run_padded_chunks(self, feed, pick) -> List[np.ndarray]:
        """Split the batch into chunks sized by ``pick(remaining) ->
        (take, padded_size)``, zero-pad each to its padded size, run,
        check every fetch is batch-major over that size, trim the
        padding, and concatenate (``run_batch`` and the bucketed run)."""
        n = int(np.shape(next(iter(feed.values())))[0])
        if n == 0:
            raise ValueError("run got an empty (0-row) batch")
        for k, v in feed.items():
            if np.shape(v)[0] != n:
                raise ValueError(
                    f"input '{k}' batch {np.shape(v)[0]} != {n}")
        outs: List[List[np.ndarray]] = []
        lo = 0
        while lo < n:
            take, b = pick(n - lo)
            chunk = {k: np.asarray(v)[lo:lo + take]
                     for k, v in feed.items()}
            if take < b:
                chunk = {
                    k: np.concatenate(
                        [v, np.zeros((b - take,) + v.shape[1:], v.dtype)])
                    for k, v in chunk.items()
                }
            res = [np.asarray(r) for r in self._run_exact(chunk)]
            for i, r in enumerate(res):
                if r.ndim == 0 or r.shape[0] != b:
                    raise ValueError(
                        f"fetch #{i} has shape {r.shape}, not "
                        f"batch-major over batch {b}; batch-aggregated "
                        f"or scalar outputs cannot be re-chunked — "
                        f"fetch them via an exact-shape run() instead")
            outs.append([r[:take] for r in res])
            lo += take
        if len(outs) == 1:
            return outs[0]
        return [np.concatenate([o[i] for o in outs])
                for i in range(len(self._fetch_vars))]

    def warmup(self, inputs=None, shapes: Optional[Dict[str, tuple]] = None,
               dtypes: Optional[Dict[str, str]] = None):
        """Run one batch before serving traffic (real sample ``inputs``,
        or zeros of ``shapes`` and ``dtypes``, float32 by default), so the
        signature's first, eager call is done. Returns self."""
        if inputs is None:
            if not shapes:
                raise ValueError("warmup needs inputs or shapes")
            inputs = {
                n: np.zeros(shapes[n], np.dtype((dtypes or {}).get(
                    n, "float32")))
                for n in self._feed_names
            }
        self.run(inputs)
        return self

    def run_batch(self, inputs: Union[Sequence[np.ndarray],
                                      Dict[str, np.ndarray]],
                  max_batch_size: int = 32) -> List[np.ndarray]:
        """Serve a batch of any size through one fixed signature: chunks
        of ``max_batch_size``, the tail zero-padded, the results
        concatenated with the padding dropped."""
        feed = self._as_feed(inputs)
        return self._run_padded_chunks(
            feed, lambda remaining: (min(remaining, max_batch_size),
                                     max_batch_size))

    def close(self):
        """Free the predictor's captured graphs and lowered programs and
        drop its parameters. Idempotent; a ``run`` after it raises."""
        if self._closed:
            return
        self._closed = True
        self._exe.close()
        self.scope.clear()


def create_predictor(config: Config) -> Predictor:
    """reference: create_paddle_predictor<AnalysisConfig>."""
    return Predictor(config)
