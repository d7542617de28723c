"""Post-training int8 calibration of activation ranges, and the int8
artifact.

Reference: contrib/int8_inference/utility.py (``Calibrator``: sample the
activations over warmup batches, a per-tensor scale by abs-max or by
KL divergence) and contrib/slim/quantization/quantization_pass.py:541
(``QuantizationFreezePass``) / :836 (``ConvertToInt8Pass``). As in the
JAX package: the warmup batches run through the Executor (on its
device), their activations come to the host and the scale search runs
there in numpy (copied, so equal activations give equal scales); the
frozen program carries static-scale quantize-dequantize ops at the
quantizable ops' inputs, so serving numerics are those of an int8
deployment; the artifact is the frozen ``__model__``, the weights of
quantizable ops as int8 (``__params_int8__.npz``) with their scales
(``__int8_scales__.json``), and every other persistable (batch-norm
statistics, biases, embeddings) in float32.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.framework import Operator, Program
from paddle_tpu_torch.slim.quantization import QUANTIZABLE

# the int8 artifact's files beside the __model__ export's; the int8 file
# marks a directory as the int8 artifact
INT8_PARAMS_FILE = "__params_int8__.npz"
_INT8_SCALES_FILE = "__int8_scales__.json"


def _abs_max_scale(samples: List[np.ndarray]) -> float:
    return float(max((np.max(np.abs(s)) for s in samples), default=1.0)) \
        or 1.0


def _kl_scale(samples: List[np.ndarray], bins: int = 2048,
              target_bins: int = 128) -> float:
    """The reference Calibrator's 'KL' algo: the clip threshold that
    minimizes KL(P||Q) between the |x| histogram and its int8 rendition
    (the TensorRT-style sweep)."""
    amax = _abs_max_scale(samples)
    hist = np.zeros(bins, np.float64)
    for s in samples:
        h, _ = np.histogram(np.abs(s), bins=bins, range=(0, amax))
        hist += h
    return _kl_from_hist(hist, amax, bins, target_bins)


def _kl_from_hist(hist: np.ndarray, amax: float, bins: int = 2048,
                  target_bins: int = 128) -> float:
    """The KL threshold sweep over a built |x| histogram on (0, amax)."""
    total = hist.sum()
    if total == 0:
        return amax
    best_div, best_i = np.inf, bins
    for i in range(target_bins, bins + 1, 16):
        p = hist[:i].copy()
        p[i - 1] += hist[i:].sum()  # outliers clipped into the last bin
        p /= p.sum()
        # the i fp32 bins quantized down to target_bins int8 levels
        factor = i / target_bins
        q = np.zeros(i, np.float64)
        for j in range(target_bins):
            lo, hi = int(j * factor), int((j + 1) * factor)
            hi = max(hi, lo + 1)
            chunk = hist[lo:hi]
            nz = (chunk > 0).sum()
            if nz:
                q[lo:hi] = np.where(chunk > 0, chunk.sum() / nz, 0)
        qs = q.sum()
        if qs == 0:
            continue
        q /= qs
        mask = p > 0
        div = float(np.sum(p[mask] * np.log(
            p[mask] / np.maximum(q[mask], 1e-12))))
        if div < best_div:
            best_div, best_i = div, i
    return amax * best_i / bins


class Calibrator:
    """Activation ranges of an inference program's quantizable-op inputs
    over warmup batches, then the int8-annotated program.

    Usage::

        calib = Calibrator(infer_prog, exe, algo="abs_max")
        for batch in warmup_batches:
            calib.sample(feed=batch)            # runs + samples
        scales = calib.compute_scales()
        int8_prog = calib.freeze()              # static-scale QDQ baked
    """

    _FINE_BINS = 8192

    def __init__(self, program: Program, exe, scope=None,
                 algo: str = "abs_max",
                 op_types: Optional[Iterable[str]] = None):
        if algo not in ("abs_max", "KL"):
            raise ValueError(f"algo must be 'abs_max' or 'KL', got {algo}")
        self.program = program
        self.exe = exe
        self.scope = scope
        self.algo = algo
        self.op_types = dict(QUANTIZABLE) if op_types is None else {
            t: QUANTIZABLE[t] for t in op_types}
        block = program.global_block()
        persistable = {n for n, v in block.vars.items()
                       if getattr(v, "persistable", False)}
        # the quantizable slots' inputs: non-persistable ones are the
        # activations to calibrate; persistable ones the weights that
        # save_int8_inference_model snapshots as int8 (only weights that
        # feed quantized ops, as the reference's ConvertToInt8Pass)
        names: List[str] = []
        wnames: List[str] = []
        for op in block.ops:
            if op.type not in self.op_types:
                continue
            for slot in self.op_types[op.type]:
                for n in op.inputs.get(slot, []):
                    if not n:
                        continue
                    dst = wnames if n in persistable else names
                    if n not in dst:
                        dst.append(n)
        self.activation_names = names
        self.weight_names = wnames
        # bounded memory: abs_max keeps a running max a tensor; KL one
        # fine |x| histogram a batch, rebinned onto the global amax grid
        # at compute time (at most one fine bin of error, amax / 8192)
        self._amax: Dict[str, float] = {n: 0.0 for n in names}
        self._hists: Dict[str, List[Tuple[np.ndarray, float]]] = {
            n: [] for n in names}
        self._seen = False
        self._scales: Optional[Dict[str, float]] = None

    def sample(self, feed: Dict[str, np.ndarray]) -> None:
        """Run one warmup batch and record the activation ranges."""
        outs = self.exe.run(self.program, feed=feed,
                            fetch_list=list(self.activation_names),
                            scope=self.scope)
        self._seen = True
        for name, val in zip(self.activation_names, outs):
            a = np.abs(np.asarray(val, dtype=np.float32))
            bmax = float(a.max()) if a.size else 0.0
            self._amax[name] = max(self._amax[name], bmax)
            if self.algo == "KL":
                h, _ = np.histogram(a, bins=self._FINE_BINS,
                                    range=(0, bmax or 1.0))
                self._hists[name].append((h.astype(np.float64), bmax))

    def compute_scales(self) -> Dict[str, float]:
        if not self._seen:
            self._scales = {}
            return {}
        if self.algo == "abs_max":
            self._scales = {n: (m or 1.0) for n, m in self._amax.items()}
            return dict(self._scales)
        scales: Dict[str, float] = {}
        for name, batches in self._hists.items():
            amax = self._amax[name] or 1.0
            hist = np.zeros(2048, np.float64)
            for h, bmax in batches:
                if bmax <= 0:
                    continue
                centers = (np.arange(self._FINE_BINS) + 0.5) * (
                    bmax / self._FINE_BINS)
                idx = np.minimum(
                    (centers / amax * 2048).astype(np.int64), 2047)
                np.add.at(hist, idx, h)
            scales[name] = _kl_from_hist(hist, amax)
        self._scales = scales
        return dict(scales)

    def freeze(self) -> Program:
        """A new program with a static-scale quantize-dequantize op on
        every calibrated activation edge (the QuantizationFreezePass
        counterpart: scales are attrs, no scale state)."""
        if self._scales is None:
            self.compute_scales()
        prog = self.program.clone()
        block = prog.global_block()
        done: Dict[str, str] = {}
        new_ops = []
        for op in block.ops:
            if op.type in self.op_types:
                for slot in self.op_types[op.type]:
                    names = op.inputs.get(slot, [])
                    for i, name in enumerate(names):
                        scale = (self._scales or {}).get(name)
                        if scale is None:
                            continue
                        if name not in done:
                            var = block._find_var_recursive(name)
                            q = unique_name.generate(name + ".calib")
                            block.create_var(
                                name=q, shape=var.shape, dtype="float32",
                                stop_gradient=True)
                            new_ops.append(Operator(
                                block, "quantize_dequantize_static",
                                inputs={"X": [name]},
                                outputs={"Out": [q]},
                                attrs={"scale": float(scale), "bits": 8}))
                            done[name] = q
                        op.inputs[slot][i] = done[name]
            new_ops.append(op)
        block.ops[:] = new_ops
        prog._bump_version()
        return prog


def save_int8_inference_model(dirname: str, feed_names: Sequence[str],
                              fetch_targets, exe,
                              program: Optional[Program],
                              calibrator: Calibrator, scope=None) -> None:
    """Export the int8 serving artifact: the frozen program, the weights
    of quantizable ops as symmetric per-tensor int8 with their scales,
    and every other persistable in float32 (reference:
    Calibrator.save_int8_model in int8_inference/utility.py)."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.executor import global_scope, scope_guard
    from paddle_tpu_torch.slim.quantization import quantize_weights_int8

    if program is not None and program is not calibrator.program:
        raise ValueError(
            "program must be the calibrator's program (the frozen "
            "artifact is built from calibrator.freeze()); pass "
            "program=None or the same object")
    scope = scope or global_scope()
    frozen = calibrator.freeze()
    os.makedirs(dirname, exist_ok=True)
    with scope_guard(scope):
        io.save_inference_model(dirname, list(feed_names), fetch_targets,
                                exe, frozen)
    # int8 only for the weights of quantizable ops; batch-norm statistics
    # (a small range, which symmetric int8 crushes to 0 before an rsqrt),
    # biases and every other persistable stay float32
    wset = set(calibrator.weight_names)
    qweights = {n: qs for n, qs in quantize_weights_int8(frozen, scope)
                .items() if n in wset}
    np.savez(os.path.join(dirname, INT8_PARAMS_FILE),
             **{n: q for n, (q, _) in qweights.items()})
    meta = {"weight_scales": {n: s for n, (_, s) in qweights.items()},
            "activation_scales": calibrator._scales or {}}
    with open(os.path.join(dirname, _INT8_SCALES_FILE), "w") as f:
        json.dump(meta, f)
    # the float32 params file without the int8 weights
    ppath = os.path.join(dirname, io.PARAMS_FILE)
    with np.load(ppath) as fp32:
        keep = {n: fp32[n] for n in fp32.files if n not in qweights}
    np.savez(ppath, **keep)


def load_int8_inference_model(dirname: str, exe, scope=None):
    """Load an int8 artifact into ``scope`` (the current one when None):
    the float32 persistables from the params file, the int8 weights
    dequantized on the host (``dequantize_weights``); every value a
    tensor on ``exe``'s device, or the host arrays when ``exe`` is None.
    Returns (program, feed_names, fetch_vars), as
    ``io.load_inference_model`` does."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.executor import global_scope
    from paddle_tpu_torch.slim.quantization import dequantize_weights

    scope = scope or global_scope()
    with open(os.path.join(dirname, io._MODEL_FILE), "rb") as f:
        prog = Program.parse_from_string(f.read())
    with open(os.path.join(dirname, io._META_FILE)) as f:
        io_meta = json.load(f)
    with open(os.path.join(dirname, _INT8_SCALES_FILE)) as f:
        meta = json.load(f)
    loaded = []
    ppath = os.path.join(dirname, io.PARAMS_FILE)
    if os.path.exists(ppath):
        with np.load(ppath) as fp32:
            for name in fp32.files:
                scope.set(name, fp32[name])
                loaded.append(name)
    with np.load(os.path.join(dirname, INT8_PARAMS_FILE)) as qs:
        quantized = {n: (qs[n], meta["weight_scales"][n]) for n in qs.files}
    dequantize_weights(quantized, scope)
    if exe is not None:
        for name in loaded + list(quantized):
            scope.set(name, io._to_tensor(scope.find_var(name), exe.device))
    fetch_vars = [prog.global_block().var(n)
                  for n in io_meta["fetch_names"]]
    return prog, io_meta["feed_names"], fetch_vars
