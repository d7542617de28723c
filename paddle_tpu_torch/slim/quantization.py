"""Quantization: the QAT program pass and the int8 weight snapshot.

Reference: contrib/slim/quantization/quantization_pass.py —
``QuantizationTransformPass`` (:41) inserts fake quantize-dequantize ops
on the inputs of quantizable ops; ``ConvertToInt8Pass`` (:836) snapshots
trained weights as int8. As in the JAX package, the pass rewrites the
Program's op list, the scales are dynamic abs-max scales computed inside
the step (no scale state), and the straight-through estimator lives in
the op's expression (ops/quant_ops.py), so the derived grad ops give
STE gradients. The snapshot and its dequantization run in numpy on the
host, as there, so the dequantized weights equal the JAX package's bit
for bit.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.framework import Operator, Program
from paddle_tpu_torch.io import _to_numpy

# op type -> input slots to fake-quantize (activations and weights)
QUANTIZABLE = {
    "mul": ("X", "Y"),
    "matmul": ("X", "Y"),
    "conv2d": ("Input", "Filter"),
    "depthwise_conv2d": ("Input", "Filter"),
}


class QuantizationTransformPass:
    """Insert ``fake_quantize_dequantize`` on quantizable inputs
    (reference: quantization_pass.py:41 ``apply``)."""

    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 quantizable_op_types: Optional[Iterable[str]] = None):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.op_types = (
            dict(QUANTIZABLE)
            if quantizable_op_types is None
            else {t: QUANTIZABLE[t] for t in quantizable_op_types}
        )

    def apply(self, program: Program) -> int:
        """Rewrite ``program`` in place; returns the number of fake-quant
        ops inserted. Apply before ``append_backward`` / ``minimize`` so
        the quantization noise takes part in the training gradients."""
        n_inserted = 0
        block = program.global_block()
        # name -> its quantized replacement: a var feeding two quantizable
        # ops is quantized once
        quantized: Dict[str, str] = {}
        new_ops = []
        for op in block.ops:
            if op.type in self.op_types:
                for slot in self.op_types[op.type]:
                    names = op.inputs.get(slot, [])
                    for i, name in enumerate(names):
                        if not name:
                            continue
                        if name not in quantized:
                            var = block._find_var_recursive(name)
                            if var is None or var.dtype is None:
                                continue
                            q_name = unique_name.generate(name + ".quant")
                            block.create_var(
                                name=q_name, shape=var.shape,
                                dtype="float32",
                                stop_gradient=var.stop_gradient)
                            new_ops.append(Operator(
                                block, "fake_quantize_dequantize",
                                inputs={"X": [name]},
                                outputs={"Out": [q_name]},
                                attrs={"bits": self.weight_bits}))
                            quantized[name] = q_name
                            n_inserted += 1
                        op.inputs[slot][i] = quantized[name]
            new_ops.append(op)
        block.ops[:] = new_ops
        program._bump_version()
        return n_inserted


def quantize_weights_int8(
    program: Program, scope
) -> Dict[str, Tuple[np.ndarray, float]]:
    """Post-training quantization: the program's float parameters as
    symmetric per-tensor int8 and a scale, on the host (reference:
    quantization_pass.py:836 ``ConvertToInt8Pass``)."""
    out: Dict[str, Tuple[np.ndarray, float]] = {}
    for p in program.all_parameters():
        v = scope.find_var(p.name)
        if v is None:
            continue
        arr = _to_numpy(v)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        scale = float(np.max(np.abs(arr))) or 1.0
        q = np.clip(np.round(arr / scale * 127.0), -127, 127).astype(np.int8)
        out[p.name] = (q, scale)
    return out


def dequantize_weights(
    quantized: Dict[str, Tuple[np.ndarray, float]], scope
) -> None:
    """Int8 weights back into a scope as float32, dequantized on the host
    (the executor moves them to its device on first use)."""
    for name, (q, scale) in quantized.items():
        scope.set(name, (q.astype(np.float32) * scale / 127.0))
