"""Tensor creation layers."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.framework import Variable, convert_np_dtype_to_dtype_
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["fill_constant", "assign"]


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    dtype = convert_np_dtype_to_dtype_(dtype)
    out = out or helper.create_variable_for_type_inference(
        dtype=dtype, stop_gradient=True)
    helper.append_op(
        "fill_constant",
        outputs={"Out": out},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value)},
    )
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        output = output or helper.create_variable_for_type_inference(
            dtype=input.dtype)
        helper.append_op("assign", inputs={"X": input}, outputs={"Out": output})
    else:
        arr = np.asarray(input)
        output = output or helper.create_variable_for_type_inference(
            dtype=arr.dtype.name)
        helper.append_op(
            "assign_value",
            outputs={"Out": output},
            attrs={
                "shape": list(arr.shape),
                "dtype": arr.dtype.name,
                "values": [float(x) for x in arr.reshape(-1)],
            },
        )
    return output
