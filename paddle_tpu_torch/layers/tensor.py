"""Tensor creation layers."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.framework import (
    Variable,
    convert_np_dtype_to_dtype_,
    default_main_program,
    default_startup_program,
)
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["create_global_var", "fill_constant", "assign", "zeros_like"]


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A persistable var initialized in the startup program
    (``force_cpu`` is taken for the JAX package's signature; the var lives
    with the rest of the state, as there)."""
    name = name or unique_name.generate("global_var")
    dtype = convert_np_dtype_to_dtype_(dtype)
    sb = default_startup_program().global_block()
    sb.create_var(name=name, shape=shape, dtype=dtype,
                  persistable=persistable)
    sb.append_op(
        "fill_constant",
        outputs={"Out": name},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value)},
    )
    mb = default_main_program().global_block()
    return mb.create_var(name=name, shape=shape, dtype=dtype,
                         persistable=persistable)


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


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    out = out or helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("fill_zeros_like", inputs={"X": x}, outputs={"Out": out})
    return out
