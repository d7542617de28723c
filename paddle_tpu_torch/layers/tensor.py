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

__all__ = ["create_global_var", "create_parameter", "fill_constant",
           "assign", "zeros_like", "range_", "slice", "create_tensor",
           "zeros", "ones", "ones_like", "linspace", "uniform_random",
           "gaussian_random", "shape"]


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


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A parameter of ``shape`` (``name`` when ``attr`` names none),
    initialized by the startup program."""
    from paddle_tpu_torch.param_attr import ParamAttr

    helper = LayerHelper("create_parameter", name=name)
    attr = ParamAttr._to_attr(attr)
    if name and attr.name is None:
        attr.name = name
    return helper.create_parameter(
        attr, shape, dtype, is_bias=is_bias,
        default_initializer=default_initializer,
    )


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


def range_(start, end, step, dtype):
    helper = LayerHelper("range")
    dtype = convert_np_dtype_to_dtype_(dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    stop_gradient=True)
    helper.append_op(
        "range", outputs={"Out": out},
        attrs={"start": start, "end": end, "step": step, "dtype": dtype},
    )
    return out


def slice(input, axes, starts, ends):
    """Static slicing: ``[start:end]`` on each of ``axes``."""
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        "slice", inputs={"X": input}, outputs={"Out": out},
        attrs={"axes": list(axes), "starts": list(starts),
               "ends": list(ends)},
    )
    return out


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.block.create_var(
        name=name or None, dtype=convert_np_dtype_to_dtype_(dtype),
        persistable=persistable)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def ones_like(x, out=None):
    helper = LayerHelper("fill_any_like")
    out = out or helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("fill_any_like", inputs={"X": x}, outputs={"Out": out},
                     attrs={"value": 1.0})
    return out


def linspace(start, stop, num, dtype="float32"):
    """``num`` values from start to stop as a ``range`` op over Python
    numbers (the JAX layer's composition)."""
    step = (stop - start) / max(num - 1, 1)
    return range_(start, stop + step / 2, step, dtype)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    """A ``uniform_random`` op (host-seeded: a block that holds one runs
    eagerly, see ops/tensor_ops.py)."""
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    stop_gradient=True)
    helper.append_op(
        "uniform_random", outputs={"Out": out},
        attrs={"shape": list(shape), "dtype": dtype, "min": float(min),
               "max": float(max), "seed": seed})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    """A ``gaussian_random`` op (host-seeded, as ``uniform_random``)."""
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    stop_gradient=True)
    helper.append_op(
        "gaussian_random", outputs={"Out": out},
        attrs={"shape": list(shape), "dtype": dtype, "mean": float(mean),
               "std": float(std), "seed": seed})
    return out


def shape(input):
    """The shape of ``input`` as an int64 tensor on the device."""
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op("shape", inputs={"X": input}, outputs={"Out": out})
    return out
