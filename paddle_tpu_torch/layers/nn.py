"""NN layer functions. Each builds vars + appends ops via LayerHelper."""

from __future__ import annotations

import math
from typing import Optional, Sequence

from paddle_tpu_torch.framework import Variable, convert_np_dtype_to_dtype_
from paddle_tpu_torch.initializer import ConstantInitializer
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = [
    "fc", "embedding", "layer_norm", "dropout", "relu", "abs",
    "softmax_with_cross_entropy", "label_smooth", "elementwise_op",
    "elementwise_add", "elementwise_mul", "elementwise_div",
    "elementwise_max", "reduce_sum", "reduce_max", "scale", "cast",
    "fill_constant_like", "one_hot", "argmax", "equal", "less_than",
    "logical_and", "logical_not", "where", "reshape", "split", "unsqueeze",
    "scatter",
]


def _single_op(op_type, x, attrs=None, dtype=None, slot_in="X", slot_out="Out",
               name=None, stop_gradient=False):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(
        dtype=dtype or x.dtype, stop_gradient=stop_gradient
    )
    helper.append_op(
        op_type, inputs={slot_in: x}, outputs={slot_out: out}, attrs=attrs or {}
    )
    return out


# --- dense layers ---


def fc(
    input: Variable,
    size: int,
    num_flatten_dims: int = 1,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    name: Optional[str] = None,
):
    """Fully-connected layer: ``mul`` + bias add + activation."""
    helper = LayerHelper("fc", name=name, bias_attr=bias_attr, act=act)
    in_features = math.prod(input.shape[num_flatten_dims:])
    w = helper.create_parameter(
        ParamAttr._to_attr(param_attr), shape=[in_features, size],
        dtype=input.dtype,
    )
    pre_bias = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        "mul",
        inputs={"X": input, "Y": w},
        outputs={"Out": pre_bias},
        attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(
    input: Variable,
    size: Sequence[int],
    padding_idx: Optional[int] = None,
    param_attr=None,
    dtype: str = "float32",
    name: Optional[str] = None,
):
    """Embedding lookup over padded [b, t] ids."""
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(
        ParamAttr._to_attr(param_attr), shape=list(size), dtype=dtype
    )
    out = helper.create_variable_for_type_inference(dtype=dtype)
    # Padded [b, t] ids convention: never squeeze, even when t == 1 (the
    # op's squeeze heuristic exists for [N, 1] column ids).
    attrs = {"squeeze_last": False}
    if padding_idx is not None:
        attrs["padding_idx"] = int(padding_idx)
    helper.append_op(
        "lookup_table",
        inputs={"W": w, "Ids": input},
        outputs={"Out": out},
        attrs=attrs,
    )
    return out


def layer_norm(
    input,
    scale=True,
    shift=True,
    begin_norm_axis=1,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    helper = LayerHelper("layer_norm", name=name, act=act)
    feat = math.prod(input.shape[begin_norm_axis:])
    inputs = {"X": input}
    if scale:
        inputs["Scale"] = helper.create_parameter(
            ParamAttr._to_attr(param_attr), shape=[feat], dtype=input.dtype,
            default_initializer=ConstantInitializer(1.0),
        )
    if shift:
        inputs["Bias"] = helper.create_parameter(
            ParamAttr._to_attr(bias_attr), shape=[feat], dtype=input.dtype,
            is_bias=True,
        )
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    m = helper.create_variable_for_type_inference(dtype=input.dtype, stop_gradient=True)
    v = helper.create_variable_for_type_inference(dtype=input.dtype, stop_gradient=True)
    helper.append_op(
        "layer_norm",
        inputs=inputs,
        outputs={"Y": out, "Mean": m, "Variance": v},
        attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon},
    )
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """Randomly zero elements of ``x`` with probability ``dropout_prob``
    (``upscale_in_train``: kept elements scaled by 1/(1 - p) in
    training; ``downgrade_in_infer``: outputs scaled by (1 - p) at test
    time). The keep mask is saved for the backward pass."""
    if dropout_implementation not in ("downgrade_in_infer",
                                      "upscale_in_train"):
        raise ValueError(
            f"dropout_implementation {dropout_implementation!r}: expected "
            f"'downgrade_in_infer' or 'upscale_in_train'")
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    mask = helper.create_variable_for_type_inference(dtype="uint8",
                                                     stop_gradient=True)
    helper.append_op(
        "dropout", inputs={"X": x}, outputs={"Out": out, "Mask": mask},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed if seed is not None else 0,
               "dropout_implementation": dropout_implementation})
    return out


# --- activations ---


def relu(x, name=None):
    return _single_op("relu", x, name=name)


def abs(x, name=None):
    return _single_op("abs", x, name=name)


# --- losses ---


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(dtype=logits.dtype)
    loss = helper.create_variable_for_type_inference(dtype=logits.dtype)
    helper.append_op(
        "softmax_with_cross_entropy",
        inputs={"Logits": logits, "Label": label},
        outputs={"Softmax": softmax_out, "Loss": loss},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    if return_softmax:
        return loss, softmax_out
    return loss


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32", name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    inputs = {"X": label}
    if prior_dist is not None:
        inputs["PriorDist"] = prior_dist
    helper.append_op(
        "label_smooth", inputs=inputs, outputs={"Out": out},
        attrs={"epsilon": float(epsilon)},
    )
    return out


# --- math wrappers ---


def elementwise_op(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        op_type, inputs={"X": x, "Y": y}, outputs={"Out": out}, attrs={"axis": axis}
    )
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_add", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_max", x, y, axis, act, name)


def _reduce(op_type, input, dim, keep_dim, name):
    attrs = {"keep_dim": keep_dim}
    if dim is None:
        attrs["reduce_all"] = True
    else:
        attrs["dim"] = [dim] if isinstance(dim, int) else list(dim)
    return _single_op(op_type, input, attrs=attrs, name=name)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        "scale",
        inputs={"X": x},
        outputs={"Out": out},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out)


def cast(x, dtype):
    dtype = convert_np_dtype_to_dtype_(dtype)
    return _single_op("cast", x, attrs={"out_dtype": dtype}, dtype=dtype)


def fill_constant_like(x, value):
    helper = LayerHelper("fill_any_like")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        "fill_any_like", inputs={"X": x}, outputs={"Out": out},
        attrs={"value": float(value)},
    )
    return out


# --- indexing / comparison ---


def one_hot(input, depth, dtype="float32"):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference(dtype=dtype, stop_gradient=True)
    helper.append_op(
        "one_hot", inputs={"X": input}, outputs={"Out": out},
        attrs={"depth": depth, "dtype": dtype},
    )
    return out


def argmax(x, axis=0, name=None):
    return _single_op("arg_max", x, attrs={"axis": axis}, dtype="int64",
                      stop_gradient=True, name=name)


def _compare(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    out = cond or helper.create_variable_for_type_inference(
        dtype="bool", stop_gradient=True)
    helper.append_op(op_type, inputs={"X": x, "Y": y}, outputs={"Out": out})
    return out


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def less_than(x, y, cond=None):
    return _compare("less_than", x, y, cond)


def logical_and(x, y, out=None, name=None):
    return _compare("logical_and", x, y, out)


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not")
    out = out or helper.create_variable_for_type_inference(
        dtype="bool", stop_gradient=True)
    helper.append_op("logical_not", inputs={"X": x}, outputs={"Out": out})
    return out


def where(condition, x, y, name=None):
    helper = LayerHelper("where", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        "where", inputs={"Condition": condition, "X": x, "Y": y},
        outputs={"Out": out},
    )
    return out


# --- shape manipulation ---


def reshape(x, shape, act=None, name=None):
    helper = LayerHelper("reshape2", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        "reshape2", inputs={"X": x}, outputs={"Out": out},
        attrs={"shape": list(shape)},
    )
    return helper.append_activation(out)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(dtype=input.dtype)
            for _ in range(n)]
    helper.append_op("split", inputs={"X": input}, outputs={"Out": outs}, attrs=attrs)
    return outs


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("unsqueeze2", inputs={"X": input}, outputs={"Out": out},
                     attrs={"axes": list(axes)})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        "scatter", inputs={"X": input, "Ids": index, "Updates": updates},
        outputs={"Out": out}, attrs={"overwrite": overwrite},
    )
    return out
