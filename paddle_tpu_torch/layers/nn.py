"""NN layer functions. Each builds vars + appends ops via LayerHelper."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

from paddle_tpu_torch.framework import Variable, convert_np_dtype_to_dtype_
from paddle_tpu_torch.initializer import ConstantInitializer, NormalInitializer
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
    "dropout", "relu", "sigmoid", "sqrt", "abs", "log", "softmax",
    "log_softmax", "mean", "accuracy",
    "topk", "softmax_with_cross_entropy", "label_smooth", "elementwise_op",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_pow", "elementwise_max", "reduce_sum",
    "reduce_max", "scale", "cast", "clip", "clip_by_norm", "sums",
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
    is_test: bool = False,
    name: Optional[str] = None,
):
    """Fully-connected layer: ``mul`` + bias add + activation.
    ``is_test`` is taken for the JAX package's signature and changes
    nothing, as there."""
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
    is_sparse: bool = False,
    is_distributed: bool = False,
    padding_idx: Optional[int] = None,
    param_attr=None,
    dtype: str = "float32",
    name: Optional[str] = None,
):
    """Embedding lookup over padded [b, t] ids, in the JAX package's
    signature. ``is_distributed`` row-shards the table across devices
    there; on one device the lookup is the same. ``is_sparse`` asks for
    the row-sparse gradient and the optimizers' row-wise (lazy) updates,
    which the port does not have: it raises rather than train with dense
    updates."""
    if is_sparse:
        raise NotImplementedError(
            "embedding(is_sparse=True): the row-sparse gradient and its "
            "optimizer ops are not ported; use is_sparse=False")
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


def _two(v):
    return [v] * 2 if isinstance(v, int) else list(v)


def conv2d(
    input: Variable,
    num_filters: int,
    filter_size: Union[int, Sequence[int]],
    stride: Union[int, Sequence[int]] = 1,
    padding: Union[int, Sequence[int]] = 0,
    dilation: Union[int, Sequence[int]] = 1,
    groups: int = 1,
    param_attr=None,
    bias_attr=None,
    use_cudnn: bool = True,
    act: Optional[str] = None,
    name: Optional[str] = None,
):
    """2D convolution, NCHW (reference: layers/nn.py conv2d). The filter
    defaults to Normal(0, sqrt(2 / fan_in)); ``groups == c_in`` emits
    ``depthwise_conv2d``."""
    helper = LayerHelper("conv2d", name=name, bias_attr=bias_attr, act=act)
    c_in = input.shape[1]
    fs = _two(filter_size)
    groups = groups or 1
    fan_in = (c_in // groups) * math.prod(fs)
    w = helper.create_parameter(
        ParamAttr._to_attr(param_attr),
        shape=[num_filters, c_in // groups] + fs,
        dtype=input.dtype,
        default_initializer=NormalInitializer(0.0, math.sqrt(2.0 / fan_in)),
    )
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        "conv2d" if groups == 1 or c_in != groups else "depthwise_conv2d",
        inputs={"Input": input, "Filter": w},
        outputs={"Output": out},
        attrs={
            "strides": _two(stride),
            "paddings": _two(padding),
            "dilations": _two(dilation),
            "groups": groups,
        },
    )
    pre_act = _conv_bias(helper, out)
    return helper.append_activation(pre_act)


def _conv_bias(helper, out):
    """Add a per-channel bias (axis 1) unless ``bias_attr`` is False."""
    bias_attr = helper.kwargs.get("bias_attr")
    if bias_attr is False:
        return out
    num_filters = out.shape[1] if out.shape else 1
    b = helper.create_parameter(
        ParamAttr._to_attr(bias_attr), shape=[num_filters], dtype=out.dtype,
        is_bias=True,
    )
    if b is None:
        return out
    res = helper.create_variable_for_type_inference(dtype=out.dtype)
    helper.append_op(
        "elementwise_add",
        inputs={"X": out, "Y": b},
        outputs={"Out": res},
        attrs={"axis": 1},
    )
    return res


def pool2d(
    input,
    pool_size=2,
    pool_type="max",
    pool_stride=1,
    pool_padding=0,
    global_pooling=False,
    use_cudnn=True,
    ceil_mode=False,
    exclusive=True,
    name=None,
):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        "pool2d",
        inputs={"X": input},
        outputs={"Out": out},
        attrs={
            "pooling_type": pool_type,
            "ksize": _two(pool_size),
            "strides": _two(pool_stride),
            "paddings": _two(pool_padding),
            "global_pooling": global_pooling,
            "exclusive": exclusive,
        },
    )
    return out


def batch_norm(
    input,
    act=None,
    is_test=False,
    momentum=0.9,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    data_layout="NCHW",
    in_place=False,
    name=None,
    moving_mean_name=None,
    moving_variance_name=None,
    do_model_average_for_mean_and_var=False,
    use_global_stats=False,
):
    """Batch normalization (reference: layers/nn.py batch_norm). The
    moving mean and variance are non-trainable parameters that the op
    writes back through MeanOut / VarianceOut under their own names."""
    helper = LayerHelper("batch_norm", name=name, act=act)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dtype = input.dtype

    scale = helper.create_parameter(
        ParamAttr._to_attr(param_attr), shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0),
    )
    bias = helper.create_parameter(
        ParamAttr._to_attr(bias_attr), shape=[c], dtype=dtype, is_bias=True,
    )
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, initializer=ConstantInitializer(0.0),
                  trainable=False),
        shape=[c], dtype=dtype,
    )
    var = helper.create_parameter(
        ParamAttr(name=moving_variance_name,
                  initializer=ConstantInitializer(1.0), trainable=False),
        shape=[c], dtype=dtype,
    )
    out = helper.create_variable_for_type_inference(dtype=dtype)
    saved_mean = helper.create_variable_for_type_inference(
        dtype=dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype=dtype, stop_gradient=True)
    helper.append_op(
        "batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
                "Variance": var},
        outputs={
            "Y": out,
            "MeanOut": mean,
            "VarianceOut": var,
            "SavedMean": saved_mean,
            "SavedVariance": saved_var,
        },
        attrs={
            "momentum": momentum,
            "epsilon": epsilon,
            "is_test": is_test or use_global_stats,
            "data_layout": data_layout,
        },
    )
    return helper.append_activation(out)


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


def sigmoid(x, name=None):
    return _single_op("sigmoid", x, name=name)


def sqrt(x, name=None):
    return _single_op("sqrt", x, name=name)


def abs(x, name=None):
    return _single_op("abs", x, name=name)


def log(x, name=None):
    return _single_op("log", x, name=name)


def softmax(input, use_cudnn=False, name=None, axis=-1):
    """``use_cudnn`` is taken for the JAX package's signature and changes
    nothing, as there."""
    return _single_op("softmax", input, attrs={"axis": axis}, name=name)


def log_softmax(input, axis=-1, name=None):
    return _single_op("log_softmax", input, attrs={"axis": axis}, name=name)


# --- losses ---


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False):
    """Softmax and cross entropy in one op (``numeric_stable_mode`` is
    taken for the JAX package's signature; the op is always the stable
    log-softmax form, as there)."""
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


# --- metrics ---


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = topk(input, k)
    acc = helper.create_variable_for_type_inference(
        dtype="float32", stop_gradient=True)
    correct = correct or helper.create_variable_for_type_inference(
        dtype="int32", stop_gradient=True)
    total = total or helper.create_variable_for_type_inference(
        dtype="int32", stop_gradient=True)
    helper.append_op(
        "accuracy",
        inputs={"Out": topk_out, "Indices": topk_indices, "Label": label},
        outputs={"Accuracy": acc, "Correct": correct, "Total": total},
    )
    return acc


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    vals = helper.create_variable_for_type_inference(dtype=input.dtype)
    idx = helper.create_variable_for_type_inference(
        dtype="int64", stop_gradient=True)
    helper.append_op(
        "top_k", inputs={"X": input}, outputs={"Out": vals, "Indices": idx},
        attrs={"k": k},
    )
    return vals, idx


# --- math wrappers ---


def mean(x, name=None):
    return _single_op("mean", x, name=name)



def elementwise_op(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        op_type, inputs={"X": x, "Y": y}, outputs={"Out": out}, attrs={"axis": axis}
    )
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_div", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_pow", x, y, axis, act, name)


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


def clip(x, min, max, name=None):
    return _single_op("clip", x, attrs={"min": float(min), "max": float(max)},
                      name=name)


def clip_by_norm(x, max_norm, name=None):
    return _single_op("clip_by_norm", x,
                      attrs={"max_norm": float(max_norm)}, name=name)


def sums(input, out=None):
    """The ``sum`` op over a list of vars."""
    helper = LayerHelper("sum")
    out = out or helper.create_variable_for_type_inference(
        dtype=input[0].dtype)
    helper.append_op("sum", inputs={"X": list(input)}, outputs={"Out": out})
    return out


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


def less_than(x, y, cond=None, force_cpu=None):
    """``force_cpu`` is taken for the JAX package's signature; the result
    stays on the program's device, as there."""
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


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    """Reshape to ``shape``; ``actual_shape`` and ``inplace`` are taken
    for the JAX package's signature and change nothing, as there (ops are
    functional, and the static shape rules)."""
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
