"""NN layer functions. Each builds vars + appends ops via LayerHelper."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

from paddle_tpu_torch import unique_name
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
    "elementwise_div", "elementwise_pow", "elementwise_max",
    "elementwise_min", "elementwise_floordiv", "exp", "pow", "reduce_sum",
    "reduce_max", "scale", "cast", "clip", "clip_by_norm", "sums",
    "fill_constant_like", "one_hot", "argmax", "equal", "less_than",
    "logical_and", "logical_not", "where", "reshape", "split", "unsqueeze",
    "scatter", "increment", "transpose", "squeeze", "expand", "gelu",
    "greater_than", "sigmoid_cross_entropy_with_logits", "concat",
    "multiclass_nms", "tanh", "square", "softplus", "softsign", "relu6",
    "swish", "hard_swish", "hard_sigmoid", "elu", "leaky_relu",
    "square_error_cost", "matmul", "reduce_mean", "reduce_min",
    "reduce_prod", "flatten", "sequence_pool", "sequence_softmax",
    "sequence_mask", "sequence_reverse", "sequence_expand", "im2sequence",
    "sequence_conv", "add_position_encoding", "linear_chain_crf",
    "crf_decoding", "warpctc", "edit_distance", "chunk_eval",
    "ctc_greedy_decoder", "py_func", "hash", "tree_conv",
    "argmin", "bilinear_tensor_product", "conv2d_transpose",
    "cross_entropy", "cumsum", "elementwise_mod", "expand_as", "gather",
    "group_norm", "hsigmoid", "huber_loss", "l2_normalize", "logical_or",
    "lookup_table", "maxout", "mean_iou", "mul", "nce", "pad", "prelu",
    "sample_logits", "smooth_l1", "spectral_norm", "stack", "unstack",
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
    input: Union[Variable, Sequence[Variable]],
    size: int,
    num_flatten_dims: int = 1,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    is_test: bool = False,
    name: Optional[str] = None,
):
    """Fully-connected layer: ``mul`` + bias add + activation; a list of
    inputs gets one weight each, their products summed. ``is_test`` is
    taken for the JAX package's signature and changes
    nothing, as there."""
    helper = LayerHelper("fc", name=name, bias_attr=bias_attr, act=act)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = (param_attr if isinstance(param_attr, (list, tuple))
                   else [param_attr] * len(inputs))
    mul_results = []
    for x, pa in zip(inputs, param_attrs):
        in_features = math.prod(x.shape[num_flatten_dims:])
        w = helper.create_parameter(
            ParamAttr._to_attr(pa), shape=[in_features, size],
            dtype=x.dtype,
        )
        tmp = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(
            "mul",
            inputs={"X": x, "Y": w},
            outputs={"Out": tmp},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        # several inputs: their products summed, one bias (the JAX fc's)
        pre_bias = helper.create_variable_for_type_inference(
            dtype=inputs[0].dtype)
        helper.append_op("sum", inputs={"X": mul_results},
                         outputs={"Out": pre_bias})
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
    signature. ``is_sparse`` gives the table a row-sparse gradient
    (ops/sparse_ops.py): the optimizers update only the rows a batch
    touches (lazily, for Momentum and Adam). ``is_distributed`` row-shards
    the table across devices in the JAX package; on one device the lookup
    is the same, and the sharding is not ported."""
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
    if is_distributed:
        attrs["is_distributed"] = True
    if is_sparse:
        attrs["is_sparse"] = True
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


def exp(x, name=None):
    return _single_op("exp", x, name=name)


def pow(x, factor=1.0, name=None):
    return _single_op("pow", x, attrs={"factor": factor}, name=name)


def gelu(x, approximate=False, name=None):
    return _single_op("gelu", x, attrs={"approximate": approximate},
                      name=name)


def _make_act(name):
    """A layer of one activation op whose keywords (but ``name``) are its
    attrs, as the JAX package's ``_make_act`` layers are."""
    def _act(x, **kwargs):
        attrs = {k: v for k, v in kwargs.items() if k != "name"}
        return _single_op(name, x, attrs=attrs, name=kwargs.get("name"))

    _act.__name__ = name
    return _act


tanh = _make_act("tanh")
square = _make_act("square")
softplus = _make_act("softplus")
softsign = _make_act("softsign")
relu6 = _make_act("relu6")
swish = _make_act("swish")
hard_swish = _make_act("hard_swish")
hard_sigmoid = _make_act("hard_sigmoid")
elu = _make_act("elu")


def leaky_relu(x, alpha=0.02, name=None):
    return _single_op("leaky_relu", x, attrs={"alpha": alpha}, name=name)


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


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        "sigmoid_cross_entropy_with_logits",
        inputs={"X": x, "Label": label},
        outputs={"Out": out},
        attrs={"ignore_index": ignore_index},
    )
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("square_error_cost", inputs={"X": input, "Label": label},
                     outputs={"Out": out})
    return out


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


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        "matmul", inputs={"X": x, "Y": y}, outputs={"Out": out},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": float(alpha)})
    return out



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


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_min", x, y, axis, act, name)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_floordiv", x, y, axis, act, name)


def _reduce(op_type, input, dim, keep_dim, name):
    attrs = {"keep_dim": keep_dim}
    if dim is None:
        attrs["reduce_all"] = True
    else:
        attrs["dim"] = [dim] if isinstance(dim, int) else list(dim)
    return _single_op(op_type, input, attrs=attrs, name=name)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


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


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def logical_and(x, y, out=None, name=None):
    return _compare("logical_and", x, y, out)


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not")
    out = out or helper.create_variable_for_type_inference(
        dtype="bool", stop_gradient=True)
    helper.append_op("logical_not", inputs={"X": x}, outputs={"Out": out})
    return out


def increment(x, value=1.0, in_place=True):
    """x + value; ``in_place`` writes the result back into ``x`` (the
    var is rebound, as a ``while`` body's counter is)."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        dtype=x.dtype)
    helper.append_op("increment", inputs={"X": x}, outputs={"Out": out},
                     attrs={"step": float(value)})
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


def transpose(x, perm, name=None):
    return _single_op("transpose2", x, attrs={"axis": list(perm)}, name=name)


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


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op("concat", inputs={"X": list(input)},
                     outputs={"Out": out}, attrs={"axis": axis})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("squeeze2", inputs={"X": input}, outputs={"Out": out},
                     attrs={"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("unsqueeze2", inputs={"X": input}, outputs={"Out": out},
                     attrs={"axes": list(axes)})
    return out


def expand(x, expand_times, name=None):
    return _single_op("expand", x,
                      attrs={"expand_times": list(expand_times)}, name=name)


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("flatten2", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        "scatter", inputs={"X": input, "Ids": index, "Updates": updates},
        outputs={"Out": out}, attrs={"overwrite": overwrite},
    )
    return out


# --- detection ---


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=64,
                   keep_top_k=16, nms_threshold=0.3, background_label=0,
                   name=None):
    """Static-shape multiclass NMS: [n, keep_top_k, 6] rows of (label,
    score, box), label -1 padding (ops/vision_ops.py).
    ``background_label``: the class skipped entirely (-1 keeps every
    class)."""
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference(dtype=bboxes.dtype)
    helper.append_op(
        "multiclass_nms", inputs={"BBoxes": bboxes, "Scores": scores},
        outputs={"Out": out},
        attrs={"score_threshold": score_threshold, "nms_top_k": nms_top_k,
               "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
               "background_label": background_label})
    return out


# --- sequence (padded [B, T, ...] + Length; see ops/sequence_ops.py) ---


def sequence_pool(input, pool_type, length=None):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    inputs = {"X": input}
    if length is not None:
        inputs["Length"] = length
    helper.append_op("sequence_pool", inputs=inputs, outputs={"Out": out},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_softmax(input, length=None, use_cudnn=False, name=None):
    """``use_cudnn`` is taken for the JAX package's signature and changes
    nothing, as there."""
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    inputs = {"X": input}
    if length is not None:
        inputs["Length"] = length
    helper.append_op("sequence_softmax", inputs=inputs, outputs={"Out": out})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """Needs a static ``maxlen``: the op raises without one, as the JAX
    op does."""
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    stop_gradient=True)
    helper.append_op(
        "sequence_mask", inputs={"X": x}, outputs={"Y": out},
        attrs={"maxlen": maxlen if maxlen is not None else -1,
               "out_dtype": dtype})
    return out


def sequence_reverse(x, length=None, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    inputs = {"X": x}
    if length is not None:
        inputs["Length"] = length
    helper.append_op("sequence_reverse", inputs=inputs, outputs={"Y": out})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    """``ref_level`` is taken for the JAX package's signature: the padded
    layout has one level, as there."""
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("sequence_expand", inputs={"X": x, "Y": y},
                     outputs={"Out": out})
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    """VALID patches as steps; ``padding``, ``input_image_size`` and
    ``out_stride`` are taken for the JAX package's signature and change
    nothing, as there."""
    helper = LayerHelper("im2sequence", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        "im2sequence", inputs={"X": input}, outputs={"Out": out},
        attrs={"kernels": _two(filter_size), "strides": _two(stride)})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, param_attr=None, bias_attr=None, act=None,
                  name=None):
    """Context-window convolution over padded [b, t, d] sequences (a
    window of ``filter_size`` steps centred on each step); the filter is
    [filter_size * d, num_filters]. ``filter_stride`` and ``padding`` are
    taken for the JAX package's signature and change nothing, as there."""
    helper = LayerHelper("sequence_conv", name=name, bias_attr=bias_attr,
                         act=act)
    d = input.shape[-1]
    w = helper.create_parameter(
        ParamAttr._to_attr(param_attr), shape=[filter_size * d, num_filters],
        dtype=input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        "sequence_conv", inputs={"X": input, "Filter": w},
        outputs={"Out": out},
        attrs={"contextLength": filter_size,
               "contextStart": -(filter_size // 2)})
    out = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(out)


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    return _single_op("add_position_encoding", input,
                      attrs={"alpha": float(alpha), "beta": float(beta)},
                      name=name)


# --- structured prediction, metrics and host callbacks (ops/crf_ops.py,
# ops/metric_ops.py, ops/misc_ops.py) ---


def linear_chain_crf(input, label, param_attr=None, length=None):
    """CRF loss layer (reference: layers/nn.py linear_chain_crf).
    ``input`` [b, t, c] emissions, ``label`` [b, t]; creates the [c+2, c]
    transition parameter. Returns the per-sequence NEGATIVE
    log-likelihood [b, 1] (the reference kernel's semantics: minimize
    ``mean(...)`` directly)."""
    helper = LayerHelper("linear_chain_crf")
    c = input.shape[-1]
    trans = helper.create_parameter(
        ParamAttr._to_attr(param_attr), shape=[c + 2, c], dtype=input.dtype,
    )
    ll = helper.create_variable_for_type_inference(dtype=input.dtype)
    inputs = {"Emission": input, "Transition": trans, "Label": label}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(
        "linear_chain_crf", inputs=inputs, outputs={"LogLikelihood": ll}
    )
    return ll


def crf_decoding(input, param_attr=None, label=None, length=None):
    """Viterbi decode with a (shared, by ParamAttr name) transition
    parameter (reference: layers/nn.py crf_decoding). With ``label``, the
    output is the reference's per-position correctness mask (1 where the
    Viterbi path agrees with the label) instead of tag ids."""
    helper = LayerHelper("crf_decoding")
    c = input.shape[-1]
    trans = helper.create_parameter(
        ParamAttr._to_attr(param_attr), shape=[c + 2, c], dtype=input.dtype,
    )
    out = helper.create_variable_for_type_inference(
        dtype="int64", stop_gradient=True)
    inputs = {"Emission": input, "Transition": trans}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(
        "crf_decoding", inputs=inputs, outputs={"ViterbiPath": out}
    )
    if label is None:
        return out
    return cast(equal(out, label), "int64")


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """CTC loss (reference: layers/nn.py warpctc). ``input`` [b, t, c]
    unnormalized logits (batch-major; the reference's time-major LoD
    convention becomes padded + length vectors)."""
    helper = LayerHelper("warpctc")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    inputs = {"Logits": input, "Label": label}
    if input_length is not None:
        inputs["LogitsLength"] = input_length
    if label_length is not None:
        inputs["LabelLength"] = label_length
    helper.append_op(
        "warpctc", inputs=inputs, outputs={"Loss": out},
        attrs={"blank": blank, "norm_by_times": norm_by_times},
    )
    return out


def edit_distance(input, label, normalized=True, input_length=None,
                  label_length=None):
    """Levenshtein distance a row (reference: layers/nn.py
    edit_distance). Returns (distance [b, 1], seq_num [1])."""
    helper = LayerHelper("edit_distance")
    out = helper.create_variable_for_type_inference(
        dtype="float32", stop_gradient=True)
    num = helper.create_variable_for_type_inference(
        dtype="int64", stop_gradient=True)
    inputs = {"Hyps": input, "Refs": label}
    if input_length is not None:
        inputs["HypsLength"] = input_length
    if label_length is not None:
        inputs["RefsLength"] = label_length
    helper.append_op(
        "edit_distance", inputs=inputs,
        outputs={"Out": out, "SequenceNum": num},
        attrs={"normalized": normalized},
    )
    return out, num


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """Chunk-level P / R / F1 for tagging (reference: layers/nn.py
    chunk_eval). Returns (precision, recall, f1, n_infer, n_label,
    n_correct)."""
    helper = LayerHelper("chunk_eval")
    outs = {}
    for slot, dt in [("Precision", "float32"), ("Recall", "float32"),
                     ("F1-Score", "float32"), ("NumInferChunks", "int64"),
                     ("NumLabelChunks", "int64"),
                     ("NumCorrectChunks", "int64")]:
        outs[slot] = helper.create_variable_for_type_inference(
            dtype=dt, stop_gradient=True)
    inputs = {"Inference": input, "Label": label}
    if seq_length is not None:
        inputs["SeqLength"] = seq_length
    helper.append_op(
        "chunk_eval", inputs=inputs, outputs=outs,
        attrs={"num_chunk_types": num_chunk_types,
               "chunk_scheme": chunk_scheme,
               "excluded_chunk_types": list(excluded_chunk_types or [])})
    return (outs["Precision"], outs["Recall"], outs["F1-Score"],
            outs["NumInferChunks"], outs["NumLabelChunks"],
            outs["NumCorrectChunks"])


def ctc_greedy_decoder(input, blank, input_length=None, name=None):
    """Greedy CTC decode: the argmax a step, then ctc_align's merge and
    blank removal (reference: layers/nn.py ctc_greedy_decoder). ``input``
    [B, T, C] probabilities; returns (decoded [B, T] left-compacted with
    -1 / 0 padding, out_length [B, 1])."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    top1 = argmax(input, axis=-1)
    decoded = helper.create_variable_for_type_inference(
        dtype="int64", stop_gradient=True)
    out_len = helper.create_variable_for_type_inference(
        dtype="int32", stop_gradient=True)
    inputs = {"Input": top1}
    if input_length is not None:
        inputs["InputLength"] = input_length
    helper.append_op(
        "ctc_align", inputs=inputs,
        outputs={"Output": decoded, "OutputLength": out_len},
        attrs={"blank": blank, "merge_repeated": True})
    return decoded, out_len


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Register a user Python callable as an operator (reference:
    layers/nn.py:11059 py_func + operators/py_func_op.cc:105). ``func``
    runs on the host each time the op runs (a step that holds it is not
    captured as a CUDA graph); ``out`` variables must be created
    beforehand with shapes and dtypes (the reference's contract).
    ``backward_func`` receives the forward inputs, the forward outputs,
    then the output gradients (None where absent), and returns the input
    gradients (None = no grad)."""
    from paddle_tpu_torch.ops.misc_ops import register_py_func

    helper = LayerHelper("py_func")
    if x is None:
        x = []
    elif isinstance(x, Variable):
        x = [x]
    if out is None:
        out_list = []
    elif isinstance(out, Variable):
        out_list = [out]
    else:
        out_list = list(out)
    for o in out_list:
        if o.shape is None:
            raise ValueError(
                "py_func output shapes must be provided by users manually")
        if any(int(d) < 0 for d in o.shape):
            raise ValueError(
                f"py_func output '{o.name}' has dynamic shape "
                f"{tuple(o.shape)}; the host callback needs a static "
                f"signature — declare concrete dims (including batch)")
    fwd_id = register_py_func(func)
    bwd_id = register_py_func(backward_func) if backward_func else -1
    skip = skip_vars_in_backward_input
    if isinstance(skip, Variable):
        skip = [skip]
    skip_names = [v.name if isinstance(v, Variable) else v
                  for v in skip or []]
    in_out = {v.name for v in list(x) + out_list}
    for n in skip_names:
        if n not in in_out:
            raise ValueError(f"Variable {n} is not found in forward inputs "
                             f"and outputs")
    helper.append_op(
        "py_func",
        inputs={"X": list(x)},
        outputs={"Out": out_list},
        attrs={
            "forward_callable_id": fwd_id,
            "backward_callable_id": bwd_id,
            "out_shapes": [[int(d) for d in o.shape] for o in out_list],
            "out_dtypes": [str(o.dtype) for o in out_list],
            "backward_skip_vars": skip_names,
        },
    )
    return out


def hash(input, hash_size, num_hash=1, name=None):
    """Multi-seed feature hashing into ``[0, hash_size)`` buckets
    (reference: layers/nn.py:10456 + operators/hash_op.cc). ``input``
    [N, d] integer ids; output [N, num_hash, 1]: XXH64 buckets, the
    reference's and the JAX package's under x64."""
    helper = LayerHelper("hash", name=name)
    out = helper.create_variable_for_type_inference(
        dtype=input.dtype, stop_gradient=True)
    helper.append_op(
        "hash", inputs={"X": input}, outputs={"Out": out},
        attrs={"num_hash": num_hash, "mod_by": hash_size})
    return out


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    """Tree-based convolution over node features (reference:
    layers/nn.py:11351 tree_conv + operators/tree_conv_op.cc).
    ``nodes_vector`` [N, n, f], ``edge_set`` [N, e, 2] directional
    parent->child 1-indexed edges; output [N, n, output_size,
    num_filters]."""
    helper = LayerHelper("tree_conv", name=name, bias_attr=bias_attr,
                         act=act)
    dtype = nodes_vector.dtype
    feature_size = int(nodes_vector.shape[2])
    w = helper.create_parameter(
        attr=param_attr, shape=[feature_size, 3, output_size, num_filters],
        dtype=dtype, is_bias=False)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        "tree_conv",
        inputs={"NodesVector": nodes_vector, "EdgeSet": edge_set,
                "Filter": w},
        outputs={"Out": out},
        attrs={"max_depth": max_depth})
    if bias_attr is not False:
        out = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(out)


# --- the op-library slice: the layers of the math / tensor / nn op types


lookup_table = embedding


def conv2d_transpose(
    input, num_filters, output_size=None, filter_size=None, padding=0,
    stride=1, dilation=1, groups=1, param_attr=None, bias_attr=None,
    use_cudnn=True, act=None, name=None,
):
    """Transposed convolution, filter [C_in, num_filters / groups, kh,
    kw]; ``output_size`` and ``use_cudnn`` ride along for the JAX
    package's signature (as there, the size follows from the filter)."""
    helper = LayerHelper("conv2d_transpose", name=name, bias_attr=bias_attr,
                         act=act)
    c_in = input.shape[1]
    fs = (list(filter_size) if isinstance(filter_size, (list, tuple))
          else [filter_size] * 2)
    w = helper.create_parameter(
        ParamAttr._to_attr(param_attr),
        shape=[c_in, num_filters // (groups or 1)] + fs, dtype=input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        "conv2d_transpose",
        inputs={"Input": input, "Filter": w},
        outputs={"Output": out},
        attrs={"strides": [stride] * 2 if isinstance(stride, int)
               else list(stride),
               "paddings": [padding] * 2 if isinstance(padding, int)
               else list(padding),
               "dilations": [dilation] * 2 if isinstance(dilation, int)
               else list(dilation)},
    )
    return helper.append_activation(_conv_bias(helper, out))


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """-log of the label's probability (the older op over softmax
    outputs)."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        "cross_entropy", inputs={"X": input, "Label": label},
        outputs={"Y": out},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    res = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                    stop_gradient=True)
    helper.append_op("huber_loss", inputs={"X": input, "Y": label},
                     outputs={"Out": out, "Residual": res},
                     attrs={"delta": delta})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    diff = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     stop_gradient=True)
    inputs = {"X": x, "Y": y}
    if inside_weight is not None:
        inputs["InsideWeight"] = inside_weight
    if outside_weight is not None:
        inputs["OutsideWeight"] = outside_weight
    helper.append_op("smooth_l1_loss", inputs=inputs,
                     outputs={"Out": out, "Diff": diff},
                     attrs={"sigma": sigma or 1.0})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("mul", inputs={"X": x, "Y": y}, outputs={"Out": out},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def gather(input, index, overwrite=True):
    """``overwrite`` is taken for the JAX package's signature."""
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("gather", inputs={"X": input, "Index": index},
                     outputs={"Out": out})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """x / sqrt(max(sum(x^2 along axis), epsilon)), composed of ops."""
    ssum = reduce_sum(square(x), dim=axis, keep_dim=True)
    norm = sqrt(elementwise_max(ssum, fill_constant_like(ssum, epsilon)))
    return elementwise_div(x, norm)


def pad(x, paddings, pad_value=0.0, name=None):
    return _single_op("pad", x, attrs={"paddings": list(paddings),
                                       "pad_value": float(pad_value)},
                      name=name)


def stack(x, axis=0):
    helper = LayerHelper("stack")
    out = helper.create_variable_for_type_inference(dtype=x[0].dtype)
    helper.append_op("stack", inputs={"X": list(x)}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    num = num or x.shape[axis]
    outs = [helper.create_variable_for_type_inference(dtype=x.dtype)
            for _ in range(num)]
    helper.append_op("unstack", inputs={"X": x}, outputs={"Y": outs},
                     attrs={"axis": axis})
    return outs


def expand_as(x, target_tensor, name=None):
    helper = LayerHelper("expand_as", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("expand_as", inputs={"X": x, "Y": target_tensor},
                     outputs={"Out": out})
    return out


def argmin(x, axis=0, name=None):
    return _single_op("arg_min", x, attrs={"axis": axis}, dtype="int64",
                      stop_gradient=True, name=name)


def logical_or(x, y, out=None, name=None):
    return _compare("logical_or", x, y, out)


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    return _single_op("cumsum", x, attrs={"axis": axis,
                                          "exclusive": exclusive,
                                          "reverse": reverse}, name=name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_mod", x, y, axis, act, name)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    """Group normalization over NCHW input (scale 1, bias 0 at start)."""
    if data_layout != "NCHW":
        raise ValueError("group_norm supports NCHW layout")
    helper = LayerHelper("group_norm", name=name, act=act)
    c = input.shape[1]
    scale = helper.create_parameter(
        ParamAttr._to_attr(param_attr), shape=[c], dtype=input.dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(
        ParamAttr._to_attr(bias_attr), shape=[c], dtype=input.dtype,
        is_bias=True)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    mean = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                    stop_gradient=True)
    helper.append_op("group_norm",
                     inputs={"X": input, "Scale": scale, "Bias": bias},
                     outputs={"Y": out, "Mean": mean, "Variance": var},
                     attrs={"groups": groups, "epsilon": epsilon})
    return helper.append_activation(out)


def prelu(x, mode="all", param_attr=None, name=None):
    """max(x, 0) + alpha min(x, 0); alpha (0.25 at start) one value, one
    a channel or one an element of a sample, by ``mode``."""
    helper = LayerHelper("prelu", name=name)
    if mode == "all":
        shape = [1]
    elif mode == "channel":
        shape = [x.shape[1]]
    else:
        shape = [int(math.prod(x.shape[1:]))]
    alpha = helper.create_parameter(
        ParamAttr._to_attr(param_attr), shape=shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("prelu", inputs={"X": x, "Alpha": alpha},
                     outputs={"Out": out}, attrs={"mode": mode})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("maxout", inputs={"X": x}, outputs={"Out": out},
                     attrs={"groups": groups})
    return out


def mean_iou(input, label, num_classes):
    helper = LayerHelper("mean_iou")
    out = helper.create_variable_for_type_inference(dtype="float32",
                                                    stop_gradient=True)
    helper.append_op("mean_iou",
                     inputs={"Predictions": input, "Labels": label},
                     outputs={"OutMeanIou": out},
                     attrs={"num_classes": num_classes})
    return out


def bilinear_tensor_product(x, y, size, act=None, param_attr=None,
                            bias_attr=None, name=None):
    """out_k = x^T W_k y + b_k, W [size, x dim, y dim]."""
    helper = LayerHelper("bilinear_tensor_product", name=name, act=act)
    w = helper.create_parameter(
        ParamAttr._to_attr(param_attr),
        shape=[size, x.shape[-1], y.shape[-1]], dtype=x.dtype)
    b = helper.create_parameter(ParamAttr._to_attr(bias_attr), shape=[size],
                                dtype=x.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    inputs = {"X": x, "Y": y, "Weight": w}
    if b is not None:
        inputs["Bias"] = b
    helper.append_op("bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": out})
    return helper.append_activation(out)


def nce(input, label, num_total_classes, num_neg_samples=10,
        param_attr=None, bias_attr=None, name=None):
    """Noise-contrastive estimation over a [C, D] table: the cost [b, 1]
    of each example's label against ``num_neg_samples`` uniform negatives
    drawn on the device each step."""
    helper = LayerHelper("nce", name=name)
    d = input.shape[-1]
    w = helper.create_parameter(ParamAttr._to_attr(param_attr),
                                shape=[num_total_classes, d],
                                dtype=input.dtype)
    b = helper.create_parameter(ParamAttr._to_attr(bias_attr),
                                shape=[num_total_classes], dtype=input.dtype,
                                is_bias=True)
    cost = helper.create_variable_for_type_inference(dtype=input.dtype)
    inputs = {"Input": input, "Label": label, "Weight": w}
    if b is not None:
        inputs["Bias"] = b
    helper.append_op("nce", inputs=inputs, outputs={"Cost": cost},
                     attrs={"num_neg_samples": num_neg_samples})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """Hierarchical sigmoid over the complete binary tree of
    ``num_classes`` leaves: W [C - 1, D], cost [b, 1]."""
    helper = LayerHelper("hsigmoid", name=name)
    d = input.shape[-1]
    w = helper.create_parameter(ParamAttr._to_attr(param_attr),
                                shape=[num_classes - 1, d],
                                dtype=input.dtype)
    b = helper.create_parameter(ParamAttr._to_attr(bias_attr),
                                shape=[num_classes - 1], dtype=input.dtype,
                                is_bias=True)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    pre = helper.create_variable_for_type_inference(dtype=input.dtype)
    inputs = {"X": input, "W": w, "Label": label}
    if b is not None:
        inputs["Bias"] = b
    helper.append_op("hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": out, "PreOut": pre},
                     attrs={"num_classes": int(num_classes)})
    return out


def sample_logits(logits, label, num_samples, remove_accidental_hits=True,
                  name=None):
    """(sampled logits, sampled label) for softmax_with_cross_entropy: the
    true labels' logits and ``num_samples`` uniform samples' logits, less
    log(q), drawn on the device each step."""
    helper = LayerHelper("sample_logits", name=name)
    outs = {
        s: helper.create_variable_for_type_inference(
            dtype="int64" if s in ("Samples", "SampledLabel")
            else logits.dtype,
            stop_gradient=s != "SampledLogits")
        for s in ("Samples", "Probabilities", "SampledLogits",
                  "SampledLabel")
    }
    helper.append_op(
        "sample_logits", inputs={"Logits": logits, "Labels": label},
        outputs=outs,
        attrs={"num_samples": int(num_samples),
               "remove_accidental_hits": bool(remove_accidental_hits)})
    return outs["SampledLogits"], outs["SampledLabel"]


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """``weight`` / its largest singular value, estimated by power
    iteration from persistable vectors U [h], V [w / h] (N(0, 1) at
    start) that the op's UOut / VOut write back under their own names,
    so the estimate advances across steps (as batch_norm's moving
    statistics)."""
    helper = LayerHelper("spectral_norm", name=name)
    h = int(weight.shape[dim])
    w_dim = int(math.prod(int(s) for s in weight.shape)) // h
    u = helper.create_parameter(
        ParamAttr(name=unique_name.generate(f"{helper.name}.u"),
                  trainable=False),
        shape=[h], dtype=weight.dtype,
        default_initializer=NormalInitializer(0.0, 1.0))
    v = helper.create_parameter(
        ParamAttr(name=unique_name.generate(f"{helper.name}.v"),
                  trainable=False),
        shape=[w_dim], dtype=weight.dtype,
        default_initializer=NormalInitializer(0.0, 1.0))
    out = helper.create_variable_for_type_inference(dtype=weight.dtype)
    helper.append_op(
        "spectral_norm", inputs={"Weight": weight, "U": u, "V": v},
        outputs={"Out": out, "UOut": u.name, "VOut": v.name},
        attrs={"dim": dim, "power_iters": power_iters, "eps": eps})
    return out
