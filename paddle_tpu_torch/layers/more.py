"""Layers of the JAX package's ``layers/more.py``: the elementwise and
comparison tail, the losses, the shape and image layers, the dense
sequence tail (``[B, T, ...]`` + Length), the batch-size-like fills and
randoms, the dense arrays, the rnn units and ``lstm``, and beam search's
layers. Each builds the JAX package's ops, attrs and vars. The layers of
the vision ops (``adaptive_pool2d``, ``pool3d``, ``conv3d_transpose``,
``psroi_pool``, ...) come with those ops. The bool outputs are fresh vars
that stop gradients; ``greater_equal`` and the other comparisons take
``cond`` for the JAX package's signature and build a new var, as there."""

from __future__ import annotations

import builtins

from paddle_tpu_torch.framework import Variable
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layer_helper import append_simple_op as _op
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = [
    # activations / elementwise
    "brelu", "soft_relu", "stanh", "selu", "sign", "logical_xor",
    "reduce_all", "reduce_any", "rank", "sum", "reverse", "argsort",
    "diag", "cos_sim", "multiplex", "isfinite", "has_inf", "has_nan",
    "greater_equal", "less_equal", "not_equal", "is_empty",
    # losses
    "bpr_loss", "dice_loss", "kldiv_loss", "log_loss", "margin_rank_loss",
    "npair_loss", "rank_loss", "hinge_loss",
    "teacher_student_sigmoid_loss", "sampled_softmax_with_cross_entropy",
    # shape / image
    "pad2d", "pad_constant_like", "crop", "pixel_shuffle",
    "shuffle_channel", "space_to_depth", "temporal_shift", "grid_sampler",
    "affine_channel", "data_norm", "row_conv", "fsp_matrix",
    "image_resize", "resize_bilinear", "resize_nearest",
    "image_resize_short", "continuous_value_model", "sampling_id",
    # sequence (dense / padded)
    "sequence_concat", "sequence_enumerate", "sequence_expand_as",
    "sequence_first_step", "sequence_last_step", "sequence_pad",
    "sequence_unpad", "sequence_reshape", "sequence_scatter",
    "sequence_slice",
    # tensor / control flow / misc
    "fill_constant_batch_size_like", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like", "range",
    "create_array", "array_write", "array_read", "array_length",
    "autoincreased_step_counter", "lod_reset",
    # rnn units
    "dynamic_lstmp", "lstm_unit", "gru_unit", "lstm",
    "tensor_array_to_tensor",
    # decode
    "beam_search", "beam_search_decode",
]


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    """clip(x, t_min, t_max)."""
    return _op("brelu", {"X": x}, {"t_min": t_min, "t_max": t_max},
               name=name)


def soft_relu(x, threshold=40.0, name=None):
    return _op("soft_relu", {"X": x}, {"threshold": threshold}, name=name)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _op("stanh", {"X": x}, {"scale_a": scale_a, "scale_b": scale_b},
               name=name)


def selu(x, scale=None, alpha=None, name=None):
    """``scale`` and ``alpha`` ride the op desc; the op uses selu's fixed
    constants, as the JAX op does."""
    attrs = {}
    if scale is not None:
        attrs["scale"] = scale
    if alpha is not None:
        attrs["alpha"] = alpha
    return _op("selu", {"X": x}, attrs, name=name)


def sign(x, name=None):
    return _op("sign", {"X": x}, name=name)


def logical_xor(x, y, out=None, name=None):
    return _op("logical_xor", {"X": x, "Y": y}, name=name,
               dtypes=("bool",), stop_gradient=True)


def _dims(dim):
    if dim is None:
        return None
    return [dim] if isinstance(dim, int) else list(dim)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    return _op("reduce_all", {"X": input},
               {"dim": _dims(dim), "keep_dim": keep_dim},
               dtypes=("bool",), name=name, stop_gradient=True)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _op("reduce_any", {"X": input},
               {"dim": _dims(dim), "keep_dim": keep_dim},
               dtypes=("bool",), name=name, stop_gradient=True)


def rank(input):
    """Static rank as a constant tensor (reference: layers/nn.py rank)."""
    from paddle_tpu_torch.layers.tensor import fill_constant

    return fill_constant(shape=[1], dtype="int32",
                         value=len(input.shape or ()))


def sum(x, name=None):
    """Elementwise sum of a list of tensors (reference: sum op)."""
    from paddle_tpu_torch.layers.nn import sums

    return sums(x if isinstance(x, (list, tuple)) else [x])


def reverse(x, axis, name=None):
    return _op("reverse", {"X": x},
               {"axis": [axis] if isinstance(axis, int) else list(axis)},
               name=name)


def argsort(input, axis=-1, descending=False, name=None):
    out, ids = _op("argsort", {"X": input},
                   {"axis": axis, "descending": descending},
                   out_slots=("Out", "Indices"), dtypes=(None, "int64"),
                   name=name)
    return out, ids


def diag(diagonal, name=None):
    return _op("diag", {"Diagonal": diagonal}, name=name)


def cos_sim(X, Y, name=None):
    return _op("cos_sim", {"X": X, "Y": Y}, name=name)


def multiplex(inputs, index, name=None):
    helper = LayerHelper("multiplex", name=name)
    out = helper.create_variable_for_type_inference(dtype=inputs[0].dtype)
    helper.append_op("multiplex",
                     inputs={"X": list(inputs), "Ids": [index]},
                     outputs={"Out": [out]}, attrs={})
    return out


def isfinite(x, name=None):
    """One bool: every element of ``x`` (a var or a list of vars) is
    finite."""
    return _op("isfinite", {"X": x}, dtypes=("bool",), name=name,
               stop_gradient=True)


def has_inf(x, name=None):
    """True when any element is +-inf (reference: isinf op)."""
    return _op("has_inf", {"X": x}, dtypes=("bool",), name=name,
               stop_gradient=True)


def has_nan(x, name=None):
    """True when any element is NaN (reference: isnan op)."""
    return _op("has_nan", {"X": x}, dtypes=("bool",), name=name,
               stop_gradient=True)


def greater_equal(x, y, cond=None, name=None):
    return _op("greater_equal", {"X": x, "Y": y}, dtypes=("bool",),
               name=name, stop_gradient=True)


def less_equal(x, y, cond=None, name=None):
    return _op("less_equal", {"X": x, "Y": y}, dtypes=("bool",),
               name=name, stop_gradient=True)


def not_equal(x, y, cond=None, name=None):
    return _op("not_equal", {"X": x, "Y": y}, dtypes=("bool",),
               name=name, stop_gradient=True)


def is_empty(x, cond=None, name=None):
    return _op("is_empty", {"X": x}, dtypes=("bool",), name=name,
               stop_gradient=True)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def bpr_loss(input, label, name=None):
    return _op("bpr_loss", {"X": input, "Label": label},
               out_slots=("Y",), name=name)


def dice_loss(input, label, epsilon=1e-5):
    """Composed exactly as the reference layer (layers/nn.py dice_loss):
    1 - 2*|intersection| / (|input| + |label|)."""
    from paddle_tpu_torch.layers import nn as _nn

    if label.shape and int(label.shape[-1]) == 1:
        label = _nn.squeeze(label, [-1])
    label = _nn.one_hot(label, depth=input.shape[-1])
    reduce_dims = list(builtins.range(1, len(input.shape or ())))
    inse = _nn.reduce_sum(_nn.elementwise_mul(input, label),
                          dim=reduce_dims)
    dice_denominator = _nn.elementwise_add(
        _nn.reduce_sum(input, dim=reduce_dims),
        _nn.reduce_sum(label, dim=reduce_dims))
    dice_score = _nn.elementwise_sub(
        _nn.fill_constant_like(inse, 1.0),
        _nn.elementwise_div(
            _nn.scale(inse, scale=2.0),
            _nn.scale(dice_denominator, bias=epsilon)))
    return _nn.reduce_mean(dice_score)


def kldiv_loss(x, target, reduction="mean", name=None):
    return _op("kldiv_loss", {"X": x, "Target": target},
               {"reduction": reduction}, out_slots=("Loss",), name=name)


def log_loss(input, label, epsilon=1e-4, name=None):
    return _op("log_loss", {"Predicted": input, "Labels": label},
               {"epsilon": epsilon}, out_slots=("Loss",), name=name)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    out, _act = _op("margin_rank_loss",
                    {"Label": label, "X1": left, "X2": right},
                    {"margin": margin}, out_slots=("Out", "Activated"),
                    name=name)
    return out


def rank_loss(label, left, right, name=None):
    return _op("rank_loss", {"Label": label, "Left": left, "Right": right},
               name=name)


def hinge_loss(input, label, name=None):
    return _op("hinge_loss", {"Logits": input, "Labels": label},
               out_slots=("Loss",), name=name)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Composed as the reference layer (layers/nn.py npair_loss):
    cross entropy over anchor@positive^T similarities + L2 on both."""
    from paddle_tpu_torch.layers import nn as _nn

    labels = _nn.cast(_nn.reshape(labels, [-1, 1]), "float32")
    same = _nn.cast(
        _nn.equal(labels, _nn.transpose(labels, [1, 0])), "float32")
    batch = int(anchor.shape[0])
    row_sums = _nn.expand(
        _nn.reshape(_nn.reduce_sum(same, dim=1), [-1, 1]), [1, batch])
    norm = _nn.elementwise_div(same, row_sums)
    sim = _nn.matmul(anchor, positive, transpose_y=True)
    ce = _nn.reduce_mean(_nn.reduce_sum(
        _nn.elementwise_mul(
            _nn.scale(_nn.log_softmax(sim), scale=-1.0), norm), dim=1))
    l2 = _nn.scale(
        _nn.elementwise_add(
            _nn.reduce_mean(_nn.reduce_sum(
                _nn.elementwise_mul(anchor, anchor), dim=1)),
            _nn.reduce_mean(_nn.reduce_sum(
                _nn.elementwise_mul(positive, positive), dim=1))),
        scale=l2_reg * 0.25)
    return _nn.elementwise_add(ce, l2)


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _op("teacher_student_sigmoid_loss",
               {"X": input, "Label": label},
               {"soft_max_up_bound": soft_max_up_bound,
                "soft_max_lower_bound": soft_max_lower_bound},
               out_slots=("Y",))


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1, remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """Composed as the reference layer: sample_logits then
    softmax_with_cross_entropy on the sampled slice."""
    from paddle_tpu_torch.layers import nn as _nn

    sampled_logits, sampled_label = _nn.sample_logits(
        logits, label, num_samples,
        remove_accidental_hits=remove_accidental_hits)
    return _nn.softmax_with_cross_entropy(sampled_logits, sampled_label)


# --------------------------------------------------------------------------
# shape / image
# --------------------------------------------------------------------------


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    if data_format != "NCHW":
        raise ValueError("pad2d: only NCHW is supported")
    return _op("pad2d", {"X": input},
               {"paddings": list(paddings), "mode": mode,
                "pad_value": pad_value}, name=name)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _op("pad_constant_like", {"X": x, "Y": y},
               {"pad_value": pad_value}, name=name)


def crop(x, shape=None, offsets=None, name=None):
    if shape is None or isinstance(shape, Variable):
        raise ValueError("crop: pass a static `shape` list (dense design)")
    return _op("crop", {"X": x},
               {"shape": list(shape),
                "offsets": list(offsets or [0] * len(shape))}, name=name)


def pixel_shuffle(x, upscale_factor, name=None):
    return _op("pixel_shuffle", {"X": x},
               {"upscale_factor": upscale_factor}, name=name)


def shuffle_channel(x, group, name=None):
    return _op("shuffle_channel", {"X": x}, {"group": group}, name=name)


def space_to_depth(x, blocksize, name=None):
    return _op("space_to_depth", {"X": x}, {"blocksize": blocksize},
               name=name)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _op("temporal_shift", {"X": x},
               {"seg_num": seg_num, "shift_ratio": shift_ratio}, name=name)


def grid_sampler(x, grid, name=None):
    return _op("grid_sampler", {"X": x, "Grid": grid}, name=name)


def affine_channel(x, scale=None, bias=None, data_layout="NCHW",
                   name=None, act=None):
    out = _op("affine_channel", {"X": x, "Scale": scale, "Bias": bias},
              {"data_layout": data_layout}, name=name)
    if act:
        helper = LayerHelper("affine_channel", act=act)
        out = helper.append_activation(out)
    return out


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False):
    """Accumulated-statistics normalization (reference: layers/nn.py
    data_norm + data_norm_op.cc). The three accumulators are persistable
    parameters updated by the training program externally (as the
    reference's gradient-less stats params)."""
    helper = LayerHelper("data_norm", name=name, act=act)
    c = int(input.shape[-1] if data_layout == "NHWC" else input.shape[1])
    from paddle_tpu_torch.initializer import ConstantInitializer

    bsize = helper.create_parameter(
        ParamAttr._to_attr(param_attr), [c], input.dtype,
        default_initializer=ConstantInitializer(1e4))
    bsum = helper.create_parameter(
        ParamAttr(name=(name or helper.name) + ".batch_sum",
                  initializer=ConstantInitializer(0.0)), [c], input.dtype)
    bsq = helper.create_parameter(
        ParamAttr(name=(name or helper.name) + ".batch_square_sum",
                  initializer=ConstantInitializer(1e4)), [c], input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    means = helper.create_variable_for_type_inference(dtype=input.dtype)
    scales = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        "data_norm",
        inputs={"X": [input], "BatchSize": [bsize], "BatchSum": [bsum],
                "BatchSquareSum": [bsq]},
        outputs={"Y": [out], "Means": [means], "Scales": [scales]},
        attrs={"epsilon": epsilon})
    return helper.append_activation(out)


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead row convolution (reference: layers/nn.py row_conv)."""
    helper = LayerHelper("row_conv", act=act)
    d = int(input.shape[-1])
    w = helper.create_parameter(
        ParamAttr._to_attr(param_attr), [future_context_size + 1, d],
        input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("row_conv", inputs={"X": [input], "Filter": [w]},
                     outputs={"Out": [out]}, attrs={})
    return helper.append_activation(out)


def fsp_matrix(x, y):
    return _op("fsp", {"X": x, "Y": y})


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None,
                 align_corners=True, align_mode=1):
    op = {"BILINEAR": "bilinear_interp",
          "NEAREST": "nearest_interp"}.get(resample.upper())
    if op is None:
        raise ValueError(f"image_resize: unsupported resample {resample}")
    attrs = {"align_corners": align_corners, "align_mode": align_mode}
    if scale:
        attrs["scale"] = float(scale)
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
    return _op(op, {"X": input}, attrs, name=name)


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None, align_corners=True, align_mode=1):
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        actual_shape, align_corners, align_mode)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   actual_shape=None, align_corners=True):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        actual_shape, align_corners, align_mode=1)


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resize so the SHORT side equals out_short_len (reference:
    layers/nn.py image_resize_short); static shapes."""
    h, w = int(input.shape[2]), int(input.shape[3])
    short, long_ = (h, w) if h < w else (w, h)
    new_long = int(long_ * out_short_len / short)
    out_shape = ([out_short_len, new_long] if h < w
                 else [new_long, out_short_len])
    return image_resize(input, out_shape=out_shape, resample=resample)


def continuous_value_model(input, cvm, use_cvm=True):
    return _op("cvm", {"X": input, "CVM": cvm}, {"use_cvm": use_cvm},
               out_slots=("Y",))


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    return _op("sampling_id", {"X": x}, {"min": min, "max": max,
                                         "seed": seed},
               dtypes=("int64",), stop_gradient=True)


# --------------------------------------------------------------------------
# sequence tail (dense/padded: [B, T, ...] + Length)
# --------------------------------------------------------------------------


def sequence_concat(input, name=None):
    """Concatenate along TIME (reference: sequence_concat_op.cc); dense
    design concatenates the padded time axes."""
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op("sequence_concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={})
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    return _op("sequence_enumerate", {"X": input},
                   {"win_size": win_size, "pad_value": pad_value})


def sequence_expand_as(x, y, name=None):
    return _op("sequence_expand_as", {"X": x, "Y": y})


def sequence_first_step(input, length=None):
    ins = {"X": input}
    if length is not None:
        ins["Length"] = length
    return _op("sequence_pool", ins, {"pooltype": "FIRST"})


def sequence_last_step(input, length=None):
    ins = {"X": input}
    if length is not None:
        ins["Length"] = length
    return _op("sequence_pool", ins, {"pooltype": "LAST"})


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    ins = {"X": x, "PadValue": pad_value}
    if length is not None:
        ins["Length"] = length
    out, out_len = _op("sequence_pad", ins,
                       {"padded_length": maxlen or -1},
                       out_slots=("Out", "OutLength"),
                       dtypes=(None, "int64"))
    return out, out_len


def sequence_unpad(x, length, name=None):
    return _op("sequence_unpad", {"X": x, "Length": length})


def sequence_reshape(input, new_dim):
    return _op("sequence_reshape", {"X": input}, {"new_dim": new_dim})


def sequence_scatter(input, index, updates, name=None):
    return _op("sequence_scatter",
                   {"X": input, "Ids": index, "Updates": updates})


def sequence_slice(input, offset, length, name=None):
    return _op("sequence_slice",
                   {"X": input, "Offset": offset, "Length": length})


# --------------------------------------------------------------------------
# tensor / control flow / misc
# --------------------------------------------------------------------------


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    return _op("fill_constant_batch_size_like", {"Input": input},
               {"shape": list(shape), "dtype": dtype, "value": value,
                "input_dim_idx": input_dim_idx,
                "output_dim_idx": output_dim_idx},
               dtypes=(dtype,), stop_gradient=True)


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    return _op("uniform_random_batch_size_like", {"Input": input},
               {"shape": list(shape), "dtype": dtype, "min": min,
                "max": max, "input_dim_idx": input_dim_idx,
                "output_dim_idx": output_dim_idx},
               dtypes=(dtype,), stop_gradient=True)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    return _op("gaussian_random_batch_size_like", {"Input": input},
               {"shape": list(shape), "dtype": dtype, "mean": mean,
                "std": std, "input_dim_idx": input_dim_idx,
                "output_dim_idx": output_dim_idx},
               dtypes=(dtype,), stop_gradient=True)


def range(start, end, step, dtype):
    from paddle_tpu_torch.layers.tensor import range_

    return range_(start, end, step, dtype)


def create_array(dtype, maxlen, template=None, value=0.0):
    """Fixed-capacity dense array (the reference's LoDTensorArray; see
    control_flow.array_fill: a captured step needs static shapes, so the
    capacity is declared up front)."""
    from paddle_tpu_torch.layers.control_flow import array_fill

    if template is None:
        raise ValueError(
            "create_array needs a `template` variable: the dense design "
            "preallocates [maxlen, *template.shape]")
    return array_fill(maxlen, template, value)


def array_write(x, i, array):
    """Write x at position i (reference: array_write). Returns the
    UPDATED array (functional, not in place)."""
    from paddle_tpu_torch.layers.control_flow import array_write_step

    return array_write_step(array, i, x)


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    helper.append_op("dynamic_slice",
                     inputs={"X": [array], "Index": [i]},
                     outputs={"Out": [out]}, attrs={})
    return out


def array_length(array):
    """Capacity of a dense array (static; reference returned the dynamic
    length — the dense design tracks live length separately when
    needed)."""
    from paddle_tpu_torch.layers.tensor import fill_constant

    return fill_constant(shape=[1], dtype="int64",
                         value=int((array.shape or (0,))[0]))


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Persistable step counter incremented each run (reference:
    layers/nn.py autoincreased_step_counter)."""
    from paddle_tpu_torch.framework import default_startup_program

    helper = LayerHelper("step_counter")
    name = counter_name or "@STEP_COUNTER@"
    block = helper.main_program.global_block()
    counter = block.create_var(name=name, shape=(1,), dtype="int64",
                               persistable=True)
    sb = default_startup_program().global_block()
    sv = sb.create_var(name=name, shape=(1,), dtype="int64",
                       persistable=True)
    sb.append_op("fill_constant",
                 inputs={}, outputs={"Out": [sv]},
                 attrs={"shape": [1], "dtype": "int64",
                        "value": float(begin - step)})
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op("increment", inputs={"X": [counter]},
                     outputs={"Out": [out]}, attrs={"step": float(step)})
    helper.append_op("assign", inputs={"X": [out]},
                     outputs={"Out": [counter]}, attrs={})
    return out


def lod_reset(x, y=None, target_lod=None):
    """Identity in the dense/padded design: sequence structure is carried
    by explicit Length tensors, not LoD metadata (SURVEY.md §5), so
    re-binning offsets has no dense meaning. Returns x unchanged."""
    return x


# --------------------------------------------------------------------------
# rnn units
# --------------------------------------------------------------------------


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=False, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """LSTM with a recurrent projection over padded [B, T, size] gates
    (``size`` = 4 * hidden); returns (projection [B, T, proj_size], cell
    [B, T, hidden]). Peepholes raise, as in the JAX package."""
    if use_peepholes:
        raise ValueError("dynamic_lstmp: peepholes unsupported "
                         "(matches dynamic_lstm's dense design)")
    helper = LayerHelper("dynamic_lstmp", name=name, bias_attr=bias_attr)
    hidden = size // 4
    w = helper.create_parameter(ParamAttr._to_attr(param_attr),
                                [proj_size, 4 * hidden], dtype)
    wp = helper.create_parameter(
        ParamAttr(name=(name or helper.name) + ".w_proj"),
        [hidden, proj_size], dtype)
    b = helper.create_parameter(
        ParamAttr._to_attr(bias_attr), [4 * hidden], dtype, is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype=dtype)
    cell = helper.create_variable_for_type_inference(dtype=dtype)
    inputs = {"Input": [input], "Weight": [w], "ProjWeight": [wp]}
    if b is not None:
        inputs["Bias"] = [b]
    helper.append_op(
        "lstmp", inputs=inputs,
        outputs={"Projection": [proj], "Cell": [cell]},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation})
    return proj, cell


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: an fc over [x, h_prev] to the gates, then the
    ``lstm_unit`` op (gate order i, f, o, g); returns (h, c)."""
    from paddle_tpu_torch.layers import nn as _nn

    helper = LayerHelper("lstm_unit", name=name)
    hidden = int(hidden_t_prev.shape[-1])
    gates = _nn.fc(_nn.concat([x_t, hidden_t_prev], axis=-1), 4 * hidden,
                   param_attr=param_attr, bias_attr=bias_attr)
    h = helper.create_variable_for_type_inference(dtype=x_t.dtype)
    c = helper.create_variable_for_type_inference(dtype=x_t.dtype)
    helper.append_op(
        "lstm_unit", inputs={"X": [gates], "C_prev": [cell_t_prev]},
        outputs={"H": [h], "C": [c]},
        attrs={"forget_bias": float(forget_bias)})
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """One GRU step over projected gates [B, size] (``size`` = 3 *
    hidden); returns (hidden, reset hidden, gate). ``origin_mode`` rides
    the op desc and changes nothing, as in the JAX op."""
    helper = LayerHelper("gru_unit", bias_attr=bias_attr)
    h_dim = size // 3
    w = helper.create_parameter(ParamAttr._to_attr(param_attr),
                                [h_dim, 3 * h_dim], input.dtype)
    b = helper.create_parameter(ParamAttr._to_attr(bias_attr),
                                [3 * h_dim], input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    gate = helper.create_variable_for_type_inference(dtype=input.dtype)
    reset = helper.create_variable_for_type_inference(dtype=input.dtype)
    inputs = {"Input": [input], "HiddenPrev": [hidden], "Weight": [w]}
    if b is not None:
        inputs["Bias"] = [b]
    helper.append_op(
        "gru_unit", inputs=inputs,
        outputs={"Hidden": [out], "Gate": [gate],
                 "ResetHiddenPrev": [reset]},
        attrs={"activation": activation, "gate_activation": gate_activation,
               "origin_mode": origin_mode})
    return out, reset, gate


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                log_probs=None, finished=None, step_idx=None,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """One beam expansion over the dense decode state (reference:
    layers/beam_search — LoD-based; here the state is the fixed-shape
    {Ids [B, K, T], Scores [B, K], Finished [B, K]} triple the
    beam_search_step op maintains; see models/transformer.py translate for
    the end-to-end loop). ``scores``/``log_probs`` is [B, K, V] log
    p(next); ``ids`` is accepted for API parity and unused (the op
    derives candidate ids from the vocab axis)."""
    from paddle_tpu_torch.layers.tensor import fill_constant

    lp = log_probs if log_probs is not None else scores
    if finished is None:
        k = int(pre_scores.shape[-1])
        finished = fill_constant(shape=[int(pre_scores.shape[0]), k],
                                 dtype="bool", value=0.0)
    if step_idx is None:
        step_idx = fill_constant(shape=[], dtype="int64", value=0)
    ins = {"Ids": pre_ids, "Scores": pre_scores, "LogProbs": lp,
           "Finished": finished, "StepIdx": step_idx}
    out_ids, out_scores, out_fin, parent = _op(
        "beam_search_step", ins, {"end_id": int(end_id)},
        out_slots=("Ids", "Scores", "Finished", "Parent"),
        dtypes=("int64", "float32", "bool", "int64"), stop_gradient=True)
    if return_parent_idx:
        return out_ids, out_scores, out_fin, parent
    return out_ids, out_scores, out_fin


def beam_search_decode(ids, scores, beam_size=None, end_id=None, name=None):
    """Pick the best finished hypothesis per batch row (reference:
    beam_search_decode_op): Ids [B, K, T] + Scores [B, K] ->
    (best ids [B, T], best scores [B])."""
    from paddle_tpu_torch.layers import nn as _nn

    best = _nn.argmax(scores, axis=-1)                     # [B]
    best_ids = _op("beam_gather", {"X": ids, "Index": best},
                       dtypes=("int64",))
    best_scores = _op("beam_gather", {"X": scores, "Index": best})
    return best_ids, best_scores


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """Multi-layer (optionally bidirectional) LSTM over padded [B, T, D]
    input (reference: layers/nn.py lstm — the cudnn_lstm op; here each
    layer/direction is one fused lstm scan, ops/rnn_ops.py). init_h and
    init_c are accepted for API parity; the dense scans start from zeros
    like dynamic_lstm (feed nonzero states via a custom first step if
    needed). Returns (out [B, T, H*dirs], last_h, last_c)."""
    from paddle_tpu_torch.layers import nn as _nn

    helper = LayerHelper("lstm", name=name)
    x = input
    dirs = 2 if is_bidirec else 1
    last_hs, last_cs = [], []
    for layer in builtins.range(num_layers):
        outs = []
        for d in builtins.range(dirs):
            gates = _nn.fc(x, 4 * hidden_size, num_flatten_dims=2,
                           param_attr=ParamAttr(
                               name=f"{helper.name}_l{layer}d{d}.w_in"),
                           bias_attr=False)
            w = helper.create_parameter(
                ParamAttr(name=f"{helper.name}_l{layer}d{d}.w_h",
                          initializer=default_initializer),
                [hidden_size, 4 * hidden_size], input.dtype)
            b = helper.create_parameter(
                ParamAttr(name=f"{helper.name}_l{layer}d{d}.b"),
                [4 * hidden_size], input.dtype, is_bias=True)
            h_seq = helper.create_variable_for_type_inference(
                dtype=input.dtype)
            last_h = helper.create_variable_for_type_inference(
                dtype=input.dtype)
            last_c = helper.create_variable_for_type_inference(
                dtype=input.dtype)
            helper.append_op(
                "lstm",
                inputs={"Input": [gates.name], "Weight": [w.name],
                        "Bias": [b.name]},
                outputs={"Hidden": [h_seq.name], "LastH": [last_h.name],
                         "LastC": [last_c.name]},
                attrs={"is_reverse": d == 1})
            outs.append(h_seq)
            last_hs.append(last_h)
            last_cs.append(last_c)
        x = outs[0] if dirs == 1 else _nn.concat(outs, axis=-1)
        if dropout_prob and not is_test:
            x = _nn.dropout(x, dropout_prob)
    # final states stacked [num_layers*dirs, B, H] (reference cudnn_lstm
    # LastH/LastC layout)
    last_h = _nn.stack([_nn.unsqueeze(v, [0]) for v in last_hs], axis=0)
    last_h = _nn.reshape(last_h, [len(last_hs), -1, hidden_size])
    last_c = _nn.stack([_nn.unsqueeze(v, [0]) for v in last_cs], axis=0)
    last_c = _nn.reshape(last_c, [len(last_cs), -1, hidden_size])
    return x, last_h, last_c


def tensor_array_to_tensor(input, axis=1, name=None):
    """Dense-array design: the fixed-capacity array IS already a stacked
    [maxlen, ...] tensor (see create_array), so this returns it moved to
    ``axis`` plus the per-slot sizes (reference:
    tensor_array_to_tensor_op.cc concatenates LoDTensorArray slots)."""
    from paddle_tpu_torch.layers import nn as _nn
    from paddle_tpu_torch.layers.tensor import fill_constant

    n = int((input.shape or (0,))[0])
    out = input
    if axis != 0:
        perm = list(builtins.range(len(input.shape or ())))
        perm.insert(axis, perm.pop(0))
        out = _nn.transpose(input, perm)
    sizes = fill_constant(shape=[n], dtype="int32", value=1)
    return out, sizes
