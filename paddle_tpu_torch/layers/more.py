"""Layers of the JAX package's ``layers/more.py`` that the ported
modules use: the all-finite check and ``greater_equal`` (amp.py's
loss-scaling state machine builds on both), four activations, and the
recurrent units ``dynamic_lstmp``, ``lstm_unit`` and ``gru_unit``
(ops/rnn_ops.py), and the dense arrays ``create_array`` /
``array_write`` / ``array_read`` (a preallocated ``[maxlen, ...]``
tensor, layers/control_flow.py ``array_fill``). The bool outputs are fresh vars that stop gradients;
``greater_equal`` takes ``cond`` for the JAX package's signature and
builds a new var, as there."""

from __future__ import annotations

from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layer_helper import append_simple_op as _op
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["isfinite", "greater_equal", "brelu", "soft_relu", "stanh",
           "selu", "dynamic_lstmp", "lstm_unit", "gru_unit",
           "create_array", "array_write", "array_read"]


def _bool_op(op_type, inputs, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype="bool",
                                                    stop_gradient=True)
    helper.append_op(op_type, inputs=inputs, outputs={"Out": out})
    return out


def isfinite(x, name=None):
    """One bool: every element of ``x`` (a var or a list of vars) is
    finite."""
    return _bool_op("isfinite", {"X": x}, name=name)


def greater_equal(x, y, cond=None, name=None):
    return _bool_op("greater_equal", {"X": x, "Y": y}, name=name)


# --- activations ---


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


# --- rnn units ---


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
