"""Recurrent layers: ``dynamic_lstm`` and ``dynamic_gru``.

As in the JAX package (``paddle_tpu/layers/rnn.py``) and the reference
API (layers/nn.py ``dynamic_lstm`` / ``dynamic_gru``), the input-to-hidden
projection is not part of these layers: callers project with ``fc``
first (one matmul over all time steps), and the layer runs only the
recurrence (ops/rnn_ops.py) over a padded ``[B, T, 4H | 3H]`` input with
an optional ``length``.
"""

from __future__ import annotations

from paddle_tpu_torch.framework import Variable
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["dynamic_lstm", "dynamic_gru"]


def dynamic_lstm(
    input: Variable,
    size: int,
    length: Variable = None,
    h_0: Variable = None,
    c_0: Variable = None,
    param_attr=None,
    bias_attr=None,
    use_peepholes: bool = False,
    is_reverse: bool = False,
    gate_activation: str = "sigmoid",
    cell_activation: str = "tanh",
    candidate_activation: str = "tanh",
    dtype: str = "float32",
    name=None,
):
    """LSTM over ``input`` [B, T, size] (projected gates, ``size`` = 4H);
    returns (hidden [B, T, H], cell [B, T, H]). Peepholes raise, as in
    the JAX package."""
    if use_peepholes:
        raise NotImplementedError(
            "peephole connections are not supported (rarely used; the "
            "reference defaults them on but every benchmark model disables "
            "them)")
    helper = LayerHelper("lstm", name=name, param_attr=param_attr,
                         bias_attr=bias_attr)
    weight = helper.create_parameter(param_attr, shape=[size // 4, size],
                                     dtype=dtype)
    bias = helper.create_parameter(bias_attr, shape=[size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": input, "Weight": weight}
    for slot, var in (("Bias", bias), ("H0", h_0), ("C0", c_0),
                      ("Length", length)):
        if var is not None:
            inputs[slot] = var
    helper.append_op(
        "lstm", inputs=inputs,
        outputs={"Hidden": hidden, "Cell": cell, "LastH": last_h,
                 "LastC": last_c},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_gru(
    input: Variable,
    size: int,
    length: Variable = None,
    h_0: Variable = None,
    param_attr=None,
    bias_attr=None,
    is_reverse: bool = False,
    gate_activation: str = "sigmoid",
    candidate_activation: str = "tanh",
    dtype: str = "float32",
    name=None,
):
    """GRU over ``input`` [B, T, 3 * size] (projected gates); returns
    hidden [B, T, size]."""
    helper = LayerHelper("gru", name=name, param_attr=param_attr,
                         bias_attr=bias_attr)
    weight = helper.create_parameter(param_attr, shape=[size, 3 * size],
                                     dtype=dtype)
    bias = helper.create_parameter(bias_attr, shape=[3 * size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": input, "Weight": weight}
    for slot, var in (("Bias", bias), ("H0", h_0), ("Length", length)):
        if var is not None:
            inputs[slot] = var
    helper.append_op(
        "gru", inputs=inputs, outputs={"Hidden": hidden, "LastH": last_h},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "activation": candidate_activation})
    return hidden
