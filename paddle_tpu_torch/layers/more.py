"""Layers of the JAX package's ``layers/more.py`` that the ported
modules use: the all-finite check and ``greater_equal`` (amp.py's
loss-scaling state machine builds on both). Each output is a fresh bool
var that stops gradients; ``greater_equal`` takes ``cond`` for the JAX
package's signature and builds a new var, as there."""

from __future__ import annotations

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["isfinite", "greater_equal"]


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
