"""Activation ops."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op


def _unary(name, fn):
    @register_op(name)
    def _compute(ins, attrs, device, fn=fn):
        return {"Out": [fn(ins["X"][0])]}


_unary("relu", torch.relu)
_unary("abs", torch.abs)
_unary("sqrt", torch.sqrt)
_unary("sigmoid", torch.sigmoid)
_unary("log", torch.log)
_unary("exp", torch.exp)
_unary("floor", torch.floor)
_unary("cos", torch.cos)


@register_op("pow")
def _pow(ins, attrs, device):
    return {"Out": [torch.pow(ins["X"][0], attrs.get("factor", 1.0))]}


@register_op("gelu")
def _gelu(ins, attrs, device):
    """Exact erf GELU by default; ``approximate`` takes the tanh form, as
    ``jax.nn.gelu(approximate=...)`` does."""
    form = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [F.gelu(ins["X"][0], approximate=form)]}
