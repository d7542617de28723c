"""Activation ops."""

from __future__ import annotations

import torch

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
