"""Operator library: the op types the ported models' training and serving
programs use, each a plain PyTorch function (see core/registry.py)."""

from paddle_tpu_torch.ops import (  # noqa: F401
    activation_ops,
    attention_ops,
    math_ops,
    nn_ops,
    optimizer_ops,
    quant_ops,
    serving_ops,
    tensor_ops,
)
