"""Operator library: the op types the ported models' training and serving
programs use, each a plain PyTorch function (see core/registry.py)."""

from paddle_tpu_torch.ops import (  # noqa: F401
    activation_ops,
    attention_ops,
    control_flow_ops,
    crf_ops,
    decode_ops,
    detection_ops,
    math_ops,
    metric_ops,
    misc_ops,
    nn_ops,
    optimizer_ops,
    quant_ops,
    rnn_ops,
    sequence_ops,
    serving_ops,
    sparse_ops,
    tensor_ops,
    vision_ops,
)
