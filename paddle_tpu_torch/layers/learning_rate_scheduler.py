"""Learning-rate schedules as graph ops
(reference: python/paddle/fluid/layers/learning_rate_scheduler.py).

The JAX package's schedules, op for op. Each schedule creates a persistable
global-step counter in the main program, increments it once per step, and
computes the decayed LR with ordinary ops, so the whole schedule lives
inside the captured step: the counter is state like any other persistable,
written in place by each replay and saved by a checkpoint.
"""

from __future__ import annotations

import math

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layers import nn, tensor

__all__ = [
    "noam_decay", "exponential_decay", "natural_exp_decay",
    "inverse_time_decay", "polynomial_decay", "piecewise_decay",
    "cosine_decay", "linear_lr_warmup",
]


def _global_step():
    """Create + auto-increment a float32 global step counter."""
    name = unique_name.generate("learning_rate_sched_step")
    step = tensor.create_global_var(
        shape=[1], value=0.0, dtype="float32", persistable=True, name=name
    )
    nn.increment(step, value=1.0, in_place=True)
    return step


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """lr = lr0 * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
    (reference: learning_rate_scheduler.py noam_decay)."""
    step = _global_step()
    a = nn.pow(step, factor=-0.5)
    b = nn.scale(step, scale=warmup_steps ** -1.5)
    lr = nn.scale(
        nn.elementwise_min(a, b),
        scale=float(learning_rate) * d_model ** -0.5,
    )
    return lr


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step()
    exponent = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        exponent = nn.elementwise_floordiv(
            step, tensor.fill_constant([1], "float32", float(decay_steps))
        )
    factor = nn.elementwise_pow(
        tensor.fill_constant([1], "float32", decay_rate), exponent
    )
    return nn.scale(factor, scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step()
    exponent = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        exponent = nn.elementwise_floordiv(
            step, tensor.fill_constant([1], "float32", float(decay_steps))
        )
    return nn.scale(nn.exp(nn.scale(exponent, scale=-decay_rate)),
                    scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step()
    ratio = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        ratio = nn.elementwise_floordiv(
            step, tensor.fill_constant([1], "float32", float(decay_steps))
        )
    denom = nn.scale(ratio, scale=decay_rate, bias=1.0)
    return nn.elementwise_div(
        tensor.fill_constant([1], "float32", float(learning_rate)), denom
    )


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _global_step()
    capped = nn.elementwise_min(
        step, tensor.fill_constant([1], "float32", float(decay_steps))
    )
    ratio = nn.scale(capped, scale=1.0 / decay_steps)
    one_minus = nn.scale(ratio, scale=-1.0, bias=1.0)
    decayed = nn.pow(one_minus, factor=power)
    return nn.scale(decayed, scale=float(learning_rate - end_learning_rate),
                    bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    """Piecewise-constant LR via nested where ops."""
    assert len(boundaries) + 1 == len(values)
    step = _global_step()
    lr = tensor.fill_constant([1], "float32", float(values[-1]))
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        cond = nn.less_than(
            step, tensor.fill_constant([1], "float32", float(b))
        )
        lr = nn.where(cond, tensor.fill_constant([1], "float32", float(v)), lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _global_step()
    helper = LayerHelper("cosine_decay")
    epoch_f = nn.scale(step, scale=1.0 / step_each_epoch)
    theta = nn.scale(epoch_f, scale=math.pi / epochs)
    cos_out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op("cos", inputs={"X": theta}, outputs={"Out": cos_out})
    return nn.scale(cos_out, scale=0.5 * learning_rate, bias=0.5 * learning_rate)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _global_step()
    ratio = nn.scale(step, scale=1.0 / warmup_steps)
    warm = nn.scale(ratio, scale=float(end_lr - start_lr), bias=float(start_lr))
    cond = nn.less_than(
        step, tensor.fill_constant([1], "float32", float(warmup_steps))
    )
    if not hasattr(learning_rate, "name"):
        learning_rate = tensor.fill_constant([1], "float32", float(learning_rate))
    return nn.where(cond, warm, learning_rate)
