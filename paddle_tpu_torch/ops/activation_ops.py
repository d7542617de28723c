"""Activation ops (reference: paddle/fluid/operators/activation_op.cc).

Each op writes out the JAX package's arithmetic, attrs and defaults
(``paddle_tpu/ops/activation_ops.py``) rather than a
``torch.nn.functional`` form that differs at the edges: ``softplus``
without a linear threshold, ``leaky_relu`` with slope 1 at 0, the
sigmoid and shrink forms as written there."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op

# jax.nn.selu's constants
_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def _x(ins):
    return ins["X"][0]


def _unary(name, fn):
    @register_op(name)
    def _compute(ins, attrs, device, fn=fn):
        return {"Out": [fn(_x(ins))]}


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _elu(x, alpha):
    """jax.nn.elu: x above 0, alpha * expm1(x) at and below."""
    pos = x > 0
    return torch.where(pos, x, alpha * torch.expm1(torch.where(pos, 0.0, x)))


_unary("relu", torch.relu)
_unary("abs", torch.abs)
_unary("sqrt", torch.sqrt)
_unary("sigmoid", torch.sigmoid)
_unary("log", torch.log)
_unary("exp", torch.exp)
_unary("floor", torch.floor)
_unary("cos", torch.cos)
_unary("tanh", torch.tanh)
_unary("rsqrt", torch.rsqrt)
_unary("square", torch.square)
_unary("reciprocal", torch.reciprocal)
_unary("ceil", torch.ceil)
_unary("round", torch.round)  # half to even, as jnp.round
_unary("sin", torch.sin)
_unary("softsign", lambda x: x / (1 + torch.abs(x)))
_unary("relu6", lambda x: torch.clamp(x, 0.0, 6.0))
_unary("silu", lambda x: x * torch.sigmoid(x))


@register_op("pow")
def _pow(ins, attrs, device):
    return {"Out": [torch.pow(_x(ins), attrs.get("factor", 1.0))]}


@register_op("gelu")
def _gelu(ins, attrs, device):
    """Exact erf GELU by default; ``approximate`` takes the tanh form, as
    ``jax.nn.gelu(approximate=...)`` does."""
    form = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [F.gelu(_x(ins), approximate=form)]}


@register_op("leaky_relu")
def _leaky_relu(ins, attrs, device):
    x = _x(ins)
    return {"Out": [torch.where(x >= 0, x, attrs.get("alpha", 0.02) * x)]}


@register_op("softplus")
def _softplus_op(ins, attrs, device):
    return {"Out": [_softplus(_x(ins))]}


@register_op("elu")
def _elu_op(ins, attrs, device):
    return {"Out": [_elu(_x(ins), attrs.get("alpha", 1.0))]}


@register_op("hard_sigmoid")
def _hard_sigmoid(ins, attrs, device):
    slope = attrs.get("slope", 0.2)
    offset = attrs.get("offset", 0.5)
    return {"Out": [torch.clamp(_x(ins) * slope + offset, 0.0, 1.0)]}


@register_op("swish")
def _swish(ins, attrs, device):
    x = _x(ins)
    return {"Out": [x * torch.sigmoid(attrs.get("beta", 1.0) * x)]}


@register_op("hard_swish")
def _hard_swish(ins, attrs, device):
    x = _x(ins)
    threshold = attrs.get("threshold", 6.0)
    scale = attrs.get("scale", 6.0)
    offset = attrs.get("offset", 3.0)
    return {"Out": [x * torch.clamp(x + offset, 0.0, threshold) / scale]}


@register_op("logsigmoid")
def _logsigmoid(ins, attrs, device):
    """jax.nn.log_sigmoid: -softplus(-x)."""
    return {"Out": [-_softplus(-_x(ins))]}


@register_op("tanh_shrink")
def _tanh_shrink(ins, attrs, device):
    x = _x(ins)
    return {"Out": [x - torch.tanh(x)]}


@register_op("softshrink")
def _softshrink(ins, attrs, device):
    x = _x(ins)
    lam = attrs.get("lambda", 0.5)
    return {"Out": [torch.where(x > lam, x - lam,
                                torch.where(x < -lam, x + lam, 0.0))]}


@register_op("hard_shrink")
def _hard_shrink(ins, attrs, device):
    x = _x(ins)
    return {"Out": [torch.where(torch.abs(x) > attrs.get("threshold", 0.5),
                                x, 0.0)]}


@register_op("brelu")
def _brelu(ins, attrs, device):
    return {"Out": [torch.clamp(_x(ins), attrs.get("t_min", 0.0),
                                attrs.get("t_max", 24.0))]}


@register_op("soft_relu")
def _soft_relu(ins, attrs, device):
    t = attrs.get("threshold", 40.0)
    return {"Out": [torch.log1p(torch.exp(torch.clamp(_x(ins), -t, t)))]}


@register_op("stanh")
def _stanh(ins, attrs, device):
    a = attrs.get("scale_a", 0.67)
    b = attrs.get("scale_b", 1.7159)
    return {"Out": [b * torch.tanh(a * _x(ins))]}


@register_op("thresholded_relu")
def _thresholded_relu(ins, attrs, device):
    x = _x(ins)
    return {"Out": [torch.where(x > attrs.get("threshold", 1.0), x, 0.0)]}


@register_op("selu")
def _selu(ins, attrs, device):
    """jax.nn.selu's fixed constants: the JAX op reads no attr (the
    layer's ``scale`` / ``alpha`` are recorded and ignored, as there)."""
    return {"Out": [_SELU_SCALE * _elu(_x(ins), _SELU_ALPHA)]}
