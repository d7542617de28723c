"""Dense math ops: elementwise, matmul, reductions, casts.

Broadcasting follows Fluid's ``axis`` convention for elementwise ops (Y
aligned to X starting at ``axis``; -1 = numpy trailing alignment).
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.framework import torch_dtype


def _x(ins, slot="X", i=0):
    return ins[slot][i]


def _bcast_y(x, y, axis):
    """Reshape y per Fluid's elementwise axis rule."""
    if axis is None or axis == -1 or y.dim() == x.dim():
        return y
    axis = int(axis)
    new_shape = (1,) * axis + tuple(y.shape) + (1,) * (x.dim() - axis - y.dim())
    return y.reshape(new_shape)


def _make_elementwise(name, fn):
    @register_op(name, doc=f"elementwise {name}")
    def _compute(ins, attrs, device, fn=fn):
        x, y = _x(ins), _x(ins, "Y")
        return {"Out": [fn(x, _bcast_y(x, y, attrs.get("axis", -1)))]}

    return _compute


_make_elementwise("elementwise_add", torch.add)
_make_elementwise("elementwise_sub", torch.sub)
_make_elementwise("elementwise_mul", torch.mul)
_make_elementwise("elementwise_div", torch.div)
_make_elementwise("elementwise_pow", torch.pow)
_make_elementwise("elementwise_max", torch.maximum)


def _make_compare(name, fn):
    @register_op(name, no_grad=True)
    def _compute(ins, attrs, device, fn=fn):
        x, y = _x(ins), _x(ins, "Y")
        return {"Out": [fn(x, _bcast_y(x, y, attrs.get("axis", -1)))]}


_make_compare("equal", torch.eq)
_make_compare("less_than", torch.lt)
_make_compare("greater_equal", torch.ge)


@register_op("logical_and", no_grad=True)
def _logical_and(ins, attrs, device):
    return {"Out": [torch.logical_and(_x(ins), _x(ins, "Y"))]}


@register_op("logical_not", no_grad=True)
def _logical_not(ins, attrs, device):
    return {"Out": [torch.logical_not(_x(ins))]}


@register_op("mul", doc="2D projection matmul with flatten dims (mul_op.cc)")
def _mul(ins, attrs, device):
    """X flattened to 2-D at ``x_num_col_dims``, Y at ``y_num_col_dims``;
    the product is reshaped back to ``X.shape[:xnc] + Y.shape[ync:]``."""
    x, y = _x(ins), _x(ins, "Y")
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xnc]), -1)
    y2 = y.reshape(math.prod(ys[:ync]), -1)
    return {"Out": [torch.matmul(x2, y2).reshape(xs[:xnc] + ys[ync:])]}


@register_op("sum", doc="add N tensors (sum_op.cc)")
def _sum(ins, attrs, device):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("mean", doc="mean over all elements (mean_op.cc)")
def _mean(ins, attrs, device):
    return {"Out": [torch.mean(_x(ins))]}


def _reduce_dims(x, attrs):
    if attrs.get("reduce_all", False):
        return tuple(range(x.dim())), attrs.get("keep_dim", False)
    dims = attrs.get("dim", [0])
    if isinstance(dims, int):
        dims = [dims]
    return tuple(d % x.dim() for d in dims), attrs.get("keep_dim", False)


@register_op("reduce_sum")
def _reduce_sum(ins, attrs, device):
    x = _x(ins)
    dims, keep = _reduce_dims(x, attrs)
    return {"Out": [torch.sum(x, dim=dims, keepdim=keep)]}


@register_op("reduce_max")
def _reduce_max(ins, attrs, device):
    x = _x(ins)
    dims, keep = _reduce_dims(x, attrs)
    return {"Out": [torch.amax(x, dim=dims, keepdim=keep)]}


@register_op("cast")
def _cast(ins, attrs, device):
    return {"Out": [_x(ins).to(torch_dtype(attrs["out_dtype"]))]}


@register_op("scale")
def _scale(ins, attrs, device):
    x = _x(ins)
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}


@register_op("clip")
def _clip(ins, attrs, device):
    return {"Out": [torch.clamp(_x(ins), attrs.get("min"), attrs.get("max"))]}


@register_op("clip_by_norm")
def _clip_by_norm(ins, attrs, device):
    """x scaled to L2 norm ``max_norm`` where its norm exceeds it, else
    unchanged (the norm guarded below by 1e-12)."""
    x = _x(ins)
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12), 1.0)
    return {"Out": [x * scale]}


@register_op("squared_l2_norm")
def _squared_l2_norm(ins, attrs, device):
    return {"Out": [torch.sum(torch.square(_x(ins))).reshape(1)]}


@register_op("isfinite", no_grad=True,
             doc="one all-finite flag over every input")
def _isfinite(ins, attrs, device):
    """One 0-d bool: every element of every input of X is finite."""
    flags = [torch.isfinite(x).all() for x in ins["X"]]
    if len(flags) == 1:
        return {"Out": [flags[0]]}
    return {"Out": [torch.stack(flags).all()]}
