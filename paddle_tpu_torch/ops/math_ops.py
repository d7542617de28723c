"""Dense math ops: elementwise, matmul, reductions, casts, and the
pairwise / ranking / distribution losses.

Broadcasting follows Fluid's ``axis`` convention for elementwise ops (Y
aligned to X starting at ``axis``; -1 = numpy trailing alignment).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.core import rng
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
_make_elementwise("elementwise_min", torch.minimum)
_make_elementwise("elementwise_floordiv", torch.floor_divide)
# jnp.mod: the remainder takes the divisor's sign (torch.fmod would take
# the dividend's)
_make_elementwise("elementwise_mod", torch.remainder)


def _make_compare(name, fn):
    @register_op(name, no_grad=True)
    def _compute(ins, attrs, device, fn=fn):
        x, y = _x(ins), _x(ins, "Y")
        return {"Out": [fn(x, _bcast_y(x, y, attrs.get("axis", -1)))]}


_make_compare("equal", torch.eq)
_make_compare("not_equal", torch.ne)
_make_compare("less_than", torch.lt)
_make_compare("less_equal", torch.le)
_make_compare("greater_than", torch.gt)
_make_compare("greater_equal", torch.ge)


@register_op("logical_and", no_grad=True)
def _logical_and(ins, attrs, device):
    return {"Out": [torch.logical_and(_x(ins), _x(ins, "Y"))]}


@register_op("logical_or", no_grad=True)
def _logical_or(ins, attrs, device):
    return {"Out": [torch.logical_or(_x(ins), _x(ins, "Y"))]}


@register_op("logical_xor", no_grad=True)
def _logical_xor(ins, attrs, device):
    return {"Out": [torch.logical_xor(_x(ins), _x(ins, "Y"))]}


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


@register_op("matmul", doc="batched matmul w/ transpose flags (matmul_op.cc)")
def _matmul(ins, attrs, device):
    """``torch.matmul`` with batch dims broadcast, after the JAX op's 1-D
    rule: a 1-D X is a row [1, n], a 1-D Y a column [n, 1], and the
    product keeps those dims (it is not squeezed back)."""
    x, y = _x(ins), _x(ins, "Y")
    if x.dim() == 1:
        x = x[None, :]
    if y.dim() == 1:
        y = y[:, None]
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


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


def _prod(x, dim, keepdim):
    """``torch.prod`` over several dims (it takes one at a time)."""
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, d, keepdim=keepdim)
    return x


def _make_reduce(name, fn):
    @register_op(name)
    def _compute(ins, attrs, device, fn=fn):
        x = _x(ins)
        dims, keep = _reduce_dims(x, attrs)
        return {"Out": [fn(x, dim=dims, keepdim=keep)]}


_make_reduce("reduce_sum", torch.sum)
_make_reduce("reduce_mean", torch.mean)
# amax / amin split a tie's gradient evenly, as jnp.max / jnp.min do
_make_reduce("reduce_max", torch.amax)
_make_reduce("reduce_min", torch.amin)
_make_reduce("reduce_prod", _prod)


@register_op("increment")
def _increment(ins, attrs, device):
    """X + step, the step taken in X's dtype (an integer X adds the step
    truncated toward zero, as the JAX op's cast does)."""
    x = _x(ins)
    step = attrs.get("step", 1.0)
    return {"Out": [x + (step if x.is_floating_point() else int(step))]}


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


@register_op("p_norm")
def _p_norm(ins, attrs, device):
    """sum(|x| ** porder) ** (1 / porder) over ``axis`` (all dims when
    None)."""
    x = _x(ins)
    porder = attrs.get("porder", 2.0)
    axis = attrs.get("axis", None)
    dims = tuple(range(x.dim())) if axis is None else axis
    out = torch.sum(torch.abs(x) ** porder, dim=dims,
                    keepdim=attrs.get("keepdim", False))
    return {"Out": [out ** (1.0 / porder)]}


# --- pairwise / ranking / distribution losses (operators/*_loss_op.cc) ---


def _softplus0(d):
    """log(1 + e^d) as ``logaddexp(0, d)`` (``F.softplus`` turns linear
    past its threshold; the JAX ops do not)."""
    return torch.logaddexp(torch.zeros_like(d), d)


@register_op("log_loss", diff_inputs=("Predicted",))
def _log_loss(ins, attrs, device):
    """-(y log(p + eps) + (1 - y) log(1 - p + eps))."""
    p, y = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-(y * torch.log(p + eps)
                       + (1.0 - y) * torch.log(1.0 - p + eps))]}


@register_op("rank_loss", diff_inputs=("Left", "Right"))
def _rank_loss(ins, attrs, device):
    """RankNet: log(1 + e^d) - label * d, d = left - right."""
    d = ins["Left"][0] - ins["Right"][0]
    return {"Out": [_softplus0(d) - ins["Label"][0] * d]}


@register_op("margin_rank_loss", diff_inputs=("X1", "X2"))
def _margin_rank_loss(ins, attrs, device):
    """max(0, -label * (x1 - x2) + margin); Activated = (loss > 0)."""
    x1, x2 = ins["X1"][0], ins["X2"][0]
    act = torch.clamp_min(-ins["Label"][0] * (x1 - x2)
                          + attrs.get("margin", 0.0), 0.0)
    return {"Out": [act], "Activated": [(act > 0).to(x1.dtype)]}


@register_op("hinge_loss", diff_inputs=("Logits",))
def _hinge_loss(ins, attrs, device):
    """max(0, 1 - (2y - 1) * logit)."""
    logits, y = ins["Logits"][0], ins["Labels"][0]
    return {"Loss": [torch.clamp_min(1.0 - (2.0 * y - 1.0) * logits, 0.0)]}


@register_op("kldiv_loss", diff_inputs=("X",))
def _kldiv_loss(ins, attrs, device):
    """t * (log t - x) where t > 0, else 0 (x in log space), reduced by
    ``reduction`` (mean, sum, batchmean; none keeps the elements)."""
    x, t = ins["X"][0], ins["Target"][0]
    out = t * (torch.log(torch.clamp_min(t, 1e-30)) - x)
    out = torch.where(t > 0, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))
    red = attrs.get("reduction", "mean")
    if red == "mean":
        out = out.mean()
    elif red == "sum":
        out = out.sum()
    elif red == "batchmean":
        out = out.sum() / x.shape[0]
    return {"Loss": [out]}


@register_op("bpr_loss", diff_inputs=("X",))
def _bpr_loss(ins, attrs, device):
    """Bayesian personalized ranking over raw scores X [N, C], Label
    [N, 1]: the mean over the C - 1 other classes of -log sigmoid(x_pos -
    x_j)."""
    x, label = ins["X"][0], ins["Label"][0]
    if label.dim() > 1:
        label = label.squeeze(-1)
    c = x.shape[1]
    label = label.to(torch.int64)
    pos = torch.gather(x, 1, label[:, None])
    lo = _softplus0(x - pos)
    mask = label[:, None] == torch.arange(c, device=x.device)
    lo = torch.where(mask, torch.zeros((), dtype=x.dtype, device=x.device),
                     lo)
    return {"Y": [lo.sum(dim=1, keepdim=True) / (c - 1)]}


@register_op("cos_sim", diff_inputs=("X", "Y"))
def _cos_sim(ins, attrs, device):
    """Row-wise cosine similarity over the last dim (Y may be one row),
    the norms' product floored at 1e-12; XNorm, YNorm the row norms."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    yn = torch.sqrt((y * y).sum(dim=-1, keepdim=True))
    out = (x * y).sum(dim=-1, keepdim=True) / torch.clamp_min(xn * yn,
                                                               1e-12)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register_op("sign", no_grad=True)
def _sign(ins, attrs, device):
    return {"Out": [torch.sign(_x(ins))]}


@register_op("minus", diff_inputs=("X", "Y"))
def _minus(ins, attrs, device):
    return {"Out": [_x(ins) - _x(ins, "Y")]}


@register_op("l1_norm", diff_inputs=("X",))
def _l1_norm(ins, attrs, device):
    return {"Out": [torch.abs(_x(ins)).sum()]}


@register_op("squared_l2_distance", diff_inputs=("X", "Y"))
def _squared_l2_distance(ins, attrs, device):
    """Row-wise ||x - y||^2 as [N, 1]; sub_result = x - y."""
    sub = _x(ins) - _x(ins, "Y")
    out = torch.square(sub).sum(dim=tuple(range(1, sub.dim())))
    return {"Out": [out[:, None]], "sub_result": [sub]}


@register_op("modified_huber_loss", diff_inputs=("X",))
def _modified_huber_loss(ins, attrs, device):
    """z = x * (2y - 1): -4z below -1, (1 - z)^2 below 1, else 0."""
    z = _x(ins) * (2.0 * _x(ins, "Y") - 1.0)
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    loss = torch.where(z < -1.0, -4.0 * z,
                       torch.where(z < 1.0, torch.square(1.0 - z), zero))
    return {"Out": [loss], "IntermediateVal": [z]}


@register_op("teacher_student_sigmoid_loss", diff_inputs=("X",))
def _teacher_student_sigmoid_loss(ins, attrs, device):
    """CTR distillation: z = clip(x); log(1 + e^z) - z [label > 0], plus
    log(1 + e^z) - z * label where label > 0."""
    x, label = _x(ins), _x(ins, "Label")
    z = torch.clamp(x, float(attrs.get("soft_max_lower_bound", -15.0)),
                    float(attrs.get("soft_max_up_bound", 15.0)))
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    sp = torch.log1p(torch.exp(z))
    hard = sp - torch.where(label > 0.0, z, zero)
    teacher = torch.where(label > 0.0, sp - z * label, zero)
    return {"Y": [hard + teacher]}


@register_op("cvm", diff_inputs=("X",))
def _cvm(ins, attrs, device):
    """Click-value normalization: the first two columns (show, click)
    become log(show + 1) and log(click + 1) - log(show + 1) (use_cvm), or
    are dropped."""
    x = _x(ins)
    show = torch.log(x[:, 0:1] + 1.0)
    click = torch.log(x[:, 1:2] + 1.0) - show
    if attrs.get("use_cvm", True):
        return {"Y": [torch.cat([show, click, x[:, 2:]], dim=1)]}
    return {"Y": [x[:, 2:]]}


@register_op("data_norm", diff_inputs=("X",))
def _data_norm(ins, attrs, device):
    """(x - sum / size) * sqrt(size / square_sum) from the accumulated
    statistics (data_norm_op.cc: no mean subtraction in the scale)."""
    x = _x(ins)
    bsize = ins["BatchSize"][0]
    means = ins["BatchSum"][0] / bsize
    scales = torch.sqrt(bsize / ins["BatchSquareSum"][0])
    return {"Y": [(x - means) * scales], "Means": [means],
            "Scales": [scales]}


@register_op("spectral_norm", diff_inputs=("Weight",))
def _spectral_norm(ins, attrs, device):
    """Weight / sigma, sigma from ``power_iters`` power iterations of the
    stored vectors U, V (detached); UOut / VOut are the iterated vectors,
    which the layer names as U / V, so they persist across steps (in place
    in a captured step, as batch_norm's MeanOut)."""
    w, u0, v0 = ins["Weight"][0], ins["U"][0], ins["V"][0]
    dim = int(attrs.get("dim", 0))
    eps = float(attrs.get("eps", 1e-12))
    wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    u, v = u0.reshape(-1), v0.reshape(-1)
    wd = wm.detach()
    for _ in range(int(attrs.get("power_iters", 1))):
        v = wd.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wd @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    u, v = u.detach(), v.detach()
    sigma = u @ wm @ v
    return {"Out": [w / sigma], "UOut": [u.reshape(u0.shape)],
            "VOut": [v.reshape(v0.shape)]}


@register_op("fsp", diff_inputs=("X", "Y"))
def _fsp(ins, attrs, device):
    """Gram matrix of two NCHW feature maps over their h * w cells, / (h
    * w)."""
    x, y = _x(ins), _x(ins, "Y")
    n, cx, h, w = x.shape
    out = torch.einsum("ncl,nkl->nck", x.reshape(n, cx, h * w),
                       y.reshape(n, y.shape[1], h * w)) / (h * w)
    return {"Out": [out]}


@register_op("is_empty", no_grad=True)
def _is_empty(ins, attrs, device):
    """0-d bool: X has no element (a fill on X's device, no host read)."""
    x = _x(ins)
    return {"Out": [torch.full((), x.numel() == 0, dtype=torch.bool,
                               device=x.device)]}


@register_op("fill", no_grad=True)
def _fill(ins, attrs, device):
    """``value`` reshaped to ``shape``, made on the device one fill an
    element (no host copy, so a captured step may hold it)."""
    from paddle_tpu_torch.ops.tensor_ops import _const

    vals = np.asarray(attrs["value"], dtype=np.dtype(
        attrs.get("dtype", "float32"))).reshape(-1).tolist()
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [_const(vals, dtype, device).reshape(
        tuple(attrs["shape"]))]}


def _batch_size_like_shape(ins, attrs):
    ref = ins["Input"][0]
    shape = list(attrs["shape"])
    shape[int(attrs.get("output_dim_idx", 0))] = ref.shape[
        int(attrs.get("input_dim_idx", 0))]
    return tuple(shape), ref.device


@register_op("uniform_random_batch_size_like", needs_rng=True, no_grad=True)
def _uniform_random_batch_size_like(ins, attrs, device, seed=None):
    """Uniform values in [min, max) of ``shape`` with Input's batch, drawn
    on the device from the op seed (``rng.op_uniform01``, f64, rounded
    once to ``dtype``): the CPU and the card draw the same bits."""
    shape, dev = _batch_size_like_shape(ins, attrs)
    lo, hi = float(attrs.get("min", -1.0)), float(attrs.get("max", 1.0))
    u = rng.op_uniform01(0 if seed is None else seed, shape, dev)
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [(lo + (hi - lo) * u).to(dtype)]}


@register_op("gaussian_random_batch_size_like", needs_rng=True,
             no_grad=True)
def _gaussian_random_batch_size_like(ins, attrs, device, seed=None):
    """mean + std * N(0, 1) of ``shape`` with Input's batch, drawn on the
    device from the op seed (``rng.op_normal``, f64, rounded once)."""
    shape, dev = _batch_size_like_shape(ins, attrs)
    z = rng.op_normal(0 if seed is None else seed, shape, dev)
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return {"Out": [out.to(torch_dtype(attrs.get("dtype", "float32")))]}


@register_op("cross_entropy2", diff_inputs=("X",))
def _cross_entropy2(ins, attrs, device):
    """Hard-label cross entropy over probabilities: Y = -log(X[label])
    (the pick floored at 1e-20), 0 at ``ignore_index``; MatchX the picks
    (1 where ignored); XShape an empty [..., 0] tensor."""
    x, label = _x(ins), _x(ins, "Label")
    ignore_index = int(attrs.get("ignore_index", -100))
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    lab = label.reshape(-1).to(torch.int64)
    match = torch.gather(x2, 1, lab.clamp(0, c - 1)[:, None])
    ignored = (lab == ignore_index)[:, None]
    y = torch.where(ignored, torch.zeros((), dtype=x.dtype, device=x.device),
                    -torch.log(torch.clamp_min(match, 1e-20)))
    match = torch.where(ignored, torch.ones((), dtype=x.dtype,
                                            device=x.device), match)
    out_shape = tuple(x.shape[:-1]) + (1,)
    return {"Y": [y.reshape(out_shape)],
            "MatchX": [match.reshape(out_shape)],
            "XShape": [x.new_zeros(tuple(x.shape) + (0,))]}


@register_op("fill_zeros_like2", no_grad=True)
def _fill_zeros_like2(ins, attrs, device):
    return {"Out": [torch.zeros_like(_x(ins))]}


def _bool_reduce(ins, attrs, fn):
    x = _x(ins).to(torch.bool)
    dim = attrs.get("dim", None)
    keep = bool(attrs.get("keep_dim", False))
    dims = tuple(dim) if dim else tuple(range(x.dim()))
    if not dims:
        return x.clone()
    return fn(x, dim=dims, keepdim=keep)


@register_op("reduce_all", no_grad=True)
def _reduce_all(ins, attrs, device):
    """Logical AND over ``dim`` (all dims when empty or None)."""
    return {"Out": [_bool_reduce(ins, attrs, torch.all)]}


@register_op("reduce_any", no_grad=True)
def _reduce_any(ins, attrs, device):
    """Logical OR over ``dim`` (all dims when empty or None)."""
    return {"Out": [_bool_reduce(ins, attrs, torch.any)]}


@register_op("has_inf", no_grad=True)
def _has_inf(ins, attrs, device):
    return {"Out": [torch.isinf(_x(ins)).any()]}


@register_op("has_nan", no_grad=True)
def _has_nan(ins, attrs, device):
    return {"Out": [torch.isnan(_x(ins)).any()]}
