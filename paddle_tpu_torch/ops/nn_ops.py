"""NN ops: convolution, pooling, normalization, dropout, losses and
metrics.

Convolutions are plain products that the JAX package leaves to XLA
(``lax.conv_general_dilated``); here they go to ``F.conv2d`` (cuDNN on
the card), as ``mul`` goes to ``torch.matmul``. The interface and the
memory layout are NCHW: laying the convolutions' operands out channels
last was measured on an H100 and gained nothing (cuDNN converts bf16
NCHW operands itself, and the per-channel reductions of ``batch_norm``
run slower over channels-last memory; PERF.md).

The ``dropout`` op's training forward is a kernel written by hand
(``dropout_fwd``: ``dropout_apply_kernel`` in csrc/dropout_mask.cu on a
CUDA tensor, ``dropout_plain`` on the CPU), whose keep mask is the hash
of the op seed and the flat element index (core/rng.py), so the CPU and
the card give the same mask and a CUDA graph a new one each step.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch import kernels
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core.registry import register_op

_DROPOUT_SOURCE = "dropout_mask"
_DROPOUT_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 2
                 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                    ctypes.c_float, ctypes.c_void_p])
# launches of dropout_apply_kernel: kernels.launch_counts["dropout"], one
# per call of ``dropout_fwd`` on a CUDA tensor


def _x(ins, slot="X", i=0):
    v = ins.get(slot)
    return v[i] if v else None


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(d) for d in v)
    return (int(v), int(v))


def _conv(x, w, attrs, groups):
    return F.conv2d(
        x, w, None,
        stride=_pair(attrs.get("strides", [1, 1])),
        padding=_pair(attrs.get("paddings", [0, 0])),
        dilation=_pair(attrs.get("dilations", [1, 1])),
        groups=groups)


@register_op("conv2d", diff_inputs=("Input", "Filter"))
def _conv2d(ins, attrs, device):
    """2-D convolution, NCHW input and [C_out, C_in / groups, kh, kw]
    filter (conv_op.cc)."""
    x, w = _x(ins, "Input"), _x(ins, "Filter")
    return {"Output": [_conv(x, w, attrs, attrs.get("groups", 1))]}


@register_op("depthwise_conv2d", diff_inputs=("Input", "Filter"))
def _depthwise_conv2d(ins, attrs, device):
    """conv2d whose groups default to the input's channels."""
    x, w = _x(ins, "Input"), _x(ins, "Filter")
    return {"Output": [_conv(x, w, attrs, attrs.get("groups", x.shape[1]))]}


@register_op("pool2d")
def _pool2d(ins, attrs, device):
    """Max or average pooling over NCHW (pool_op.cc). Max pooling pads
    with -inf; average pooling with padding divides by the count of real
    cells when ``exclusive`` (the default), else by the window size;
    ``global_pooling`` overrides kernel, stride and padding."""
    x = _x(ins)
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", [2, 2]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    if attrs.get("global_pooling", False):
        ksize = (x.shape[2], x.shape[3])
        strides = ksize
        pads = (0, 0)
    if attrs.get("pooling_type", "max") == "max":
        return {"Out": [F.max_pool2d(x, ksize, strides, pads)]}
    exclusive = attrs.get("exclusive", True) and pads != (0, 0)
    return {"Out": [F.avg_pool2d(x, ksize, strides, pads,
                                 count_include_pad=not exclusive)]}


def _stat_dtype(dtype):
    # f32 unless f64: statistics stay in at least f32 under bf16 streams
    return torch.float64 if dtype == torch.float64 else torch.float32


@register_op("batch_norm", diff_inputs=("X", "Scale", "Bias"))
def _batch_norm(ins, attrs, device):
    """Batch normalization written out as the JAX op computes it, so f32
    results agree tightly and bf16 rounds at the same places: one-pass
    statistics in f32 (var = max(E[x^2] - E[x]^2, 0)), then the affine
    y = x * k + c in X's dtype with the per-channel k, c cast once.
    MeanOut / VarianceOut are the updated moving statistics (the layer
    names them as Mean / Variance, so the executor rebinds them like a
    ParamOut); ``is_test`` normalizes with the moving statistics. The
    statistics outputs are detached."""
    x = _x(ins)
    scale, bias = _x(ins, "Scale"), _x(ins, "Bias")
    mean, var = _x(ins, "Mean"), _x(ins, "Variance")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]

    if attrs.get("is_test", False):
        use_mean, use_var = mean, var
        new_mean, new_var = mean, var
    else:
        xf = x.to(_stat_dtype(x.dtype))
        use_mean = xf.mean(dim=axes)
        use_var = torch.clamp_min(
            xf.square().mean(dim=axes) - use_mean.square(), 0.0)
        new_mean = momentum * mean + (1 - momentum) * use_mean
        new_var = momentum * var + (1 - momentum) * use_var

    inv = torch.rsqrt(use_var + eps)
    k = inv if scale is None else inv * scale
    c = -use_mean * k
    if bias is not None:
        c = c + bias
    y = x * k.to(x.dtype).reshape(shape) + c.to(x.dtype).reshape(shape)
    return {
        "Y": [y],
        "MeanOut": [new_mean.detach()],
        "VarianceOut": [new_var.detach()],
        "SavedMean": [use_mean.detach()],
        "SavedVariance": [use_var.detach()],
    }


@register_op("layer_norm", diff_inputs=("X", "Scale", "Bias"))
def _layer_norm(ins, attrs, device):
    """Normalize over dims [begin_norm_axis, ...); statistics and the
    affine run in f32, only Y returns to X's dtype."""
    x = _x(ins)
    scale, bias = _x(ins, "Scale"), _x(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.dim()))
    xf = x.to(_stat_dtype(x.dtype))
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    feat_shape = (1,) * begin + tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape(feat_shape).to(y.dtype)
    if bias is not None:
        y = y + bias.reshape(feat_shape).to(y.dtype)
    return {
        "Y": [y.to(x.dtype)],
        "Mean": [mean.reshape(-1)],
        "Variance": [var.reshape(-1)],
    }


def dropout_plain(x, seed, p, upscale):
    """(Out, Mask) of the ``dropout`` op's training forward, in PyTorch
    integer ops: element i (flat, row-major) is kept iff
    ``row_hash(key, hi32(i), lo32(i)) < keep_threshold(p)``, with the
    stream key of ``seed``'s op seed (core/rng.py); Out is x times
    ``keep_scale(p)`` (``upscale``: one product in f32, or f64 for f64 x,
    rounded once to x's dtype) or x where kept, else 0; Mask is uint8.
    Bit for bit what ``dropout_apply_kernel`` writes."""
    key = rng.stream_key_tensor(rng.op_seed_tensor(seed, x.device))
    i = torch.arange(x.numel(), device=x.device)
    bits = rng.row_hash(key, i >> 32, i & rng.U32)
    keep = (bits < rng.keep_threshold(p)).reshape(x.shape)
    if upscale:
        wide = torch.float64 if x.dtype == torch.float64 else torch.float32
        y = (x.to(wide) * rng.keep_scale(p)).to(x.dtype)
    else:
        y = x
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(keep, y, zero), keep.to(torch.uint8)


def dropout_fwd(x, seed, p, upscale):
    """``dropout_plain``'s (Out, Mask): on a CUDA tensor from
    ``dropout_apply_kernel`` (f32 or bf16, one pass over x; the kernel reads
    the seed from device memory), on the CPU from ``dropout_plain``."""
    if x.device.type != "cuda":
        return dropout_plain(x, seed, p, upscale)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dropout kernel: dtype {x.dtype} (takes float32 "
                        f"or bfloat16)")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel moves 16 bytes at a time
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return out, mask
    seed_t, op_idx = rng.kernel_seed(seed, x.device)
    entry = kernels.function(_DROPOUT_SOURCE, "pt_dropout_fwd", _DROPOUT_ARGS)
    rc = entry(x.data_ptr(), out.data_ptr(), mask.data_ptr(), x.numel(),
               1 if x.dtype == torch.bfloat16 else 0, 1 if upscale else 0,
               seed_t.data_ptr(), op_idx, rng.keep_threshold(p),
               rng.keep_scale(p),
               torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(_DROPOUT_SOURCE, rc, "dropout_fwd")
    kernels.count("dropout")
    return out, mask


@register_op("dropout", needs_rng=True)
def _dropout(ins, attrs, device, seed=None):
    """Out = X with each element kept with probability 1 - p (Mask, uint8,
    says which); ``upscale_in_train`` scales kept elements by 1/(1 - p)
    (rounded to f32) in training, ``downgrade_in_infer`` scales by (1 - p)
    at test time. The mask is the hash of the op's seed and each element's
    index (``dropout_fwd``; its bits differ from the JAX package's). The
    kernel runs inside ``_Dropout``, whose backward is ``dropout_grad``'s,
    because a derived grad op re-runs this op with grad enabled (a scan
    body's dropout); under no_grad it is the bare kernel call."""
    x = _x(ins)
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        if impl == "upscale_in_train":
            return {"Out": [x], "Mask": []}
        return {"Out": [x * (1.0 - p)], "Mask": []}
    if p <= 0.0:
        return {"Out": [x], "Mask": []}
    seed = 0 if seed is None else seed
    upscale = impl == "upscale_in_train"
    out, mask = _Dropout.apply(x, seed, p, upscale)
    return {"Out": [out], "Mask": [mask]}


def _dropout_bwd(g, mask, p, upscale):
    """dX of a training-mode dropout from its saved Mask."""
    keep = mask.to(torch.bool)
    gs = g * rng.keep_scale(p) if upscale else g
    return torch.where(keep, gs, torch.zeros((), dtype=g.dtype,
                                             device=g.device))


class _Dropout(torch.autograd.Function):
    """``dropout_fwd`` differentiable through autograd: the backward is
    ``dropout_grad``'s arithmetic from the saved mask (no bits are drawn
    again)."""

    @staticmethod
    def forward(ctx, x, seed, p, upscale):
        out, mask = dropout_fwd(x, seed, p, upscale)
        ctx.save_for_backward(mask)
        ctx.p, ctx.upscale = p, upscale
        ctx.mark_non_differentiable(mask)
        return out, mask

    @staticmethod
    def backward(ctx, g, _g_mask):
        (mask,) = ctx.saved_tensors
        return _dropout_bwd(g, mask, ctx.p, ctx.upscale), None, None, None


@register_op("dropout_grad", no_grad=True)
def _dropout_grad(ins, attrs, device):
    """The backward of ``dropout`` from the forward's saved Mask (no
    random numbers are drawn again)."""
    g = _x(ins, "GRAD::Out")
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        dx = g if impl == "upscale_in_train" else g * (1.0 - p)
    elif p <= 0.0:  # the forward was the identity (no mask)
        dx = g
    else:
        dx = _dropout_bwd(g, _x(ins, "Mask"), p, impl == "upscale_in_train")
    return {"GRAD::X": [dx]}


@register_op("softmax")
def _softmax(ins, attrs, device):
    return {"Out": [torch.softmax(_x(ins), dim=attrs.get("axis", -1))]}


@register_op("log_softmax")
def _log_softmax(ins, attrs, device):
    return {"Out": [torch.log_softmax(_x(ins), dim=attrs.get("axis", -1))]}


@register_op("softmax_with_cross_entropy", diff_inputs=("Logits",))
def _softmax_with_cross_entropy(ins, attrs, device):
    logits, label = _x(ins, "Logits"), _x(ins, "Label")
    ignore_index = attrs.get("ignore_index", -100)
    # log-softmax over the vocab in >= f32 even when logits are bf16
    logp = torch.log_softmax(logits.to(_stat_dtype(logits.dtype)), dim=-1)
    if attrs.get("soft_label", False):
        loss = -(label * logp).sum(dim=-1, keepdim=True)
    else:
        lbl = label
        if lbl.dim() == logits.dim():
            lbl = lbl.squeeze(-1)
        lbl = lbl.to(torch.int64)
        loss = -torch.gather(logp, -1, lbl.clamp_min(0).unsqueeze(-1))
        if ignore_index >= 0:
            loss = loss * (lbl != ignore_index).unsqueeze(-1).to(loss.dtype)
    return {"Softmax": [logp.exp()], "Loss": [loss]}


@register_op("sigmoid_cross_entropy_with_logits", diff_inputs=("X",))
def _sigmoid_ce(ins, attrs, device):
    """max(x, 0) - x * label + log1p(exp(-|x|)), elementwise. The layer's
    ``ignore_index`` rides the op desc; the loss is not masked by it, as
    in the JAX op."""
    x, label = _x(ins), _x(ins, "Label")
    loss = (torch.clamp_min(x, 0.0) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))
    return {"Out": [loss]}


@register_op("square_error_cost", diff_inputs=("X", "Label"))
def _square_error_cost(ins, attrs, device):
    return {"Out": [torch.square(_x(ins) - _x(ins, "Label"))]}


@register_op("label_smooth", diff_inputs=("X",))
def _label_smooth(ins, attrs, device):
    x = _x(ins)
    eps = attrs.get("epsilon", 0.1)
    dist = _x(ins, "PriorDist")
    if dist is not None:
        return {"Out": [(1 - eps) * x + eps * dist]}
    return {"Out": [(1 - eps) * x + eps / x.shape[-1]]}


@register_op("accuracy", no_grad=True)
def _accuracy(ins, attrs, device):
    """Share of rows whose Label is among the row's top-k Indices
    (metrics/accuracy_op.cc); Correct and Total are int32."""
    indices, label = _x(ins, "Indices"), _x(ins, "Label")
    if label.dim() > 1:
        label = label.squeeze(-1)
    correct = (indices == label.unsqueeze(-1)).any(dim=-1)
    num_correct = correct.to(torch.float32).sum()
    total = torch.full((), float(indices.shape[0]), dtype=torch.float32,
                       device=indices.device)
    return {
        "Accuracy": [num_correct / total],
        "Correct": [num_correct.to(torch.int32)],
        "Total": [total.to(torch.int32)],
    }


@register_op("conv2d_transpose", diff_inputs=("Input", "Filter"))
def _conv2d_transpose(ins, attrs, device):
    """The gradient of conv2d as a forward op (conv_transpose_op.cc):
    filter [C_in, C_out / groups, kh, kw] (F.conv_transpose2d's layout),
    out H = (H - 1) s - 2p + d (k - 1) + 1."""
    x, w = _x(ins, "Input"), _x(ins, "Filter")
    return {"Output": [F.conv_transpose2d(
        x, w, None, stride=_pair(attrs.get("strides", [1, 1])),
        padding=_pair(attrs.get("paddings", [0, 0])),
        dilation=_pair(attrs.get("dilations", [1, 1])),
        groups=attrs.get("groups", 1))]}


@register_op("cross_entropy", diff_inputs=("X",))
def _cross_entropy(ins, attrs, device):
    """-log(p + 1e-8) of the label's probability (``soft_label``: -sum of
    label * log(p + 1e-8)), [..., 1]; rows at a non-negative
    ``ignore_index`` give 0."""
    x, label = _x(ins), _x(ins, "Label")
    eps = 1e-8
    if attrs.get("soft_label", False):
        return {"Y": [-(label * torch.log(x + eps)).sum(dim=-1,
                                                         keepdim=True)]}
    if label.dim() == x.dim():
        label = label.squeeze(-1)
    lbl = label.to(torch.int64)
    loss = -torch.log(torch.gather(x, -1, lbl.clamp_min(0)[..., None]) + eps)
    ignore_index = attrs.get("ignore_index", -100)
    if ignore_index >= 0:
        loss = loss * (lbl != ignore_index)[..., None].to(loss.dtype)
    return {"Y": [loss]}


@register_op("huber_loss", diff_inputs=("X",))
def _huber_loss(ins, attrs, device):
    """r = y - x: r^2 / 2 within ``delta``, else delta (|r| - delta / 2);
    Residual = r."""
    r = _x(ins, "Y") - _x(ins)
    delta = attrs.get("delta", 1.0)
    a = torch.abs(r)
    loss = torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))
    return {"Out": [loss], "Residual": [r]}


@register_op("smooth_l1_loss", diff_inputs=("X",))
def _smooth_l1(ins, attrs, device):
    """d = (x - y) * InsideWeight; 0.5 d^2 sigma^2 below 1 / sigma^2,
    else |d| - 0.5 / sigma^2; times OutsideWeight, summed over the last
    dim ([..., 1]); Diff = d."""
    d = _x(ins) - _x(ins, "Y")
    w_in, w_out = _x(ins, "InsideWeight"), _x(ins, "OutsideWeight")
    s2 = attrs.get("sigma", 1.0) ** 2
    if w_in is not None:
        d = d * w_in
    a = torch.abs(d)
    loss = torch.where(a < 1.0 / s2, 0.5 * d * d * s2, a - 0.5 / s2)
    if w_out is not None:
        loss = loss * w_out
    return {"Out": [loss.sum(dim=-1, keepdim=True)], "Diff": [d]}


def _count_add(n, idx, vals):
    """A length-``n`` f32 histogram: ``vals`` added at ``idx``. The
    values are 0 / 1, so the sums are exact in any order."""
    return torch.zeros(n, dtype=torch.float32, device=idx.device) \
        .index_add_(0, idx, vals)


@register_op("mean_iou", no_grad=True)
def _mean_iou(ins, attrs, device):
    """Mean IoU over the classes present in the batch: the confusion
    matrix of (label, prediction) counts, IoU = diagonal / (row + column
    - diagonal) (a batch-local metric: the JAX op keeps no
    accumulator)."""
    pred = _x(ins, "Predictions").reshape(-1).to(torch.int64)
    label = _x(ins, "Labels").reshape(-1).to(torch.int64)
    n = attrs["num_classes"]
    ones = torch.ones(pred.shape, dtype=torch.float32, device=pred.device)
    cm = _count_add(n * n, label * n + pred, ones).reshape(n, n)
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    iou = inter / torch.clamp_min(union, 1.0)
    valid = (union > 0).to(torch.float32)
    miou = (iou * valid).sum() / torch.clamp_min(valid.sum(), 1.0)
    return {"OutMeanIou": [miou], "OutWrong": [], "OutCorrect": []}


@register_op("maxout", diff_inputs=("X",))
def _maxout(ins, attrs, device):
    """The max over each group of ``groups`` consecutive channels (a tie's
    gradient split evenly, as jnp.max)."""
    x = _x(ins)
    g = attrs["groups"]
    n, c, h, w = x.shape
    return {"Out": [torch.amax(x.reshape(n, c // g, g, h, w), dim=2)]}


@register_op("prelu", diff_inputs=("X", "Alpha"))
def _prelu(ins, attrs, device):
    """x where x > 0, else alpha * x; alpha one value (``all``), one a
    channel (``channel``) or one an element of a sample (``element``)."""
    x, alpha = _x(ins), _x(ins, "Alpha")
    mode = attrs.get("mode", "all")
    if mode == "channel":
        shape = [1] * x.dim()
        shape[1] = -1
        alpha = alpha.reshape(shape)
    elif mode == "element":
        alpha = alpha.reshape((1,) + tuple(x.shape[1:]))
    else:
        alpha = alpha.reshape(())
    return {"Out": [torch.where(x > 0, x, alpha * x)]}


@register_op("group_norm", diff_inputs=("X", "Scale", "Bias"))
def _group_norm(ins, attrs, device):
    """Normalize NCHW X over each group of channels with its spatial
    cells; statistics and the affine in f32 (f64 for f64), Y in X's
    dtype; Mean / Variance [N, groups]."""
    x = _x(ins)
    scale, bias = _x(ins, "Scale"), _x(ins, "Bias")
    g = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    spatial = tuple(x.shape[2:])
    xg = x.to(_stat_dtype(x.dtype)).reshape((n, g, c // g) + spatial)
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = (xg - mean).square().mean(dim=axes, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    pshape = [1, c] + [1] * len(spatial)
    if scale is not None:
        y = y * scale.reshape(pshape).to(y.dtype)
    if bias is not None:
        y = y + bias.reshape(pshape).to(y.dtype)
    return {"Y": [y.to(x.dtype)], "Mean": [mean.reshape(n, g).detach()],
            "Variance": [var.reshape(n, g).detach()]}


@register_op("sync_batch_norm", diff_inputs=("X", "Scale", "Bias"))
def _sync_batch_norm(ins, attrs, device):
    """batch_norm over the whole batch: on one device the same op (the
    JAX package's too; across devices its mean is GSPMD's)."""
    return _batch_norm(ins, attrs, device)


@register_op("norm", diff_inputs=("X",))
def _norm(ins, attrs, device):
    """x / sqrt(sum(x^2 along axis) + epsilon); Norm the divisor."""
    x = _x(ins)
    n = torch.sqrt((x * x).sum(dim=attrs.get("axis", 1), keepdim=True)
                   + attrs.get("epsilon", 1e-10))
    return {"Out": [x / n], "Norm": [n]}


@register_op("affine_channel", diff_inputs=("X", "Scale", "Bias"))
def _affine_channel(ins, attrs, device):
    """x * scale + bias per channel (NCHW: dim 1; NHWC: the last)."""
    x = _x(ins)
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]
    return {"Out": [x * _x(ins, "Scale").reshape(shape)
                    + _x(ins, "Bias").reshape(shape)]}


def _interp_out_size(attrs, h, w):
    """(out_h, out_w): a positive ``scale`` wins over out_h / out_w (the
    reference's precedence); a missing size keeps the input's."""
    scale = attrs.get("scale", 0.0)
    if scale and scale > 0:
        return int(h * scale), int(w * scale)
    out_h = int(attrs.get("out_h", 0) or 0)
    out_w = int(attrs.get("out_w", 0) or 0)
    return (out_h if out_h > 0 else int(h), out_w if out_w > 0 else int(w))


def _aligned(n_in, n_out, device):
    """``jnp.linspace(0, n_in - 1, n_out)`` in f64: i * delta, the last
    exactly n_in - 1."""
    i = torch.arange(n_out, dtype=torch.float64, device=device)
    out = i * ((n_in - 1.0) / (n_out - 1))
    out[-1:].fill_(n_in - 1.0)
    return out


def _bilinear_src(n_in, n_out, align, mode, device):
    """Source coordinates of the output rows (or columns), in f64."""
    if align and n_out > 1:
        return _aligned(n_in, n_out, device)
    i = torch.arange(n_out, dtype=torch.float64, device=device)
    if mode == 1:
        return i * (n_in / n_out)
    return (i + 0.5) * n_in / n_out - 0.5


@register_op("bilinear_interp", diff_inputs=("X",))
def _bilinear_interp(ins, attrs, device):
    """NCHW bilinear resize with the JAX op's sampling: ``align_corners``
    (default True) maps the corners onto each other; otherwise
    ``align_mode`` 1 samples src = i * in / out, 0 the half-pixel
    centers. Coordinates and weights in f64, the blend in f32 (f64 for
    f64), Out in X's dtype."""
    x = _x(ins)
    n, c, h, w = x.shape
    out_h, out_w = _interp_out_size(attrs, h, w)
    align = attrs.get("align_corners", True)
    mode = int(attrs.get("align_mode", 1))
    ys = torch.clamp(_bilinear_src(h, out_h, align, mode, x.device), 0, h - 1)
    xs = torch.clamp(_bilinear_src(w, out_w, align, mode, x.device), 0, w - 1)
    y0, x0 = torch.floor(ys).to(torch.int64), torch.floor(xs).to(torch.int64)
    y1, x1 = torch.clamp_max(y0 + 1, h - 1), torch.clamp_max(x0 + 1, w - 1)
    dt = _stat_dtype(x.dtype)
    wy = (ys - y0).to(dt)[None, None, :, None]
    wx = (xs - x0).to(dt)[None, None, None, :]
    xf = x.to(dt)

    def g(yy, xx):
        return xf[:, :, yy, :][:, :, :, xx]

    out = (g(y0, x0) * (1 - wy) * (1 - wx) + g(y1, x0) * wy * (1 - wx)
           + g(y0, x1) * (1 - wy) * wx + g(y1, x1) * wy * wx)
    return {"Out": [out.to(x.dtype)]}


def _nearest_src(n_in, n_out, align, device):
    if align and n_out > 1:
        return torch.round(_aligned(n_in, n_out, device)).to(torch.int64)
    i = torch.arange(n_out, dtype=torch.float64, device=device)
    return torch.floor(i * n_in / n_out).to(torch.int64)


@register_op("nearest_interp", diff_inputs=("X",))
def _nearest_interp(ins, attrs, device):
    """NCHW nearest resize: ``align_corners`` (per axis, where that axis
    has more than one output) rounds the aligned coordinate half to even,
    else floor(i * in / out)."""
    x = _x(ins)
    n, c, h, w = x.shape
    out_h, out_w = _interp_out_size(attrs, h, w)
    align = attrs.get("align_corners", True)
    ys = _nearest_src(h, out_h, align, x.device)
    xs = _nearest_src(w, out_w, align, x.device)
    return {"Out": [x[:, :, ys, :][:, :, :, xs]]}


@register_op("row_conv", diff_inputs=("X", "Filter"))
def _row_conv(ins, attrs, device):
    """Lookahead convolution over time: out[t] = sum_i x[t + i] * f[i]
    (X [B, T, D], Filter [k, D], the tail zero-padded)."""
    x, f = _x(ins), _x(ins, "Filter")
    k, t = f.shape[0], x.shape[1]
    xp = F.pad(x, [0, 0, 0, k - 1])
    out = xp[:, 0:t, :] * f[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + t, :] * f[i][None, None, :]
    return {"Out": [out]}


@register_op("temporal_shift", diff_inputs=("X",))
def _temporal_shift(ins, attrs, device):
    """X [N * T, C, H, W]: the first ``shift_ratio`` of the channels take
    the next segment's values, the second the previous one's (zeros at
    the ends), the rest stay."""
    x = _x(ins)
    seg = int(attrs.get("seg_num", 1))
    ratio = attrs.get("shift_ratio", 0.25)
    nt, c, h, w = x.shape
    x5 = x.reshape(nt // seg, seg, c, h, w)
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    fwd = F.pad(x5[:, 1:, :c1], [0, 0, 0, 0, 0, 0, 0, 1])
    bwd = F.pad(x5[:, :-1, c1:c2], [0, 0, 0, 0, 0, 0, 1, 0])
    out = torch.cat([fwd, bwd, x5[:, :, c2:]], dim=2)
    return {"Out": [out.reshape(nt, c, h, w)]}


@register_op("grid_sampler", diff_inputs=("X", "Grid"))
def _grid_sampler(ins, attrs, device):
    """Bilinear samples of X [N, C, H, W] at Grid [N, Ho, Wo, 2]
    (normalized to [-1, 1], corners aligned); a corner outside the image
    contributes zero. Output [N, C, Ho, Wo]."""
    x, grid = _x(ins), _x(ins, "Grid")
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0, y0 = torch.floor(gx).to(torch.int64), torch.floor(gy).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1
    bidx = torch.arange(n, device=x.device)[:, None, None]

    def sample(yy, xx):
        inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        vals = x[bidx, :, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return vals * inb[..., None].to(vals.dtype)

    wx, wy = gx - x0, gy - y0
    out = (sample(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
           + sample(y1, x0) * (wy * (1 - wx))[..., None]
           + sample(y0, x1) * ((1 - wy) * wx)[..., None]
           + sample(y1, x1) * (wy * wx)[..., None])
    return {"Output": [out.permute(0, 3, 1, 2).to(x.dtype)]}


@register_op("auc", no_grad=True)
def _auc(ins, attrs, device):
    """ROC AUC of the batch by ``num_thresholds`` buckets of the positive
    class's probability, integrated by trapezoids from the highest
    threshold down (a batch-local metric: the JAX op keeps no
    accumulator; streaming lives in metrics.Auc)."""
    pred, label = _x(ins, "Predict"), _x(ins, "Label")
    if label.dim() > 1:
        label = label.squeeze(-1)
    buckets = int(attrs.get("num_thresholds", 200))
    idx = torch.clamp((pred[:, -1] * buckets).to(torch.int64), 0,
                      buckets - 1)
    lab = label.to(torch.float32)
    tp = torch.cumsum(torch.flip(_count_add(buckets, idx, lab), (0,)), 0)
    fp = torch.cumsum(torch.flip(_count_add(buckets, idx, 1.0 - lab), (0,)),
                      0)
    zero = tp.new_zeros(1)
    tpr = torch.cat([zero, tp / torch.clamp_min(tp[-1], 1e-12)])
    fpr = torch.cat([zero, fp / torch.clamp_min(fp[-1], 1e-12)])
    auc = ((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0).sum()
    return {"AUC": [auc]}


@register_op("bilinear_tensor_product",
             diff_inputs=("X", "Y", "Weight", "Bias"))
def _bilinear_tensor_product(ins, attrs, device):
    """out[b, k] = x[b] W[k] y[b] + bias[k]."""
    out = torch.einsum("bi,kij,bj->bk", _x(ins), _x(ins, "Weight"),
                       _x(ins, "Y"))
    bias = _x(ins, "Bias")
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return {"Out": [out]}


@register_op("nce", diff_inputs=("Input", "Weight", "Bias"), needs_rng=True)
def _nce(ins, attrs, device, seed=None):
    """Noise-contrastive estimation with uniform noise (nce_op.cc): each
    example scores its label and ``num_neg_samples`` classes drawn on the
    device from the op seed (``rng.op_randint(seed, (B, K), C)``: the CPU
    and the card draw the same classes, and a captured step draws afresh
    at each replay); logits less log(K / C), Cost [B, 1] = -(log
    sigmoid(pos) + sum log sigmoid(-neg)). The rows of Weight / Bias are
    read by indexing, whose backward accumulates after a sort (the same
    bits each run)."""
    x = ins["Input"][0]
    label = ins["Label"][0]
    if label.dim() > 1:
        label = label.squeeze(-1)
    w, bias = ins["Weight"][0], _x(ins, "Bias")
    c, k, b = w.shape[0], int(attrs.get("num_neg_samples", 10)), x.shape[0]
    neg = rng.op_randint(0 if seed is None else seed, (b, k), c, x.device)
    ids = torch.cat([label.to(torch.int64)[:, None], neg], dim=1)
    logits = torch.einsum("bd,bkd->bk", x, w[ids])
    if bias is not None:
        logits = logits + bias[ids]
    log_q = math.log(k) - math.log(c)
    adj = logits - torch.full((), log_q, dtype=logits.dtype,
                              device=logits.device)
    cost = -(F.logsigmoid(adj[:, 0]) + F.logsigmoid(-adj[:, 1:]).sum(dim=1))
    return {"Cost": [cost[:, None]]}


@register_op("hierarchical_sigmoid", diff_inputs=("X", "W", "Bias"))
def _hierarchical_sigmoid(ins, attrs, device):
    """Binary-tree sigmoid over the default complete tree (hsigmoid_op.cc
    SimpleCode): a label's code is label + C, its path the code's bit
    prefixes (node = prefix - 1, root first), the direction the next bit.
    The path length is the code's integer bit length (f32 log2 breaks
    from C ~ 2^20). All C.bit_length() steps at once: nodes [b, L], W's
    rows read by indexing; Out [b, 1] the summed per-node logistic
    losses, PreOut [b, L] the pre-activations (0 past a path's end)."""
    x, w = _x(ins), _x(ins, "W")
    label, bias = _x(ins, "Label"), _x(ins, "Bias")
    num_classes = int(attrs["num_classes"])
    code = label.reshape(-1).to(torch.int64) + num_classes
    powers = torch.ones(31, dtype=torch.int64, device=x.device) << \
        torch.arange(31, device=x.device)
    path_len = (code[:, None] >= powers[None, :]).sum(dim=1) - 1
    steps = torch.arange(num_classes.bit_length(), device=x.device)
    shift = path_len[:, None] - 1 - steps[None, :]          # [b, L]
    active = shift >= 0
    safe = torch.clamp_min(shift, 0)
    node = torch.clamp((code[:, None] >> (safe + 1)) - 1, 0, num_classes - 2)
    bit = ((code[:, None] >> safe) & 1).to(x.dtype)
    pre = (w[node] * x[:, None, :]).sum(dim=-1)
    if bias is not None:
        pre = pre + bias.reshape(-1)[node]
    mask = active.to(x.dtype)
    loss = (torch.logaddexp(pre, torch.zeros_like(pre)) - bit * pre) * mask
    return {"Out": [loss.sum(dim=1, keepdim=True)], "PreOut": [pre * mask]}


@register_op("sample_logits", needs_rng=True, diff_inputs=("Logits",))
def _sample_logits(ins, attrs, device, seed=None):
    """Sampled softmax's slice (sample_logits_op.cc): each row's T true
    labels, then ``num_samples`` classes drawn on the device from the op
    seed (``rng.op_randint(seed, (b, S), C)``), their logits less
    log(S / C); with ``remove_accidental_hits`` a sample equal to one of
    the row's labels gets -1e20. Samples int64 [b, T + S],
    Probabilities, SampledLogits, SampledLabel = 0..T-1 a row."""
    logits, labels = _x(ins, "Logits"), _x(ins, "Labels")
    s = int(attrs["num_samples"])
    b, c = logits.shape
    t = labels.shape[1]
    labels = labels.to(torch.int64)
    sampled = rng.op_randint(0 if seed is None else seed, (b, s), c,
                             logits.device)
    samples = torch.cat([labels, sampled], dim=1)
    q = torch.full((b, t + s), float(s) / c, dtype=logits.dtype,
                   device=logits.device)
    rows = torch.arange(b, device=logits.device)[:, None]
    adjusted = logits[rows, samples] - torch.log(q)
    if attrs.get("remove_accidental_hits", True):
        hit = (samples[:, None, t:] == labels[:, :, None]).any(dim=1)
        neg = torch.full((), -1e20, dtype=adjusted.dtype,
                         device=adjusted.device)
        adjusted = torch.cat([adjusted[:, :t],
                              torch.where(hit, neg, adjusted[:, t:])], dim=1)
    sampled_label = torch.arange(t, device=logits.device)[None].repeat(b, 1)
    return {"Samples": [samples], "Probabilities": [q],
            "SampledLogits": [adjusted], "SampledLabel": [sampled_label]}


@register_op("fc", diff_inputs=("Input", "W", "Bias"))
def _fc_fused(ins, attrs, device):
    """The fused fully connected op (fc_op.cc; the fc_fuse pass's target):
    Input flattened at ``in_num_col_dims`` times W, plus Bias on the
    columns."""
    x, w, b = ins["Input"][0], ins["W"][0], _x(ins, "Bias")
    xnc = int(attrs.get("in_num_col_dims", 1))
    out = torch.matmul(x.reshape(math.prod(x.shape[:xnc]), -1), w)
    if b is not None:
        out = out + b.reshape(1, -1)
    return {"Out": [out.reshape(tuple(x.shape[:xnc]) + tuple(w.shape[1:]))]}
