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
