"""NN ops: convolution, pooling, normalization, dropout, losses and
metrics.

Convolutions are plain products that the JAX package leaves to XLA
(``lax.conv_general_dilated``); here they go to ``F.conv2d`` (cuDNN on
the card), as ``mul`` goes to ``torch.matmul``. The interface and the
memory layout are NCHW: laying the convolutions' operands out channels
last was measured on an H100 and gained nothing (cuDNN converts bf16
NCHW operands itself, and the per-channel reductions of ``batch_norm``
run slower over channels-last memory; PERF.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op


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


@register_op("dropout", needs_rng=True)
def _dropout(ins, attrs, device, generator=None):
    """Out = X with each element kept with probability 1 - p (Mask, uint8,
    says which); ``upscale_in_train`` scales kept elements by 1/(1 - p)
    in training, ``downgrade_in_infer`` scales by (1 - p) at test time.
    The mask comes from the op's generator (its bits differ from the JAX
    package's)."""
    x = _x(ins)
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        if impl == "upscale_in_train":
            return {"Out": [x], "Mask": []}
        return {"Out": [x * (1.0 - p)], "Mask": []}
    if p <= 0.0:
        return {"Out": [x], "Mask": []}
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= p
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if impl == "upscale_in_train":
        y = torch.where(keep, x / (1.0 - p), zero)
    else:
        y = torch.where(keep, x, zero)
    return {"Out": [y], "Mask": [keep.to(torch.uint8)]}


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
        keep = _x(ins, "Mask").to(torch.bool)
        gs = g / (1.0 - p) if impl == "upscale_in_train" else g
        dx = torch.where(keep, gs, torch.zeros((), dtype=g.dtype,
                                               device=g.device))
    return {"GRAD::X": [dx]}


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
