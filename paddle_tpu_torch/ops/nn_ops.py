"""NN ops: normalization, dropout and losses."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op


def _x(ins, slot="X", i=0):
    v = ins.get(slot)
    return v[i] if v else None


def _stat_dtype(dtype):
    # f32 unless f64: statistics stay in at least f32 under bf16 streams
    return torch.float64 if dtype == torch.float64 else torch.float32


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
