"""Attention support ops: position ids, additive attention bias, and the
forward of scaled-dot-product attention (parallel/flash_attention.py:
the Hopper kernel for the small regime on a CUDA tensor, the plain
PyTorch composition on the CPU and for single-token decode).
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.parallel import flash_attention as fa

NEG_INF = -1e9


def _x(ins, slot="X", i=0):
    v = ins.get(slot)
    return v[i] if v else None


@register_op("position_ids")
def _position_ids(ins, attrs, device):
    x = _x(ins)  # [b, t] any int dtype
    b, t = x.shape[0], x.shape[1]
    return {"Out": [torch.arange(t, device=x.device).expand(b, t)]}


@register_op("attn_bias")
def _attn_bias(ins, attrs, device):
    """PadMask [b, t_k] (1=real token) -> additive bias.

    causal=False: [b, 1, 1, t_k] with -1e9 at padding.
    causal=True:  [b, 1, t_k, t_k] padding + upper-triangular future mask.
    """
    mask = _x(ins, "PadMask")
    pad_bias = (1.0 - mask) * NEG_INF  # [b, t]
    if attrs.get("causal", False):
        t = mask.shape[1]
        causal = torch.triu(
            torch.full((t, t), NEG_INF, dtype=mask.dtype, device=mask.device),
            diagonal=1)
        return {"Out": [pad_bias[:, None, None, :] + causal[None, None]]}
    return {"Out": [pad_bias[:, None, None, :]]}


@register_op("scaled_dot_product_attention")
def _sdpa(ins, attrs, device):
    """Attention over Q, K, V [b, t, h, dh] (``layout="bthd"``) with an
    optional additive Bias; emits Out (Q's dtype) and the real f32
    logsumexp rows Lse [b, tq, h, 1].

    Training-time attention dropout (``dropout_prob > 0`` and not
    ``is_test``) raises: it comes with the kernel's in-kernel dropout in
    the training slice."""
    q, k, v = _x(ins, "Q"), _x(ins, "K"), _x(ins, "V")
    if attrs.get("layout", "bhtd") != "bthd":
        raise NotImplementedError(
            "scaled_dot_product_attention: only layout='bthd' is ported")
    if attrs.get("dropout_prob", 0.0) > 0.0 and not attrs.get("is_test", False):
        raise NotImplementedError(
            "scaled_dot_product_attention: training-time attention dropout "
            "is not ported (needs the kernel's in-kernel dropout)")
    scale = attrs.get("scale", None)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = fa.flash_attention_bthd_fwd(
        q, k, v, _x(ins, "Bias"), scale, bool(attrs.get("causal", False)))
    return {"Out": [out], "Lse": [lse]}
