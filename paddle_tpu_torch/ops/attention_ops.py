"""Attention support ops: position ids, additive attention bias, and
scaled-dot-product attention with its registered backward, in the BTHD
(``layout="bthd"``) and BHTD (``layout="bhtd"``) layouts
(parallel/flash_attention.py: the Hopper kernels on a CUDA tensor's
kernel routes, the plain PyTorch composition on the CPU and on the dense
route). Ring attention over a context mesh is not ported: the op has no
context-parallel branch.
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


@register_op("position_ids", no_grad=True)
def _position_ids(ins, attrs, device):
    x = _x(ins)  # [b, t] any int dtype
    b, t = x.shape[0], x.shape[1]
    return {"Out": [torch.arange(t, device=x.device).expand(b, t)]}


@register_op("attn_bias", no_grad=True)
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


def _sdpa_config(ins, attrs, seed):
    """Shared forward / grad config: (scale, p_drop, seed). The grad op's
    seed handle carries the forward's forward_op_idx (core/interp.py), so
    both see one op seed and the kernels one mask; the kernels read it
    from the device. Shape inference passes no seed (0 stands in)."""
    q = _x(ins, "Q")
    scale = attrs.get("scale", None)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p_drop = attrs.get("dropout_prob", 0.0)
    if p_drop > 0.0 and not attrs.get("is_test", False):
        return scale, float(p_drop), 0 if seed is None else seed
    return scale, 0.0, None


def _bthd_layout(attrs):
    layout = attrs.get("layout", "bhtd")
    if layout not in ("bthd", "bhtd"):
        raise ValueError(f"scaled_dot_product_attention: layout {layout!r}")
    return layout == "bthd"


@register_op("scaled_dot_product_attention", diff_inputs=("Q", "K", "V"),
             needs_rng=True)
def _sdpa(ins, attrs, device, seed=None):
    """Attention over Q, K, V ([b, t, h, dh] with ``layout="bthd"``, [b,
    h, t, dh] with ``layout="bhtd"``) with an optional additive Bias and,
    in training (``dropout_prob > 0`` and not ``is_test``), attention
    dropout inside the kernel from the op's seed handle; emits Out (Q's
    dtype) and the real f32 logsumexp rows Lse ([b, tq, h, 1] or [b, h,
    tq, 1]), which the grad op consumes."""
    q, k, v = _x(ins, "Q"), _x(ins, "K"), _x(ins, "V")
    scale, p_drop, seed = _sdpa_config(ins, attrs, seed)
    causal = bool(attrs.get("causal", False))
    if _bthd_layout(attrs):
        out, lse = fa.flash_attention_bthd_fwd(q, k, v, _x(ins, "Bias"),
                                               seed, scale, p_drop, causal)
    else:
        out, lse = fa.flash_attention_fwd(q, k, v, _x(ins, "Bias"), seed,
                                          scale, p_drop, causal=causal)
    return {"Out": [out], "Lse": [lse]}


@register_op("scaled_dot_product_attention_grad", no_grad=True,
             needs_rng=True)
def _sdpa_grad(ins, attrs, device, seed=None):
    """The attention backward from the forward's saved (Out, Lse): the
    backward kernel (or its plain version), never a re-run of the
    forward."""
    q, k, v = _x(ins, "Q"), _x(ins, "K"), _x(ins, "V")
    scale, p_drop, seed = _sdpa_config(ins, attrs, seed)
    args = (q, k, v, _x(ins, "Bias"), seed, _x(ins, "Out"), _x(ins, "Lse"),
            _x(ins, "GRAD::Out").to(q.dtype), scale, p_drop)
    causal = bool(attrs.get("causal", False))
    if _bthd_layout(attrs):
        dq, dk, dv = fa.flash_attention_bthd_bwd(*args, causal)
    else:
        dq, dk, dv = fa.flash_attention_bwd(*args, causal=causal)
    return {"GRAD::Q": [dq], "GRAD::K": [dk], "GRAD::V": [dv]}
