"""Quantization ops: the fake-quant family and the int8 convert ops.

The port of the JAX package's ``ops/quant_ops.py`` (and of
``fake_quantize_dequantize``, ``ops/math_ops.py`` there). The
training-time fake-quant ops keep the straight-through estimator in the
expression, ``x + (q - x).detach()``, so the derived grad op
(core/autodiff.py) gives identity gradients inside the clip range, as
``jax.lax.stop_gradient`` does there. The arithmetic keeps the JAX
order (``round(x / scale * qmax)``; ``torch.round`` and ``jnp.round``
both round half to even). A division by a constant divides by a 0-d
tensor of the input's dtype, as JAX's weakly typed constant does: the
card then divides too, where it would multiply by the reciprocal of a
Python scalar, so the card and the CPU agree bit for bit. ``quantize``
and ``requantize`` return ``torch.int8``.

The moving-average and range ops carry scale state (``InState`` /
``OutState``, ``InScales`` / ``OutScales``); where the program names the
same variable on both sides, the step writes the new value into it (the
JAX registry's ``inplace=`` marks the same pairs for buffer donation).

No hand-written kernel: on the TPU these are XLA-fused elementwise
expressions, not Pallas kernels.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op


def _x(ins, slot="X", i=0):
    v = ins.get(slot)
    return v[i] if v else None


def _qmax(attrs) -> float:
    bits = int(attrs.get("bit_length", attrs.get("bits", 8)))
    return float(2 ** (bits - 1) - 1)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _ste(x, scale, qmax):
    q = _div(torch.clamp(torch.round(x / scale * qmax), -qmax, qmax) * scale,
             qmax)
    return x + (q - x).detach()


def _abs_max(x):
    return torch.clamp(torch.max(torch.abs(x)), min=1e-8)


@register_op("fake_quantize_abs_max", diff_inputs=("X",))
def _fake_quantize_abs_max(ins, attrs, device):
    x = _x(ins)
    scale = _abs_max(x)
    return {"Out": [_ste(x, scale, _qmax(attrs))],
            "OutScale": [scale.reshape(1)]}


@register_op("fake_channel_wise_quantize_abs_max", diff_inputs=("X",))
def _fake_channel_wise_quantize_abs_max(ins, attrs, device):
    """Per-output-channel scales (dim 0, the conv-filter convention)."""
    x = _x(ins)
    flat = torch.abs(x).reshape(x.shape[0], -1)
    scale = torch.clamp(torch.amax(flat, dim=1), min=1e-8)
    s = scale.reshape((-1,) + (1,) * (x.dim() - 1))
    return {"Out": [_ste(x, s, _qmax(attrs))], "OutScale": [scale]}


@register_op("fake_quantize_range_abs_max", diff_inputs=("X",))
def _fake_quantize_range_abs_max(ins, attrs, device):
    """Sliding max over a window of per-step scales: InScales is the
    rolling history, Iter the step counter."""
    x, hist, it = _x(ins), _x(ins, "InScales"), _x(ins, "Iter")
    qmax = _qmax(attrs)
    if attrs.get("is_test", False):
        scale = _abs_max(hist)
        return {"Out": [_ste(x, scale, qmax)],
                "OutScale": [scale.reshape(1)],
                "OutScales": [hist], "IterOut": [it]}
    cur = _abs_max(x)
    pos = (it.reshape(1).to(torch.int32) % hist.shape[0]).long()
    hist = hist.index_copy(0, pos, cur.reshape(1).to(hist.dtype))
    scale = _abs_max(hist)
    return {"Out": [_ste(x, scale, qmax)], "OutScale": [scale.reshape(1)],
            "OutScales": [hist], "IterOut": [it + 1]}


def _moving_average(x, state, accum, rate):
    state_n = rate * state.reshape(()) + 1.0
    accum_n = rate * accum.reshape(()) + torch.max(torch.abs(x))
    return state_n, accum_n, torch.clamp(accum_n / state_n, min=1e-8)


@register_op("fake_quantize_moving_average_abs_max", diff_inputs=("X",))
def _fake_quantize_moving_average_abs_max(ins, attrs, device):
    """An EMA of abs-max (reference: fake_quantize_op.cc moving_average)."""
    x, state, accum = _x(ins), _x(ins, "InState"), _x(ins, "InAccum")
    qmax = _qmax(attrs)
    if attrs.get("is_test", False):
        scale = torch.clamp(accum.reshape(()) / state.reshape(()), min=1e-8)
        return {"Out": [_ste(x, scale, qmax)],
                "OutScale": [scale.reshape(1)],
                "OutState": [state], "OutAccum": [accum]}
    state_n, accum_n, scale = _moving_average(
        x, state, accum, float(attrs.get("moving_rate", 0.9)))
    return {"Out": [_ste(x, scale, qmax)], "OutScale": [scale.reshape(1)],
            "OutState": [state_n.reshape(1)],
            "OutAccum": [accum_n.reshape(1)]}


@register_op("moving_average_abs_max_scale", diff_inputs=("X",))
def _moving_average_abs_max_scale(ins, attrs, device):
    """The scale observer alone: X passes through untouched."""
    x, state, accum = _x(ins), _x(ins, "InState"), _x(ins, "InAccum")
    state_n, accum_n, scale = _moving_average(
        x, state, accum, float(attrs.get("moving_rate", 0.9)))
    return {"Out": [x], "OutScale": [scale.reshape(1)],
            "OutState": [state_n.reshape(1)],
            "OutAccum": [accum_n.reshape(1)]}


@register_op("fake_dequantize_max_abs", diff_inputs=("X",))
def _fake_dequantize_max_abs(ins, attrs, device):
    x, scale = _x(ins), _x(ins, "Scale")
    qmax = float(attrs.get("max_range", _qmax(attrs)))
    return {"Out": [_div(x.to(torch.float32) * scale.reshape(()), qmax)]}


@register_op("fake_channel_wise_dequantize_max_abs", diff_inputs=("X",))
def _fake_channel_wise_dequantize_max_abs(ins, attrs, device):
    x = _x(ins)
    scales = ins.get("Scales", [])
    qmax = _qmax(attrs)
    out = _div(x.to(torch.float32)
               * scales[0].reshape((-1,) + (1,) * (x.dim() - 1)), qmax)
    if len(scales) > 1 and scales[1] is not None:
        out = _div(out * scales[1].reshape(()), qmax)
    return {"Out": [out]}


@register_op("quantize", no_grad=True)
def _quantize(ins, attrs, device):
    """f32 -> int8 with a given scale (reference: quantize_op.cc)."""
    x = _x(ins, "Input")
    scale = float(attrs.get("Scale", 1.0))
    q = torch.clamp(torch.round(x * scale), -128, 127).to(torch.int8)
    return {"Output": [q]}


@register_op("dequantize", no_grad=True)
def _dequantize(ins, attrs, device):
    x = _x(ins, "Input")
    return {"Output": [_div(x.to(torch.float32),
                            float(attrs.get("Scale", 1.0)))]}


@register_op("requantize", no_grad=True)
def _requantize(ins, attrs, device):
    x = _x(ins, "Input")
    scale_in = float(attrs.get("Scale_in", 1.0))
    scale_out = float(attrs.get("Scale_out", 1.0))
    q = torch.round(_div(x.to(torch.float32) * scale_out, scale_in))
    return {"Output": [torch.clamp(q, -128, 127).to(torch.int8)]}


@register_op("fake_quantize_dequantize_moving_average_abs_max",
             diff_inputs=("X",))
def _fake_qdq_moving_average_abs_max(ins, attrs, device):
    """Quantize-dequantize with a moving-average scale in one op: the
    moving-average quantize op already gives the dequantized STE value;
    Out keeps X's dtype."""
    outs = _fake_quantize_moving_average_abs_max(ins, attrs, device)
    outs["Out"] = [outs["Out"][0].to(_x(ins).dtype)]
    return outs


@register_op("quantize_dequantize_static", no_grad=True)
def _quantize_dequantize_static(ins, attrs, device):
    """Static-scale symmetric quantize-dequantize: the inference form of
    the fake-quant family, the scale a constant that calibration baked
    into the attrs (reference: quantization_pass.py:541
    QuantizationFreezePass)."""
    x = _x(ins)
    qmax = _qmax(attrs)
    scale = float(attrs.get("scale", 1.0)) or 1.0
    q = torch.clamp(torch.round(_div(x, scale) * qmax), -qmax, qmax)
    return {"Out": [q * (scale / qmax)]}


@register_op("fake_quantize_dequantize", diff_inputs=("X",))
def _fake_quantize_dequantize(ins, attrs, device):
    """Simulated symmetric quantization at a dynamic abs-max scale, with
    the straight-through estimator (the op the QAT pass inserts)."""
    x = ins["X"][0]
    qmax = float(2 ** (int(attrs.get("bits", 8)) - 1) - 1)
    return {"Out": [_ste(x, _abs_max(x), qmax)]}
