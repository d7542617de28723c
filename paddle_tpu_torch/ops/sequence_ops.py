"""Sequence ops over padded batches.

The reference's ``sequence_*`` ops read LoD tensors (ragged rows,
operators/sequence_ops/*). The JAX package lays a batch of sequences out
as a padded dense ``[B, T, ...]`` tensor plus an int ``Length`` ``[B]``
(or ``[B, 1]``) (``paddle_tpu/ops/sequence_ops.py``), and so does the
port: each op here is that op's arithmetic in plain PyTorch, static
shapes throughout, no host read of a length (a captured step may hold
every one of them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.framework import torch_dtype


def _x(ins, slot="X", i=0):
    v = ins.get(slot)
    return v[i] if v else None


def _squeezed(length):
    return length.squeeze(-1) if length.dim() > 1 else length


def _mask_from(ins, x):
    """[B, T] f32 mask from the Length input, or all ones."""
    length = _x(ins, "Length")
    if length is None:
        return torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    length = _squeezed(length)
    t = x.shape[1]
    return (torch.arange(t, device=x.device)[None, :]
            < length[:, None]).to(torch.float32)


def _trailing(m, x):
    """``m`` [B, T] reshaped to broadcast over x's trailing dims."""
    return m.reshape(tuple(m.shape) + (1,) * (x.dim() - 2))


def _take_steps(x, idx):
    """x[b, idx[b, s], ...] for idx [B, S]: the padded-time gather of
    ``jnp.take_along_axis(x, idx[..., None...], axis=1)``."""
    idx = _trailing(idx.to(torch.int64), x).expand(
        (idx.shape[0], idx.shape[1]) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)


@register_op("sequence_mask", no_grad=True)
def _sequence_mask(ins, attrs, device):
    """Y[b, s] = s < X[b], for s < maxlen, in ``out_dtype``. A static
    ``maxlen`` is required, as in the JAX op (shapes are static)."""
    length = _x(ins)
    maxlen = attrs.get("maxlen", -1)
    if maxlen < 0:
        raise ValueError(
            "sequence_mask needs a static maxlen (blocks run at static "
            "shapes); pass maxlen= explicitly")
    mask = torch.arange(maxlen, device=length.device)[None, :] \
        < length[:, None]
    return {"Y": [mask.to(torch_dtype(attrs.get("out_dtype", "float32")))]}


@register_op("sequence_pool", diff_inputs=("X",))
def _sequence_pool(ins, attrs, device):
    """Pool [B, T, D] over each row's live steps: AVERAGE / SQRT divide by
    max(count, 1); MAX fills padding with the dtype's lowest value and
    splits a tie's gradient evenly (``torch.amax``, as ``jnp.max``; a row
    of length 0 ties everywhere); LAST reads step max(len - 1, 0)."""
    x = _x(ins)
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    mask = _mask_from(ins, x)[..., None].to(x.dtype)
    if ptype in ("AVERAGE", "AVG", "SQRT"):
        s = torch.sum(x * mask, dim=1)
        n = torch.clamp_min(torch.sum(mask, dim=1), 1.0)
        out = s / n if ptype != "SQRT" else s / torch.sqrt(n)
    elif ptype == "SUM":
        out = torch.sum(x * mask, dim=1)
    elif ptype == "MAX":
        out = torch.amax(torch.where(mask > 0, x, torch.finfo(x.dtype).min),
                         dim=1)
    elif ptype == "LAST":
        length = _x(ins, "Length")
        if length is None:
            out = x[:, -1]
        else:
            idx = torch.clamp_min(_squeezed(length) - 1, 0)
            out = _take_steps(x, idx[:, None])[:, 0]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    return {"Out": [out]}


@register_op("sequence_softmax", diff_inputs=("X",))
def _sequence_softmax(ins, attrs, device):
    """Softmax over each row's live steps of X [B, T]; zero on padding."""
    x = _x(ins)
    mask = _mask_from(ins, x)
    z = torch.where(mask > 0, x, torch.finfo(x.dtype).min)
    return {"Out": [torch.softmax(z, dim=-1) * mask.to(x.dtype)]}


@register_op("sequence_reverse", diff_inputs=("X",))
def _sequence_reverse(ins, attrs, device):
    """Each row's live steps reversed in place; padding stays put."""
    x = _x(ins)
    length = _x(ins, "Length")
    if length is None:
        return {"Y": [torch.flip(x, dims=(1,))]}
    length = _squeezed(length)
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    rev = torch.where(idx < length[:, None], length[:, None] - 1 - idx, idx)
    return {"Y": [_take_steps(x, rev)]}


@register_op("sequence_expand", diff_inputs=("X",))
def _sequence_expand(ins, attrs, device):
    """X [B, D] broadcast over Y's T steps: [B, T, D]."""
    x, y = _x(ins), _x(ins, "Y")
    return {"Out": [x[:, None, :].expand(x.shape[0], y.shape[1],
                                         x.shape[1])]}


@register_op("im2sequence", diff_inputs=("X",))
def _im2sequence(ins, attrs, device):
    """[N, C, H, W] -> [N, OH * OW, C * kh * kw]: each VALID patch a step,
    its features channel-major (``conv_general_dilated_patches``' order)."""
    x = _x(ins)
    cols = F.unfold(x, kernel_size=tuple(attrs.get("kernels", [1, 1])),
                    stride=tuple(attrs.get("strides", [1, 1])))
    return {"Out": [cols.transpose(1, 2)]}


@register_op("sequence_pad", diff_inputs=("X",))
def _sequence_pad(ins, attrs, device):
    """Steps past Length set to PadValue (a scalar, a one-element tensor
    or a step-shaped one); OutLength is Length (T without one), int64."""
    x = _x(ins)
    pad = _x(ins, "PadValue")
    if pad is None:
        pad = torch.zeros((), dtype=x.dtype, device=x.device)
    m = _trailing(_mask_from(ins, x), x).to(x.dtype)
    if pad.dim() and pad.numel() == 1:
        pad = pad.reshape(())
    if pad.dim():
        pad = pad.expand(x.shape[2:])
    out = x * m + pad.to(x.dtype) * (1 - m)
    length = _x(ins, "Length")
    if length is None:
        length = torch.full((x.shape[0],), x.shape[1], dtype=torch.int64,
                            device=x.device)
    return {"Out": [out], "OutLength": [length.to(torch.int64)]}


@register_op("sequence_unpad", diff_inputs=("X",))
def _sequence_unpad(ins, attrs, device):
    """Steps past Length zeroed; the output stays padded (static shapes)."""
    x = _x(ins)
    return {"Out": [x * _trailing(_mask_from(ins, x), x).to(x.dtype)]}


@register_op("sequence_concat", diff_inputs=("X",))
def _sequence_concat(ins, attrs, device):
    """Each row's live prefixes concatenated: X (several) [B, Ti, ...] with
    aligned Lengths -> Out [B, sum(Ti), ...], OutLength [B]. Padding steps
    land in a spare column that is dropped."""
    xs = ins["X"]
    lengths = ins.get("Length", [])
    b, feat = xs[0].shape[0], tuple(xs[0].shape[2:])
    dev = xs[0].device
    t_tot = sum(x.shape[1] for x in xs)
    out = torch.zeros((b, t_tot + 1) + feat, dtype=xs[0].dtype, device=dev)
    offset = torch.zeros((b,), dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    for i, x in enumerate(xs):
        t = x.shape[1]
        ln = lengths[i] if i < len(lengths) and lengths[i] is not None \
            else torch.full((b,), t, dtype=torch.int64, device=dev)
        ln = _squeezed(ln).to(torch.int64)
        steps = torch.arange(t, device=dev)[None, :]
        pos = torch.where(steps < ln[:, None], offset[:, None] + steps,
                          t_tot)
        out = torch.index_put(out, (rows.expand(b, t), pos), x,
                              accumulate=True)
        offset = offset + ln
    return {"Out": [out[:, :t_tot]], "OutLength": [offset]}


@register_op("sequence_slice", diff_inputs=("X",))
def _sequence_slice(ins, attrs, device):
    """Each row's steps [Offset, Offset + Length), kept at the padded T
    with a zero tail; OutLength = Length (int64)."""
    x = _x(ins)
    off = _squeezed(_x(ins, "Offset"))
    ln = _squeezed(_x(ins, "Length"))
    t = x.shape[1]
    steps = torch.arange(t, device=x.device)[None, :]
    src = torch.clamp(off[:, None].to(torch.int64) + steps, 0, t - 1)
    live = _trailing(steps < ln[:, None], x)
    return {"Out": [_take_steps(x, src) * live.to(x.dtype)],
            "OutLength": [ln.to(torch.int64)]}


@register_op("sequence_erase", no_grad=True)
def _sequence_erase(ins, attrs, device):
    """The attr ``tokens``' values removed from each row of X [B, T] (int)
    and the rest moved left; OutLength the kept count."""
    x = _x(ins)
    b, t = x.shape
    hit = torch.zeros_like(x, dtype=torch.bool)
    for tok in attrs.get("tokens", []):
        hit = hit | (x == tok)
    keep = (_mask_from(ins, x) > 0) & ~hit
    new_pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    pos = torch.where(keep, new_pos.to(torch.int64), t)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, t)
    out = torch.zeros((b, t + 1), dtype=x.dtype, device=x.device)
    out = torch.index_put(out, (rows, pos), torch.where(keep, x, 0))
    return {"Out": [out[:, :t]],
            "OutLength": [keep.sum(dim=1).to(torch.int64)]}


@register_op("sequence_enumerate", no_grad=True)
def _sequence_enumerate(ins, attrs, device):
    """Sliding windows of ids: X [B, T] -> Out [B, T, win]; a window slot
    past the row's length or the array's end holds ``pad_value``."""
    x = _x(ins)
    win = int(attrs.get("win_size", 2))
    b, t = x.shape
    idx = (torch.arange(t, device=x.device)[:, None]
           + torch.arange(win, device=x.device)[None, :])      # [T, win]
    padded = F.pad(_mask_from(ins, x), (0, win))                # [B, T+win]
    flat = idx.reshape(1, -1)
    valid = (idx < t)[None] & (torch.gather(
        padded, 1, flat.clamp(0, t + win - 1).expand(b, -1)) > 0).reshape(
            b, t, win)
    vals = torch.gather(x, 1, flat.clamp(0, t - 1).expand(b, -1))
    return {"Out": [torch.where(valid, vals.reshape(b, t, win),
                                attrs.get("pad_value", 0))]}


@register_op("sequence_expand_as", diff_inputs=("X",))
def _sequence_expand_as(ins, attrs, device):
    """X [B, D] over Y's live steps (Y [B, T, ...]), zero on padding."""
    x, y = _x(ins), _x(ins, "Y")
    mask = _mask_from(ins, y)
    out = x[:, None, :].expand(x.shape[0], y.shape[1], x.shape[-1])
    return {"Out": [out * mask[:, :, None].to(out.dtype)]}


@register_op("sequence_conv", diff_inputs=("X", "Filter"))
def _sequence_conv(ins, attrs, device):
    """A context window of ``contextLength`` steps from ``contextStart``
    over [B, T, D], zero outside [0, T), times Filter [ctx_len * D, M]."""
    x, w = _x(ins), _x(ins, "Filter")
    ctx_len = int(attrs.get("contextLength", 3))
    ctx_start = int(attrs.get("contextStart", -(ctx_len // 2)))
    t = x.shape[1]
    steps = torch.arange(t, device=x.device)[None, :, None]
    cols = []
    for i in range(ctx_len):
        off = ctx_start + i
        shifted = torch.roll(x, -off, dims=1)
        if off < 0:
            cols.append(torch.where(steps >= -off, shifted, 0.0))
        elif off > 0:
            cols.append(torch.where(steps < t - off, shifted, 0.0))
        else:
            cols.append(shifted)
    return {"Out": [torch.matmul(torch.cat(cols, dim=-1), w)]}


@register_op("sequence_reshape", diff_inputs=("X",))
def _sequence_reshape(ins, attrs, device):
    """[B, T, D] -> [B, T * D / new_dim, new_dim]."""
    x = _x(ins)
    new_dim = int(attrs["new_dim"])
    b, t, d = x.shape
    return {"Out": [x.reshape(b, t * d // new_dim, new_dim)]}


@register_op("sequence_scatter", diff_inputs=("X", "Updates"))
def _sequence_scatter(ins, attrs, device):
    """X [B, D] plus Updates [B, K] at each row's Ids [B, K] (or
    [B, K, 1]); repeated ids add up."""
    x, ids, upd = _x(ins), _x(ins, "Ids"), _x(ins, "Updates")
    if ids.dim() == 3 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    rows = torch.arange(x.shape[0], device=x.device)[:, None].expand(
        ids.shape)
    return {"Out": [torch.index_put(x, (rows, ids.to(torch.int64)), upd,
                                    accumulate=True)]}


@register_op("add_position_encoding", diff_inputs=("X",))
def _add_position_encoding(ins, attrs, device):
    """alpha * x + beta * the sinusoid table (f32): sin at even features,
    cos at odd ones, angle pos / 10000^(2i / D)."""
    x = _x(ins)
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    _, t, d = x.shape
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=x.device)[None, :]
    angle = pos / torch.pow(10000.0, 2.0 * i / d)
    enc = torch.stack([torch.sin(angle), torch.cos(angle)], -1).reshape(t, d)
    return {"Out": [alpha * x + beta * enc[None].to(x.dtype)]}


@register_op("conv_shift", diff_inputs=("X", "Y"))
def _conv_shift(ins, attrs, device):
    """Circular convolution (operators/conv_shift_op.cc): X [B, N], Y
    [B, M], M odd and at most N."""
    x, y = _x(ins), _x(ins, "Y")
    half = y.shape[1] // 2
    out = 0
    for j in range(y.shape[1]):
        out = out + torch.roll(x, half - j, dims=1) * y[:, j:j + 1]
    return {"Out": [out]}
