"""Tensor creation & manipulation ops.

Random fills draw from the host-seeded ``torch.Generator`` the
interpreter hands them (seeded per op from the run's step seed, see
core/interp.py), so a seeded run is reproducible on one device; they are
``host_rng`` ops, and a block that holds one (a startup program) runs
eagerly, never as a CUDA graph. The streams differ from the JAX
package's PRNG: weights carry across by name (io.scope_from_numpy), never
by re-drawing them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.core.registry import get_op_def, register_op
from paddle_tpu_torch.framework import torch_dtype
from paddle_tpu_torch.ops.box_util import iou_xyxy


def _x(ins, slot="X", i=0):
    return ins[slot][i]


@register_op("fill_constant", no_grad=True)
def _fill_constant(ins, attrs, device):
    shape = tuple(attrs.get("shape", []))
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(shape, attrs.get("value", 0.0), dtype=dtype,
                               device=device)]}


@register_op("fill_constant_batch_size_like", no_grad=True)
def _fill_constant_batch_size_like(ins, attrs, device):
    """``fill_constant`` whose dim ``output_dim_idx`` is Input's dim
    ``input_dim_idx`` (a memory's batch, layers/control_flow.py)."""
    ref = _x(ins, "Input")
    shape = list(attrs["shape"])
    shape[int(attrs.get("output_dim_idx", 0))] = ref.shape[
        int(attrs.get("input_dim_idx", 0))]
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(tuple(shape), attrs.get("value", 0.0),
                               dtype=dtype, device=ref.device)]}


@register_op("fill_zeros_like", no_grad=True)
def _fill_zeros_like(ins, attrs, device):
    return {"Out": [torch.zeros_like(_x(ins))]}


@register_op("fill_any_like", no_grad=True)
def _fill_any_like(ins, attrs, device):
    return {"Out": [torch.full_like(_x(ins), attrs.get("value", 0.0))]}


@register_op("gaussian_random", no_grad=True, host_rng=True)
def _gaussian_random(ins, attrs, device, generator=None):
    shape = tuple(attrs["shape"])
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    out = torch.empty(shape, dtype=dtype, device=device).normal_(
        attrs.get("mean", 0.0), attrs.get("std", 1.0), generator=generator)
    return {"Out": [out]}


@register_op("uniform_random", no_grad=True, host_rng=True)
def _uniform_random(ins, attrs, device, generator=None):
    shape = tuple(attrs["shape"])
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    out = torch.empty(shape, dtype=dtype, device=device).uniform_(
        attrs.get("min", -1.0), attrs.get("max", 1.0), generator=generator)
    return {"Out": [out]}


@register_op("assign")
def _assign(ins, attrs, device):
    return {"Out": [_x(ins)]}


@register_op("assign_value", no_grad=True)
def _assign_value(ins, attrs, device):
    shape = tuple(attrs["shape"])
    vals = np.asarray(attrs["values"], dtype=np.float64).reshape(shape)
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.from_numpy(vals).to(device=device, dtype=dtype)]}


@register_op("reshape2")
def _reshape2(ins, attrs, device):
    x = _x(ins)
    # Fluid semantics: 0 copies the input dim, -1 infers (reshape_op.cc).
    shape = [x.shape[i] if d == 0 else d for i, d in enumerate(attrs["shape"])]
    return {"Out": [x.reshape(shape)], "XShape": []}


@register_op("flatten2")
def _flatten2(ins, attrs, device):
    """[prod(dims before axis), prod(the rest)]; axis 0 gives [1, n]."""
    x = _x(ins)
    axis = attrs.get("axis", 1)
    lead = math.prod(x.shape[:axis]) if axis else 1
    return {"Out": [x.reshape(lead, -1)], "XShape": []}


@register_op("concat")
def _concat(ins, attrs, device):
    return {"Out": [torch.cat(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("split")
def _split(ins, attrs, device):
    x = _x(ins)
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    num = attrs.get("num", 0)
    if x.shape[axis] % num:
        raise ValueError(
            f"split: dim {axis} of size {x.shape[axis]} is not divisible "
            f"into {num} equal parts")
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}


@register_op("unsqueeze2")
def _unsqueeze2(ins, attrs, device):
    x = _x(ins)
    for ax in sorted(attrs["axes"]):
        x = x.unsqueeze(ax)
    return {"Out": [x], "XShape": []}


@register_op("scatter", diff_inputs=("X", "Updates"))
def _scatter(ins, attrs, device):
    x, ids, updates = _x(ins), _x(ins, "Ids"), _x(ins, "Updates")
    out = x.clone()
    if attrs.get("overwrite", True):
        out[ids] = updates.to(x.dtype)
    else:
        out.index_add_(0, ids, updates.to(x.dtype))
    return {"Out": [out]}


@register_op("one_hot", no_grad=True)
def _one_hot(ins, attrs, device):
    x = _x(ins)
    if x.dim() > 1 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    classes = torch.arange(attrs["depth"], device=x.device)
    hot = x.unsqueeze(-1) == classes
    return {"Out": [hot.to(torch_dtype(attrs.get("dtype", "float32")))]}


def _lookup_table_grad_maker(op, block, out_grads, provide, should_skip):
    """A dense table takes the derived grad op (``w[ids]``'s backward: an
    indexed accumulate that sorts the ids and adds each run in order).
    ``is_sparse=True`` emits the row-sparse pair instead
    (ops/sparse_ops.py): ``{W}@GRAD@ROWS`` / ``{W}@GRAD@VALUES``, with
    ``{W}@GRAD`` a never-materialized marker carrying
    ``is_selected_rows``, so the optimizer picks its sparse op. A table
    that several lookups share, or that also takes a dense gradient,
    raises (the pair cannot be summed), as in the JAX package."""
    if not op.attrs.get("is_sparse", False):
        return None  # the derived dense grad op
    w = op.inputs["W"][0]
    g_out = (out_grads.get("Out") or [""])[0]
    if not g_out:
        return []
    opdef = get_op_def("lookup_table")
    if should_skip(w, "W", opdef):
        return []
    src = block._find_var_recursive(w)
    gname = provide(w)
    if "@RENAME@" in gname:
        raise ValueError(
            f"lookup_table(is_sparse=True): table '{w}' is consumed by "
            f"multiple lookups in the backward path; the row-sparse "
            f"gradient pair cannot be summed. Use is_sparse=False for "
            f"shared tables.")
    gv = block.create_var(name=gname, shape=src.shape if src else None,
                          dtype=src.dtype if src else "float32")
    rows_name, values_name = gname + "@ROWS", gname + "@VALUES"
    block.create_var(name=rows_name, dtype="int32")
    block.create_var(name=values_name,
                     dtype=src.dtype if src else "float32")
    gv.is_selected_rows = True
    gv.sparse_rows_name = rows_name
    gv.sparse_values_name = values_name
    attrs = {"vocab_size": int(src.shape[0])}
    # the forward's squeeze and padding, as the layer pinned them
    for k in ("squeeze_last", "padding_idx"):
        if k in op.attrs:
            attrs[k] = op.attrs[k]
    return [dict(
        type="lookup_table_sparse_grad",
        inputs={"Ids": list(op.inputs["Ids"]), "GRAD::Out": [g_out]},
        outputs={"Rows": [rows_name], "Values": [values_name]},
        attrs=attrs,
    )]


@register_op("lookup_table", diff_inputs=("W",),
             grad_maker=_lookup_table_grad_maker,
             doc="embedding lookup over int ids (lookup_table_op.cc)")
def _lookup_table(ins, attrs, device):
    w, ids = _x(ins, "W"), _x(ins, "Ids")
    # [N, 1] column-ids convention: squeeze unless the layer says the ids
    # are already a padded [b, t] batch (a [b, 1] batch is ambiguous).
    squeeze_last = attrs.get(
        "squeeze_last", ids.dim() > 1 and ids.shape[-1] == 1)
    if squeeze_last:
        ids = ids.squeeze(-1)
    out = w[ids]
    # Fluid semantics: no padding when absent; negative = vocab + idx.
    padding_idx = attrs.get("padding_idx", None)
    if padding_idx is not None:
        if padding_idx < 0:
            padding_idx = w.shape[0] + padding_idx
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return {"Out": [out]}


@register_op("top_k", no_grad=True)
def _top_k(ins, attrs, device):
    """The k largest entries of the last dim, largest first, and their
    int64 indices; among equal entries the lower index comes first, as
    ``jax.lax.top_k`` orders them (the first k of a stable descending
    sort: ``torch.topk`` promises no order among ties)."""
    k = attrs["k"]
    vals, idx = torch.sort(_x(ins), dim=-1, descending=True, stable=True)
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}


@register_op("arg_max", no_grad=True)
def _arg_max(ins, attrs, device):
    return {"Out": [torch.argmax(_x(ins), dim=attrs.get("axis", -1))]}


@register_op("where", diff_inputs=("X", "Y"))
def _where(ins, attrs, device):
    return {"Out": [torch.where(_x(ins, "Condition"), _x(ins), _x(ins, "Y"))]}


@register_op("dynamic_update", diff_inputs=("X", "Value"))
def _dynamic_update(ins, attrs, device):
    """Write Value at the (device-resident) position Index along axis 0
    of X. The index clamps into range like ``lax.dynamic_update_slice``,
    and stays a tensor so the op never syncs the host."""
    x = _x(ins)
    idx = ins["Index"][0].reshape(1).to(torch.int64).clamp(
        0, x.shape[0] - 1)
    v = ins["Value"][0].to(x.dtype).unsqueeze(0)
    return {"Out": [x.index_copy(0, idx, v)]}


@register_op("transpose2")
def _transpose2(ins, attrs, device):
    return {"Out": [_x(ins).permute(*attrs["axis"])], "XShape": []}


@register_op("slice")
def _slice(ins, attrs, device):
    """Static slices ``[start:end]`` on ``axes``, Python's rules (negative
    bounds count from the end, bounds clamp to the dim)."""
    x = _x(ins)
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[ax] = slice(st, en)
    return {"Out": [x[tuple(idx)]]}


@register_op("squeeze2")
def _squeeze2(ins, attrs, device):
    x = _x(ins)
    axes = tuple(attrs.get("axes", []))
    return {"Out": [x.squeeze(axes) if axes else x.squeeze()], "XShape": []}


@register_op("expand")
def _expand(ins, attrs, device):
    """``np.tile``: each dim repeated ``expand_times`` times (a shorter
    list counts from the last dim)."""
    x = _x(ins)
    times = list(attrs["expand_times"])
    times = [1] * (x.dim() - len(times)) + times
    return {"Out": [x.repeat(times)]}


@register_op("range", no_grad=True)
def _range(ins, attrs, device):
    dtype = torch_dtype(attrs.get("dtype", "int64"))
    return {"Out": [torch.arange(attrs.get("start", 0), attrs["end"],
                                 attrs.get("step", 1), dtype=dtype,
                                 device=device)]}


@register_op("dynamic_slice", diff_inputs=("X",))
def _dynamic_slice(ins, attrs, device):
    """Read the [Index] slice along axis 0 of X. The index stays on the
    device (an ``index_select``, no host read, so the op may sit in a
    captured graph) and clamps into range, as ``lax.dynamic_slice``
    clamps its start."""
    x = _x(ins)
    idx = ins["Index"][0].reshape(1).clamp(0, x.shape[0] - 1)
    return {"Out": [x.index_select(0, idx).squeeze(0)]}


def _const(values, dtype, device):
    """A 1-D tensor of Python numbers made on ``device`` by one fill each:
    no host copy, so a captured step may hold it (the numbers are attrs,
    the same at every replay)."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i:i + 1].fill_(v)
    return out


@register_op("iou_similarity", no_grad=True)
def _iou_similarity(ins, attrs, device):
    """Pairwise IoU of two box sets [N, 4] x [M, 4] (xmin, ymin, xmax,
    ymax) (reference: operators/detection/iou_similarity_op.cc)."""
    return {"Out": [iou_xyxy(_x(ins), _x(ins, "Y"))]}


@register_op("box_coder", no_grad=True)
def _box_coder(ins, attrs, device):
    """Encode / decode boxes against priors (reference:
    operators/detection/box_coder_op.cc). PriorBox [M, 4], TargetBox
    encode: [N, 4] -> [N, M, 4]; decode: [N, M, 4]. The variances scale
    the offsets: the PriorBoxVar input, else the ``variance`` attr, else
    ones."""
    prior = _x(ins, "PriorBox")
    target = _x(ins, "TargetBox")
    code_type = attrs.get("code_type", "encode_center_size")
    one = 0.0 if attrs.get("box_normalized", True) else 1.0
    pvar = (ins.get("PriorBoxVar") or [None])[0]
    if pvar is None:
        va = attrs.get("variance", []) or [1.0, 1.0, 1.0, 1.0]
        pvar = _const(va, prior.dtype, prior.device).expand(
            prior.shape[0], 4)
    pw = prior[:, 2] - prior[:, 0] + one
    ph = prior[:, 3] - prior[:, 1] + one
    px = prior[:, 0] + pw * 0.5
    py = prior[:, 1] + ph * 0.5
    if code_type.startswith("encode"):
        tw = target[:, 2] - target[:, 0] + one
        th = target[:, 3] - target[:, 1] + one
        tx = target[:, 0] + tw * 0.5
        ty = target[:, 1] + th * 0.5
        ox = (tx[:, None] - px[None, :]) / pw[None, :] / pvar[None, :, 0]
        oy = (ty[:, None] - py[None, :]) / ph[None, :] / pvar[None, :, 1]
        ow = torch.log(tw[:, None] / pw[None, :]) / pvar[None, :, 2]
        oh = torch.log(th[:, None] / ph[None, :]) / pvar[None, :, 3]
        out = torch.stack([ox, oy, ow, oh], dim=-1)
    else:
        tx = target[..., 0] * pvar[None, :, 0] * pw[None, :] + px[None, :]
        ty = target[..., 1] * pvar[None, :, 1] * ph[None, :] + py[None, :]
        tw = torch.exp(target[..., 2] * pvar[None, :, 2]) * pw[None, :]
        th = torch.exp(target[..., 3] * pvar[None, :, 3]) * ph[None, :]
        out = torch.stack([tx - tw * 0.5, ty - th * 0.5,
                           tx + tw * 0.5 - one, ty + th * 0.5 - one], dim=-1)
    return {"OutputBox": [out]}


@register_op("prior_box", no_grad=True)
def _prior_box(ins, attrs, device):
    """SSD prior boxes per feature-map cell (reference:
    operators/detection/prior_box_op.cc). Input [N, C, H, W] feature map,
    Image [N, C, Hi, Wi]; Boxes / Variances [H, W, P, 4] in f32, computed
    in f64 (the JAX package's x64 arithmetic, rounded once)."""
    feat, img = _x(ins, "Input"), _x(ins, "Image")
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    min_sizes = list(attrs.get("min_sizes", [100.0]))
    max_sizes = list(attrs.get("max_sizes", []))
    ars = [1.0]
    for ar in attrs.get("aspect_ratios", []):
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(ar)
            if attrs.get("flip", True):
                ars.append(1.0 / ar)
    variances = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    step_w = attrs.get("step_w", 0.0) or float(iw) / w
    step_h = attrs.get("step_h", 0.0) or float(ih) / h
    offset = attrs.get("offset", 0.5)
    whs = []
    for i, ms in enumerate(min_sizes):
        for ar in ars:
            whs.append((ms * (ar ** 0.5), ms / (ar ** 0.5)))
        # one extra sqrt(min * max) square prior per min size
        if i < len(max_sizes):
            s = (ms * max_sizes[i]) ** 0.5
            whs.append((s, s))
    p = len(whs)
    f64 = torch.float64
    cw = _const([a for a, _ in whs], f64, feat.device) / iw      # [P]
    ch = _const([b for _, b in whs], f64, feat.device) / ih
    cx = (torch.arange(w, dtype=f64, device=feat.device) + offset) \
        * step_w / iw                                              # [W]
    cy = (torch.arange(h, dtype=f64, device=feat.device) + offset) \
        * step_h / ih                                              # [H]
    cxg = cx[None, :, None].expand(h, w, p)
    cyg = cy[:, None, None].expand(h, w, p)
    boxes = torch.stack([cxg - cw / 2, cyg - ch / 2, cxg + cw / 2,
                         cyg + ch / 2], dim=-1)
    if attrs.get("clip", True):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = _const(variances, torch.float32, feat.device).expand(h, w, p, 4)
    return {"Boxes": [boxes.to(torch.float32)], "Variances": [var]}
