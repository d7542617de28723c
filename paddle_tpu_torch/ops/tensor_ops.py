"""Tensor creation & manipulation ops.

Random fills (the initializers ``gaussian_random``, ``uniform_random``
and ``truncated_gaussian_random``) draw from the host-seeded
``torch.Generator`` the interpreter hands them (seeded per op from the
run's step seed, see core/interp.py), so a seeded run is reproducible on one device; they are
``host_rng`` ops, and a block that holds one (a startup program) runs
eagerly, never as a CUDA graph. The streams differ from the JAX
package's PRNG: weights carry across by name (io.scope_from_numpy), never
by re-drawing them. ``sampling_id``, which a step runs, draws on the
device from its op seed instead (core/rng.py ``op_uniform01``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import rng
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


@register_op("truncated_gaussian_random", no_grad=True, host_rng=True)
def _truncated_gaussian_random(ins, attrs, device, generator=None):
    """mean + std * a normal truncated to [-2, 2], by the inverse CDF of a
    uniform draw from the host-seeded generator (an initializer, as
    ``gaussian_random``): sqrt(2) erfinv(u), u uniform in (erf(-sqrt 2),
    erf(sqrt 2)), drawn and transformed in f64."""
    shape = tuple(attrs["shape"])
    bound = math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(shape, dtype=torch.float64, device=device).uniform_(
        -bound, bound, generator=generator)
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(u), -2.0, 2.0)
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return {"Out": [out.to(torch_dtype(attrs.get("dtype", "float32")))]}


@register_op("shape", no_grad=True)
def _shape(ins, attrs, device):
    """X's shape as an int64 tensor on X's device (fills, no host read)."""
    x = _x(ins)
    return {"Out": [_const(list(x.shape), torch.int64, x.device)]}


@register_op("stack")
def _stack(ins, attrs, device):
    return {"Out": [torch.stack(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("unstack")
def _unstack(ins, attrs, device):
    return {"Y": list(torch.unbind(_x(ins), dim=attrs.get("axis", 0)))}


@register_op("expand_as")
def _expand_as(ins, attrs, device):
    """X broadcast to Y's shape (a copy: the executor may write it in
    place)."""
    return {"Out": [_x(ins).expand(_x(ins, "Y").shape).clone()]}


@register_op("gather", diff_inputs=("X",))
def _gather(ins, attrs, device):
    """``jnp.take(x, index, axis)``: the index's shape replaces dim
    ``axis``."""
    x, index = _x(ins), _x(ins, "Index")
    axis = attrs.get("axis", 0) % x.dim()
    out = x.index_select(axis, index.reshape(-1).to(torch.int64))
    return {"Out": [out.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                                + tuple(x.shape[axis + 1:]))]}


@register_op("arg_min", no_grad=True)
def _arg_min(ins, attrs, device):
    """int64 index of the first minimum along ``axis``."""
    return {"Out": [torch.argmin(_x(ins), dim=attrs.get("axis", -1))]}


@register_op("cumsum")
def _cumsum(ins, attrs, device):
    """Cumulative sum along ``axis``; ``reverse`` sums from the end;
    ``exclusive`` subtracts each element from its own sum, as the JAX op
    does."""
    x = _x(ins)
    axis = attrs.get("axis", -1)
    rev = attrs.get("reverse", False)
    if rev:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = out - x
    if rev:
        out = torch.flip(out, (axis,))
    return {"Out": [out]}


def _torch_pads(pairs):
    """[(before, after) a dim, first dim first] -> F.pad's flat list, last
    dim first."""
    flat = []
    for b, a in reversed(pairs):
        flat += [int(b), int(a)]
    return flat


@register_op("pad")
def _pad(ins, attrs, device):
    """Constant padding, ``paddings`` = [before0, after0, before1, ...]."""
    x = _x(ins)
    p = attrs["paddings"]
    pairs = [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())]
    return {"Out": [F.pad(x, _torch_pads(pairs),
                          value=attrs.get("pad_value", 0.0))]}


@register_op("tile")
def _tile(ins, attrs, device):
    """``jnp.tile``: a shorter ``repeat_times`` counts from the last dim."""
    x = _x(ins)
    times = list(attrs["repeat_times"])
    times = [1] * (x.dim() - len(times)) + times
    return {"Out": [x.repeat(times)]}


@register_op("reverse", diff_inputs=("X",))
def _reverse(ins, attrs, device):
    return {"Out": [torch.flip(_x(ins), tuple(attrs.get("axis", [0])))]}


@register_op("argsort", no_grad=True)
def _argsort(ins, attrs, device):
    """Values and int64 indices sorted along ``axis``, equal keys in their
    input order (the stable ``jnp.argsort``; descending sorts -x). The
    keys add 0.0, so -0.0 and +0.0 tie on the card's radix sort as on
    the CPU."""
    x = _x(ins)
    axis = attrs.get("axis", -1)
    key = (-x if attrs.get("descending", False) else x) + 0.0
    _, idx = torch.sort(key, dim=axis, stable=True)
    return {"Out": [torch.gather(x, axis, idx)], "Indices": [idx]}


@register_op("diag", no_grad=True)
def _diag(ins, attrs, device):
    return {"Out": [torch.diag(_x(ins, "Diagonal"))]}


@register_op("linspace", no_grad=True)
def _linspace(ins, attrs, device):
    """``num`` evenly spaced values from Start to Stop (device scalars,
    never read on the host): start + i * (stop - start) / (num - 1), the
    last exactly Stop."""
    start = _x(ins, "Start").reshape(())
    stop = _x(ins, "Stop").reshape(())
    num = int(attrs["num"])
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    wide = torch.promote_types(dtype, start.dtype)
    start, stop = start.to(wide), stop.to(wide)
    if num == 1:
        return {"Out": [start.reshape(1).to(dtype)]}
    i = torch.arange(num, dtype=wide, device=start.device)
    out = start + i * ((stop - start) / (num - 1))
    out = torch.cat([out[:-1], stop.reshape(1)])
    return {"Out": [out.to(dtype)]}


def _nd_index(index):
    return tuple(index.to(torch.int64).unbind(-1))


@register_op("gather_nd", diff_inputs=("X",))
def _gather_nd(ins, attrs, device):
    """X at the coordinates of Index's last dim."""
    return {"Out": [_x(ins)[_nd_index(_x(ins, "Index"))]]}


@register_op("scatter_nd_add", diff_inputs=("X", "Updates"))
def _scatter_nd_add(ins, attrs, device):
    """X plus Updates added at the coordinates of Index's last dim
    (repeated coordinates add up)."""
    x = _x(ins)
    return {"Out": [torch.index_put(x, _nd_index(_x(ins, "Index")),
                                    _x(ins, "Updates").to(x.dtype),
                                    accumulate=True)]}


_PAD2D_MODES = {"constant": "constant", "reflect": "reflect",
                "edge": "replicate"}


@register_op("pad2d", diff_inputs=("X",))
def _pad2d(ins, attrs, device):
    """NCHW spatial padding, ``paddings`` = [top, bottom, left, right],
    constant / reflect / edge."""
    x = _x(ins)
    t, b, l, r = attrs.get("paddings", [0, 0, 0, 0])
    mode = _PAD2D_MODES[attrs.get("mode", "constant")]
    if mode == "constant":
        return {"Out": [F.pad(x, [l, r, t, b],
                              value=attrs.get("pad_value", 0.0))]}
    return {"Out": [F.pad(x, [l, r, t, b], mode=mode)]}


@register_op("pad_constant_like", diff_inputs=("Y",))
def _pad_constant_like(ins, attrs, device):
    """Y padded at the end of each dim up to X's shape."""
    x, y = _x(ins), _x(ins, "Y")
    pairs = [(0, int(a) - int(b)) for a, b in zip(x.shape, y.shape)]
    return {"Out": [F.pad(y, _torch_pads(pairs),
                          value=attrs.get("pad_value", 0.0))]}


@register_op("crop", diff_inputs=("X",))
def _crop(ins, attrs, device):
    """The static window ``shape`` at ``offsets``."""
    x = _x(ins)
    offsets = attrs.get("offsets", [0] * x.dim())
    sl = tuple(slice(o, o + s) for o, s in zip(offsets, attrs["shape"]))
    return {"Out": [x[sl]]}


@register_op("shuffle_channel", diff_inputs=("X",))
def _shuffle_channel(ins, attrs, device):
    x = _x(ins)
    g = int(attrs.get("group", 1))
    n, c, h, w = x.shape
    return {"Out": [x.reshape(n, g, c // g, h, w).transpose(1, 2)
                    .reshape(n, c, h, w)]}


@register_op("pixel_shuffle", diff_inputs=("X",))
def _pixel_shuffle(ins, attrs, device):
    """Depth to space: [n, c r^2, h, w] -> [n, c, h r, w r]."""
    x = _x(ins)
    r = int(attrs.get("upscale_factor", 1))
    n, c, h, w = x.shape
    out = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": [out.reshape(n, c // (r * r), h * r, w * r)]}


@register_op("space_to_depth", diff_inputs=("X",))
def _space_to_depth(ins, attrs, device):
    """[n, c, h, w] -> [n, c r^2, h / r, w / r], the block offsets
    leading the channels."""
    x = _x(ins)
    r = int(attrs.get("blocksize", 1))
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // r, r, w // r, r).permute(0, 3, 5, 1, 2, 4)
    return {"Out": [out.reshape(n, c * r * r, h // r, w // r)]}


@register_op("multiplex", diff_inputs=("X",))
def _multiplex(ins, attrs, device):
    """Row i of the candidate Ids[i]."""
    xs = torch.stack(ins["X"], dim=0)
    ids = _x(ins, "Ids")
    if ids.dim() > 1:
        ids = ids.squeeze(-1)
    rows = torch.arange(xs.shape[1], device=xs.device)
    return {"Out": [xs[ids.to(torch.int64), rows]]}


@register_op("sampling_id", no_grad=True, needs_rng=True)
def _sampling_id(ins, attrs, device, seed=None):
    """One column index a row of probability rows X, by the Gumbel-max
    rule the JAX op's ``jax.random.categorical`` applies: argmax of
    log(max(x, 1e-30)) + g, g = -log(-log(u)), u from the op seed
    (``rng.op_uniform01``: the CPU and the card draw the same bits;
    ``sampling_gumbel`` gives g). int64."""
    x = _x(ins)
    g = sampling_gumbel(0 if seed is None else seed, x.shape, x.device)
    logits = torch.log(torch.clamp_min(x, 1e-30)).to(torch.float64)
    return {"Out": [torch.argmax(logits + g, dim=-1)]}


def sampling_gumbel(seed, shape, device):
    """The standard Gumbel noise ``sampling_id`` adds (f64)."""
    return -torch.log(-torch.log(rng.op_uniform01(seed, shape, device)))


@register_op("shard_index", no_grad=True)
def _shard_index(ins, attrs, device):
    """Global ids to shard-local ids, ``ignore_value`` off the shard."""
    x = _x(ins)
    per = (attrs["index_num"] + attrs["nshards"] - 1) // attrs["nshards"]
    in_shard = torch.div(x, per, rounding_mode="floor") == attrs["shard_id"]
    ignore = torch.full((), attrs.get("ignore_value", -1), dtype=x.dtype,
                        device=x.device)
    return {"Out": [torch.where(in_shard, torch.remainder(x, per), ignore)]}


@register_op("flatten")
def _flatten(ins, attrs, device):
    """flatten2 without its XShape output."""
    return {"Out": _flatten2(ins, attrs, device)["Out"]}


@register_op("anchor_generator", no_grad=True)
def _anchor_generator(ins, attrs, device):
    """RPN anchors per feature-map cell (reference:
    operators/detection/anchor_generator_op.cc): Anchors / Variances [H,
    W, A, 4] in input-image pixels, A = ratios x sizes (ratio-major),
    computed in f64 and returned in f32 (as ``prior_box``)."""
    feat = _x(ins, "Input")
    h, w = feat.shape[2], feat.shape[3]
    sizes = attrs.get("anchor_sizes", [64.0, 128.0, 256.0, 512.0])
    ratios = attrs.get("aspect_ratios", [0.5, 1.0, 2.0])
    stride = attrs.get("stride", [16.0, 16.0])
    offset = attrs.get("offset", 0.5)
    whs = []
    for r in ratios:
        for s in sizes:
            aw = (s * s / r) ** 0.5
            whs.append((aw, aw * r))
    a = len(whs)
    f64 = torch.float64
    aw = _const([x for x, _ in whs], f64, feat.device)
    ah = _const([y for _, y in whs], f64, feat.device)
    cx = (torch.arange(w, dtype=f64, device=feat.device) + offset) * stride[0]
    cy = (torch.arange(h, dtype=f64, device=feat.device) + offset) * stride[1]
    cxg = cx[None, :, None].expand(h, w, a)
    cyg = cy[:, None, None].expand(h, w, a)
    anchors = torch.stack([cxg - aw / 2, cyg - ah / 2, cxg + aw / 2,
                           cyg + ah / 2], dim=-1)
    var = _const(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                 torch.float32, feat.device).expand(h, w, a, 4)
    return {"Anchors": [anchors.to(torch.float32)], "Variances": [var]}


# --- the older op types of the *2 ops: no XShape output, and a derived
# grad that needs X alone ---


@register_op("reshape", diff_inputs=("X",))
def _reshape_v1(ins, attrs, device):
    x = _x(ins)
    shape = [x.shape[i] if int(d) == 0 else int(d)
             for i, d in enumerate(attrs["shape"])]
    return {"Out": [x.reshape(shape)]}


@register_op("transpose", diff_inputs=("X",))
def _transpose_v1(ins, attrs, device):
    return {"Out": [_x(ins).permute(*attrs["axis"])]}


@register_op("squeeze", diff_inputs=("X",))
def _squeeze_v1(ins, attrs, device):
    x = _x(ins)
    axes = tuple(attrs.get("axes", []))
    return {"Out": [x.squeeze(axes) if axes else x.squeeze()]}


@register_op("unsqueeze", diff_inputs=("X",))
def _unsqueeze_v1(ins, attrs, device):
    return {"Out": _unsqueeze2(ins, attrs, device)["Out"]}
