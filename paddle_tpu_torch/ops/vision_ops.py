"""Vision ops of the JAX package's ops/vision_ops.py (reference kernels:
paddle/fluid/operators/{roi_pool_op.cc, roi_align_op.cc,
detection/yolo_box_op.cc, detection/box_clip_op.cc,
detection/multiclass_nms_op.cc, detection/density_prior_box_op.cc,
detection/bipartite_match_op.cc, conv_op.cc (3d), pool_op.cc (3d),
max_pool_with_index_op.cc, unpool_op.cc, spp_op.cc, lrn_op.cc,
affine_grid_op.cc, random_crop_op.cc, detection/psroi_pool_op.cc,
detection/polygon_box_transform_op.cc, similarity_focus_op.h,
detection/roi_perspective_transform_op.cc}). Static shapes, as there:
NMS emits fixed-capacity outputs padded with -1 labels instead of the
reference's variable-length LoD results.

The greedy NMS sweep is written by hand (``nms_sweep``: on CUDA
tensors ``nms_sweep_mask_kernel``, the pairwise tests packed into a
bitmask across the card, and ``nms_sweep_scan_kernel``, a warp a set
walking it, both in csrc/nms_sweep.cu; on the CPU the plain host loop
``nms_sweep_plain``); ``multiclass_nms`` and the detection ops'
``generate_proposals`` run it. ``nms_mask_words_plain`` and
``nms_scan_plain`` are the plain versions of the two stages.

Gradients that scatter into X (``roi_align``, ``roi_pool``,
``psroi_pool``, ``unpool``, ``max_pool*_with_index``,
``roi_perspective_transform``) are deterministic, with no atomic add, so
a CUDA graph replays the same bits: the bilinear samplers read X's pixel
rows through ``_GatherRows``, whose backward sorts the pixel indices
(stably) and sums each pixel's rows in order (``scatter_rows``:
sequential sums in chunks, the same order on the CPU and the card); the
other ops read X by advanced indexing (``x[b]``, ``x[rows, idx]``), whose
backward is PyTorch's sorted ``index_put_`` with accumulation, and
``unpool`` writes its output by that accumulation. (That accumulation
adds an index's duplicates one after another: fine for a few, but the
FPN heads' roi_align samples, hundreds to a pixel, spent 863 of a 999 ms
step in it on an H100.)"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch import kernels
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core.registry import get_op_def, register_op
from paddle_tpu_torch.ops.box_util import greedy_bipartite_match
from paddle_tpu_torch.ops.tensor_ops import _const

NMS_SOURCE = "nms_sweep"
_NMS_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_double, ctypes.c_void_p])
# candidates a mask word (and a chunk of the scan)
NMS_WORD_BITS = 64
# launches: kernels.launch_counts["nms_sweep"], one per call of
# ``nms_sweep`` on CUDA tensors (the mask kernel and the scan);
# ["nms_sweep_mask"], one per call of ``nms_mask_words`` (the mask kernel)


def _x(ins, slot="X", i=0):
    v = ins.get(slot)
    return v[i] if v else None


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(d) for d in v)
    return (int(v),) * n


def desc_order(x):
    """The indices that sort the last dim of ``x`` largest first, equal
    values in index order: ``jnp.argsort(-x)`` (a stable sort). -0.0 is
    made +0.0 first, as JAX's sort does, because the card's radix sort
    would put -0.0 before +0.0."""
    return torch.sort(-x + 0.0, dim=-1, stable=True).indices


# --------------------------------------------------------------------------
# the greedy NMS sweep
# --------------------------------------------------------------------------


def _iou_matrix(boxes):
    """[..., m, 4] -> [..., m, m] pairwise IoU."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp_min(ix2 - ix1, 0) * torch.clamp_min(iy2 - iy1, 0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-10)


def sweep_mask(over, keep0):
    """The greedy sweep given its pairwise tests: over [B, m, m] (over[b,
    i, j]: IoU(i, j) above the threshold; only j < i is read), keep0 [B,
    m] bool -> keep [B, m], keep[i] = keep0[i] and no earlier kept j has
    over[i, j]. A host loop over i, every set at once."""
    m = over.shape[-1]
    earlier = torch.ones(m, m, dtype=torch.bool,
                         device=over.device).tril(diagonal=-1)
    over_t = over & earlier                              # [B, m, m]
    keep = keep0.clone()
    for i in range(m):
        hit = (over_t[:, i, :] & keep).any(dim=-1)
        keep[:, i] = keep[:, i] & ~hit
    return keep


def nms_sweep_plain(boxes, keep0, iou_threshold):
    """The greedy sweep over score-sorted candidate sets: boxes [B, m, 4],
    keep0 [B, m] bool -> keep [B, m], keep[i] = keep0[i] and no earlier
    kept j has ``_iou_matrix``'s IoU(i, j) > iou_threshold (at thresholds
    >= 0 box_util.iou_xyxy's gives the same mask: csrc/nms_sweep.cu says
    why). ``sweep_mask`` over the [B, m, m] IoU matrix: the plain version
    of ``nms_sweep``."""
    return sweep_mask(_iou_matrix(boxes) > iou_threshold, keep0)


def nms_mask_words_plain(boxes, iou_threshold):
    """The sweep's pairwise tests packed as ``nms_sweep_mask_kernel``
    packs them: boxes [B, m, 4] -> int64 words [B, m, W], W = ceil(m /
    64); bit jj of word (i, cb) is set when j = 64 cb + jj > i and
    IoU(j, i) > iou_threshold (``_iou_matrix``'s, the later candidate
    first: ``nms_sweep_plain``'s over[j, i]). Words below the diagonal
    block (cb < i // 64) are 0."""
    b, m = boxes.shape[0], boxes.shape[1]
    w = _nms_words(m)[0]
    later = torch.ones(m, m, dtype=torch.bool, device=boxes.device).triu(1)
    over = torch.zeros(b, m, w * NMS_WORD_BITS, dtype=torch.bool,
                       device=boxes.device)
    over[..., :m] = (_iou_matrix(boxes) > iou_threshold).transpose(1, 2) \
        & later
    over = over.reshape(b, m, w, NMS_WORD_BITS)
    words = torch.zeros(b, m, w, dtype=torch.int64, device=boxes.device)
    for k in range(NMS_WORD_BITS):
        words |= over[..., k].to(torch.int64) << k
    return words


def nms_scan_plain(words, keep0):
    """The greedy sweep over packed tests, walked as
    ``nms_sweep_scan_kernel`` walks it: words [B, m, W]
    (``nms_mask_words_plain``'s), keep0 [B, m] bool -> keep [B, m]. The
    chunks of 64 candidates in order. In chunk c the candidates ``live``
    are those of keep0 whose bit in ``removed`` word c (the earlier
    chunks' kept rows) is clear; the chunk keeps the fixpoint of K = live
    and not overlapped by an earlier row of K in the chunk (the diagonal
    block's words), which is the greedy keep: after t rounds K agrees with
    it on the chunk's first t rows. The kept rows' later words then join
    ``removed``."""
    b, m, w = words.shape
    keep = torch.zeros_like(keep0)
    removed = torch.zeros(b, w, dtype=torch.int64, device=words.device)
    zero = torch.zeros((), dtype=torch.int64, device=words.device)
    for c in range(w):
        lo = c * NMS_WORD_BITS
        rows = words[:, lo:lo + NMS_WORD_BITS]                 # [B, n, W]
        pos = torch.arange(rows.shape[1], device=words.device)
        # over[b, ii, jj]: row ii of the chunk overlaps its later row jj
        over = (rows[:, :, c, None] >> pos) & 1 == 1
        live = keep0[:, lo:lo + rows.shape[1]] & (
            (removed[:, c, None] >> pos) & 1 == 0)
        kept = live
        while True:
            k = live & ~(over & kept[:, :, None]).any(1)
            if torch.equal(k, kept):
                break
            kept = k
        keep[:, lo:lo + rows.shape[1]] = kept
        for ii in range(rows.shape[1]):
            removed[:, c + 1:] |= torch.where(kept[:, ii, None],
                                              rows[:, ii, c + 1:], zero)
    return keep


def _nms_check(boxes, keep0=None):
    """Raise on what the sweep does not take: boxes [B, m, 4] (f32 or f64
    on the card) and, where given, a bool keep0 [B, m] on their device."""
    got = f"{tuple(boxes.shape)}"
    ok = boxes.dim() == 3 and boxes.shape[-1] == 4
    if keep0 is not None:
        got += f" and {keep0.dtype} {tuple(keep0.shape)}"
        ok = ok and tuple(keep0.shape) == tuple(boxes.shape[:2]) and \
            keep0.dtype == torch.bool and keep0.device == boxes.device
    if not ok:
        raise ValueError(f"nms_sweep: boxes [B, m, 4] and a bool keep0 "
                         f"[B, m] on one device, got {got}")
    if boxes.device.type == "cuda" and \
            boxes.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"nms_sweep kernel: dtype {boxes.dtype} (takes "
                        f"float32 or float64)")


def _nms_boxes(boxes):
    """``boxes`` contiguous, each box's four values aligned as one vector
    load (the kernels read a box at once)."""
    boxes = boxes.contiguous()
    if boxes.data_ptr() % (4 * boxes.element_size()):
        boxes = boxes.clone()
    return boxes


def _nms_words(m):
    """(W, Wp): the words a row of the mask holds, ceil(m / 64), and its
    stride, W rounded up to even (the kernels copy rows in 16 bytes)."""
    w = -(-m // NMS_WORD_BITS)
    return w, w + w % 2


def _nms_work(boxes, fill):
    """The kernels' scratch: sets * m * (Wp + 1) int64 words, the mask
    [B, m, Wp] and then each candidate's column word of its diagonal
    block [B, m] (``torch.zeros`` where ``fill``, else ``torch.empty``)."""
    sets, m = boxes.shape[0], boxes.shape[1]
    make = torch.zeros if fill else torch.empty
    return make(sets * m * (_nms_words(m)[1] + 1), dtype=torch.int64,
                device=boxes.device)


def _nms_launch(boxes, keep0, keep, work, iou_threshold):
    """``pt_nms_sweep`` on the current stream: the mask kernel into
    ``work``, then (``keep`` given) the scan into ``keep``."""
    # the threshold rounded to the boxes' dtype, as the plain comparison
    # rounds a Python float against an f32 tensor
    thr = float(torch.tensor(iou_threshold, dtype=boxes.dtype))
    entry = kernels.function(NMS_SOURCE, "pt_nms_sweep", _NMS_ARGS)
    rc = entry(boxes.data_ptr(), None if keep0 is None else keep0.data_ptr(),
               None if keep is None else keep.data_ptr(), work.data_ptr(),
               boxes.shape[0], boxes.shape[1],
               1 if boxes.dtype == torch.float64 else 0, thr,
               torch.cuda.current_stream(boxes.device).cuda_stream)
    kernels.check(NMS_SOURCE, rc, "nms_sweep")


def nms_mask_words(boxes, iou_threshold):
    """``nms_mask_words_plain``'s words: on CUDA tensors from
    ``nms_sweep_mask_kernel`` alone (a view of its [B, m, Wp] mask; the
    words below the diagonal block, which it never writes, zeroed
    first), on the CPU from the plain version."""
    _nms_check(boxes)
    if boxes.device.type != "cuda":
        return nms_mask_words_plain(boxes, iou_threshold)
    sets, m = boxes.shape[0], boxes.shape[1]
    boxes = _nms_boxes(boxes)
    work = _nms_work(boxes, fill=True)
    w, wp = _nms_words(m)
    words = work[:sets * m * wp].view(sets, m, wp)[..., :w]
    if sets == 0 or m == 0:
        return words
    _nms_launch(boxes, None, None, work, iou_threshold)
    kernels.count("nms_sweep_mask")
    return words


def nms_sweep(boxes, keep0, iou_threshold):
    """``nms_sweep_plain``'s keep mask: on CUDA tensors from
    ``nms_sweep_mask_kernel`` and ``nms_sweep_scan_kernel`` (the tests of
    every later against every earlier candidate packed into a [B, m,
    ceil(m / 64)] bitmask across the card, then a warp a set walking it;
    no [B, m, m] tensor; f32 or f64 boxes, each IoU in the plain
    version's order of IEEE operations, so the mask is the same bits), on
    the CPU from the plain version."""
    _nms_check(boxes, keep0)
    if boxes.device.type != "cuda":
        return nms_sweep_plain(boxes, keep0, iou_threshold)
    boxes, keep0 = _nms_boxes(boxes), keep0.contiguous()
    keep = torch.empty_like(keep0)
    if boxes.shape[0] == 0 or boxes.shape[1] == 0:
        return keep
    # the mask kernel writes the words the scan reads (cb >= i // 64) and
    # no others
    _nms_launch(boxes, keep0, keep, _nms_work(boxes, fill=False),
                iou_threshold)
    kernels.count("nms_sweep")
    return keep


def _sorted_candidates(boxes, scores, top_k):
    """(order [B, top_k], sorted boxes [B, top_k, 4], sorted scores) of
    the ``top_k`` best of each set (a stable sort, as ``jnp.argsort``)."""
    order = desc_order(scores)[..., :top_k]
    b = torch.gather(boxes, 1, order[..., None].expand(*order.shape, 4))
    return order, b, torch.gather(scores, 1, order)


def _nms_keep(boxes, scores, iou_threshold, top_k):
    """Greedy NMS with static shapes over a batch of candidate sets:
    boxes [B, m, 4], scores [B, m] -> (order [B, top_k], keep [B, top_k]),
    the keep mask over the top_k score-sorted candidates (equal scores
    keep their index order, as ``jnp.argsort``), the sweep on the host
    (``nms_sweep_plain``): the JAX package's ``_nms_keep``."""
    order, b, s = _sorted_candidates(boxes, scores, top_k)
    return order, nms_sweep_plain(b, s > 0, iou_threshold)


@register_op("multiclass_nms", no_grad=True)
def _multiclass_nms(ins, attrs, device):
    """BBoxes [n, m, 4]; Scores [n, cls, m]. Out [n, keep_top_k, 6] rows
    (label, score, x1, y1, x2, y2), label -1 padding. Each class of each
    image keeps its NMS survivors among its top ``nms_top_k`` scores above
    ``score_threshold`` (``nms_sweep``: the kernels on the card); the
    image's rows are the ``keep_top_k`` best of all classes (a stable sort
    over the classes in order)."""
    bboxes = _x(ins, "BBoxes").to(torch.float32)
    scores = _x(ins, "Scores").to(torch.float32)
    score_thresh = float(attrs.get("score_threshold", 0.0))
    nms_thresh = float(attrs.get("nms_threshold", 0.3))
    nms_top_k = int(attrs.get("nms_top_k", 64))
    keep_top_k = int(attrs.get("keep_top_k", 16))
    background = int(attrs.get("background_label", 0))
    n, m, _ = bboxes.shape
    ncls = scores.shape[1]
    nms_top_k = min(nms_top_k, m)
    classes = [c for c in range(ncls) if c != background]
    if not classes:  # every class was background
        return {"Out": [torch.cat([
            torch.full((n, keep_top_k, 1), -1.0, device=bboxes.device),
            torch.zeros(n, keep_top_k, 5, device=bboxes.device)], dim=-1)]}
    k = len(classes)
    if 0 <= background < ncls:                           # [n, k, m]
        sc = torch.cat([scores[:, :background],
                        scores[:, background + 1:]], dim=1)
    else:
        sc = scores
    sc = torch.where(sc > score_thresh, sc, 0.0)
    flat_s = sc.reshape(n * k, m)
    flat_b = bboxes[:, None].expand(n, k, m, 4).reshape(n * k, m, 4)
    order, sorted_b, sorted_s = _sorted_candidates(flat_b, flat_s, nms_top_k)
    keep = nms_sweep(sorted_b, sorted_s > 0, nms_thresh)
    cs = torch.where(keep, sorted_s, 0.0).reshape(n, k * nms_top_k)
    cb = sorted_b.reshape(n, k * nms_top_k, 4)
    # each candidate's class (class-major; the background's gap skipped)
    cl = torch.arange(k * nms_top_k, device=bboxes.device) // nms_top_k
    if 0 <= background < ncls:
        cl = cl + (cl >= background).to(cl.dtype)
    cl = cl.to(torch.float32)
    top = desc_order(cs)[:, :keep_top_k]
    sel_s = torch.gather(cs, 1, top)
    label = torch.where(sel_s > 0, cl[top], -1.0)
    sel_b = torch.gather(cb, 1, top[..., None].expand(*top.shape, 4))
    row = torch.cat([label[..., None], sel_s[..., None], sel_b], dim=-1)
    return {"Out": [row]}


@register_op("bipartite_match", no_grad=True)
def _bipartite_match(ins, attrs, device):
    """Greedy bipartite matching (reference:
    detection/bipartite_match_op.cc). DistMat [m, n] (rows: ground truth,
    columns: priors) -> per-column matched row [1, n] int32 and its
    distance; a batched [N, m, n] input gives [N, n], every image at
    once. ``per_prediction`` also gives an unmatched column its best row
    where that clears ``dist_threshold``."""
    dist = _x(ins, "DistMat")
    batched = dist.dim() == 3
    d = dist if batched else dist[None]
    col = greedy_bipartite_match(d)
    if attrs.get("match_type") == "per_prediction":
        thresh = float(attrs.get("dist_threshold", 0.5))
        best_d, best_row = torch.max(d, dim=1)
        col = torch.where((col < 0) & (best_d >= thresh),
                          best_row.to(torch.int32), col)
    matched = torch.gather(d, 1, torch.clamp_min(col, 0).to(
        torch.int64)[:, None, :])[:, 0, :]
    matched = torch.where(col >= 0, matched, 0.0)
    return {"ColToRowMatchIndices": [col],
            "ColToRowMatchDist": [matched]}


# --------------------------------------------------------------------------
# RoI ops
# --------------------------------------------------------------------------


def _batch_ids(ins, r, device):
    bid = _x(ins, "BatchId")
    if bid is None:
        return torch.zeros(r, dtype=torch.int64, device=device)
    return bid.to(torch.int64)


# rows a first-level sum of ``scatter_rows`` adds: a key with many rows (a
# pixel under every sample of the zero-box RoIs that pad an FPN level)
# becomes chunks of this many, so no thread sums more than this or its
# key's chunk count in sequence (segment_reduce sums a key in one thread)
_SCATTER_CHUNK = 256


def scatter_rows(index, rows, size):
    """[size, C]: row k the sum of the ``rows`` [N, C] whose ``index``
    [N] is k. A stable sort of the indices, then two sequential sums
    (``torch.segment_reduce``): each key's rows in chunks of
    _SCATTER_CHUNK in order, then each key's chunk sums in order. No
    atomic add, fixed shapes (a captured step may hold it), and the same
    order, so the same bits, on every run and on the CPU and the card."""
    n, dev = index.numel(), index.device
    if n == 0:
        return rows.new_zeros((size,) + tuple(rows.shape[1:]))
    order = torch.sort(index, stable=True).indices
    keys = index[order]
    rank = torch.arange(n, device=dev) - torch.searchsorted(keys, keys)
    chunk = torch.cumsum((rank % _SCATTER_CHUNK == 0).to(torch.int64), 0) - 1
    cap = size + -(-n // _SCATTER_CHUNK)           # at least the chunks
    bounds = torch.searchsorted(chunk, torch.arange(cap + 1, device=dev))
    part = torch.segment_reduce(rows[order], "sum", offsets=bounds, axis=0,
                                unsafe=True)           # [cap, C]
    # each chunk's key; the empty chunks past the last take key ``size``
    starts = bounds[:-1]
    chunk_key = torch.where(starts < n, keys[torch.clamp_max(starts, n - 1)],
                            size)
    key_bounds = torch.searchsorted(chunk_key, torch.arange(size + 1,
                                                            device=dev))
    return torch.segment_reduce(part, "sum", offsets=key_bounds, axis=0,
                                unsafe=True)


class _GatherRows(torch.autograd.Function):
    """``table[index]`` (table [P, C], index [N]) whose backward is
    ``scatter_rows``: a deterministic gradient for gathers whose indices
    repeat many times."""

    @staticmethod
    def forward(ctx, table, index):
        ctx.save_for_backward(index)
        ctx.size = table.shape[0]
        return table[index]

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        return scatter_rows(index, grad.contiguous(), ctx.size), None


def _bilinear(x, bid, yy, xx, h, w):
    """Bilinear samples of x [n, c, h, w] at (yy, xx) [r, S, T] of image
    bid [r] -> [r, S, T, c], corners clipped into the image and weights
    from the clipped floor (the JAX op's arithmetic, extrapolating on the
    border band); X's pixel rows read through ``_GatherRows``."""
    y0 = torch.clamp(torch.floor(yy), 0, h - 1)
    x0 = torch.clamp(torch.floor(xx), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    ly, lx = (yy - y0)[..., None], (xx - x0)[..., None]
    y0i, x0i, y1i, x1i = (t.to(torch.int64) for t in (y0, x0, y1, x1))
    c = x.shape[1]
    table = x.permute(0, 2, 3, 1).reshape(-1, c)        # [n h w, c]
    base = bid[:, None, None] * h

    def at(yi, xi):
        flat = ((base + yi) * w + xi).reshape(-1)
        return _GatherRows.apply(table, flat).reshape(*yi.shape, c)

    return (at(y0i, x0i) * (1 - ly) * (1 - lx)
            + at(y1i, x0i) * ly * (1 - lx)
            + at(y0i, x1i) * (1 - ly) * lx
            + at(y1i, x1i) * ly * lx)


@register_op("roi_align", diff_inputs=("X",))
def _roi_align(ins, attrs, device):
    """Bilinear RoI align (reference: roi_align_op.cc). X [n, c, h, w];
    ROIs [r, 4] (x1, y1, x2, y2); BatchId [r] (all zeros when absent).
    ``sampling_ratio <= 0`` takes a fixed 4 x 4 grid a bin, as the JAX op
    (the reference's adaptive grid has a data-dependent shape). Out
    [r, c, ph, pw]."""
    x = _x(ins)
    rois = _x(ins, "ROIs").to(torch.float32)
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    ratio = int(attrs.get("sampling_ratio", -1))
    n, c, h, w = x.shape
    r = rois.shape[0]
    bid = _batch_ids(ins, r, x.device)
    sr = ratio if ratio > 0 else 4
    rx1, ry1, rx2, ry2 = (rois[:, i] * scale for i in range(4))
    rw = torch.clamp_min(rx2 - rx1, 1.0)
    rh = torch.clamp_min(ry2 - ry1, 1.0)
    bin_w, bin_h = rw / pw, rh / ph
    f32 = torch.float32
    ys = ry1[:, None] + (torch.arange(ph * sr, dtype=f32, device=x.device)
                         + 0.5)[None] * bin_h[:, None] / sr
    xs = rx1[:, None] + (torch.arange(pw * sr, dtype=f32, device=x.device)
                         + 0.5)[None] * bin_w[:, None] / sr
    yy = ys[:, :, None].expand(r, ph * sr, pw * sr)
    xx = xs[:, None, :].expand(r, ph * sr, pw * sr)
    v = _bilinear(x, bid, yy, xx, h, w)                 # [r, S, T, c]
    inside = ((yy >= -1) & (yy <= h) & (xx >= -1) & (xx <= w))[..., None]
    v = torch.where(inside, v, torch.zeros((), dtype=v.dtype,
                                           device=v.device))
    out = v.reshape(r, ph, sr, pw, sr, c).mean(dim=(2, 4))
    return {"Out": [out.permute(0, 3, 1, 2).to(x.dtype)]}


@register_op("roi_pool", diff_inputs=("X",))
def _roi_pool(ins, attrs, device):
    """Quantized max RoI pooling (reference: roi_pool_op.cc): each bin's
    max over its rows, then its columns (the max of a rectangle is
    separable), the image's cells outside every bin at the dtype's
    lowest value."""
    x = _x(ins)
    rois = _x(ins, "ROIs").to(torch.float32)
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c, h, w = x.shape
    r = rois.shape[0]
    bid = _batch_ids(ins, r, x.device)
    rx1, ry1, rx2, ry2 = (torch.round(rois[:, i] * scale) for i in range(4))
    rw = torch.clamp_min(rx2 - rx1 + 1, 1.0)
    rh = torch.clamp_min(ry2 - ry1 + 1, 1.0)

    def band(lo0, extent, bins, size):
        i = torch.arange(bins, device=x.device)
        lo = torch.floor(lo0[:, None] + i[None] * extent[:, None] / bins)
        hi = torch.ceil(lo0[:, None] + (i[None] + 1) * extent[:, None]
                        / bins)
        cells = torch.arange(size, device=x.device)[None, None]
        return (cells >= lo[..., None]) & (
            cells < torch.maximum(hi, lo + 1)[..., None])   # [r, bins, size]

    my, mx = band(ry1, rh, ph, h), band(rx1, rw, pw, w)
    low = torch.finfo(x.dtype).min
    img = x[bid]                                        # [r, c, h, w]
    cols = torch.where(mx[:, None, None], img[:, :, :, None, :], low)
    cols = torch.amax(cols, dim=-1)                     # [r, c, h, pw]
    rows = torch.where(my[:, None, :, :, None], cols[:, :, None], low)
    return {"Out": [torch.amax(rows, dim=3)]}           # [r, c, ph, pw]


@register_op("psroi_pool", diff_inputs=("X",))
def _psroi_pool(ins, attrs, device):
    """Position-sensitive RoI average pooling (reference:
    detection/psroi_pool_op.cc): input channels = output_channels * ph *
    pw; bin (i, j) of output channel k averages input channel k*ph*pw +
    i*pw + j over the bin's cells. ROIs [R, 5] rows (batch_idx, x1, y1,
    x2, y2) or [R, 4] (image 0)."""
    x = _x(ins)
    rois = _x(ins, "ROIs").to(torch.float32)
    out_c = int(attrs["output_channels"])
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c, h, w = x.shape
    if rois.shape[-1] == 5:
        bid = rois[:, 0].to(torch.int64)
        boxes = rois[:, 1:]
    else:
        bid = torch.zeros(rois.shape[0], dtype=torch.int64, device=x.device)
        boxes = rois
    x1 = torch.round(boxes[:, 0]) * scale
    y1 = torch.round(boxes[:, 1]) * scale
    x2 = torch.round(boxes[:, 2] + 1.0) * scale
    y2 = torch.round(boxes[:, 3] + 1.0) * scale
    rw = torch.clamp_min(x2 - x1, 0.1) / pw
    rh = torch.clamp_min(y2 - y1, 0.1) / ph

    def band(start, step, bins, size):
        i = torch.arange(bins, dtype=torch.float32, device=x.device)[None]
        lo = torch.floor(start[:, None] + i * step[:, None])
        hi = torch.ceil(start[:, None] + (i + 1) * step[:, None])
        cells = torch.arange(size, dtype=torch.float32,
                             device=x.device)[None, None]
        return ((cells >= lo[..., None]) & (cells < hi[..., None]))

    my = band(y1, rh, ph, h).to(x.dtype)                # [R, ph, h]
    mx = band(x1, rw, pw, w).to(x.dtype)                # [R, pw, w]
    area = torch.clamp_min(my.sum(-1)[:, :, None] * mx.sum(-1)[:, None, :],
                           1.0)                         # [R, ph, pw]
    img = x[bid][:, :out_c * ph * pw].reshape(-1, out_c, ph, pw, h, w)
    s = torch.einsum("rkijhw,rih,rjw->rkij", img, my, mx)
    return {"Out": [(s / area[:, None]).to(x.dtype)]}


@register_op("roi_perspective_transform", diff_inputs=("X",))
def _roi_perspective_transform(ins, attrs, device):
    """Perspective-warp RoI quads to rectangles (reference:
    detection/roi_perspective_transform_op.cc). X [N, C, H, W]; ROIs
    [R, 9] rows (batch_idx, x1, y1, ..., x4, y4) or [R, 8] (image 0). Out
    [R, C, th, tw] in f32 arithmetic, bilinear-sampled with the source
    point clamped into the image first, zero outside the source bounds
    and right of the quad's estimated width."""
    x_in = _x(ins)
    x = x_in.to(torch.float32)
    rois = _x(ins, "ROIs").to(torch.float32)
    th = int(attrs.get("transformed_height", 1))
    tw = int(attrs.get("transformed_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c, h, w = x.shape
    if rois.shape[-1] == 9:
        bid = rois[:, 0].to(torch.int64)
        quads = rois[:, 1:]
    else:
        bid = torch.zeros(rois.shape[0], dtype=torch.int64, device=x.device)
        quads = rois
    rx, ry = quads[:, 0::2] * scale, quads[:, 1::2] * scale
    x0, x1, x2, x3 = (rx[:, i, None, None] for i in range(4))
    y0, y1, y2, y3 = (ry[:, i, None, None] for i in range(4))
    len1 = torch.sqrt((x0 - x1) ** 2 + (y0 - y1) ** 2)
    len2 = torch.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
    len3 = torch.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
    len4 = torch.sqrt((x3 - x0) ** 2 + (y3 - y0) ** 2)
    est_h = (len2 + len4) / 2.0
    est_w = (len1 + len3) / 2.0
    nh = float(th)
    nw = torch.clamp_max(torch.round(
        est_w * (nh - 1) / torch.clamp_min(est_h, 1e-6)) + 1.0, float(tw))
    dx1, dx2, dx3 = x1 - x2, x3 - x2, x0 - x1 + x2 - x3
    dy1, dy2, dy3 = y1 - y2, y3 - y2, y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1 + 1e-5
    nw1 = torch.clamp_min(nw - 1.0, 1e-5)
    nh1 = max(nh - 1.0, 1e-5)
    m6 = (dx3 * dy2 - dx2 * dy3) / den / nw1
    m7 = (dx1 * dy3 - dx3 * dy1) / den / nh1
    m3 = (y1 - y0 + m6 * nw1 * y1) / nw1
    m4 = (y3 - y0 + m7 * nh1 * y3) / nh1
    m0 = (x1 - x0 + m6 * nw1 * x1) / nw1
    m1 = (x3 - x0 + m7 * nh1 * x3) / nh1
    ii = torch.arange(th, dtype=torch.float32, device=x.device)[:, None]
    jj = torch.arange(tw, dtype=torch.float32, device=x.device)[None, :]
    denom = m6 * jj + m7 * ii + 1.0
    sx = (m0 * jj + m1 * ii + x0) / denom                # [R, th, tw]
    sy = (m3 * jj + m4 * ii + y0) / denom
    inside = ((sx >= -0.5) & (sx <= w - 0.5) & (sy >= -0.5)
              & (sy <= h - 0.5) & (jj < nw))
    sxc = torch.clamp(sx, 0.0, w - 1.0)
    syc = torch.clamp(sy, 0.0, h - 1.0)
    v = _bilinear(x, bid, syc, sxc, h, w)               # [R, th, tw, C]
    v = torch.where(inside[..., None], v, 0.0)
    return {"Out": [v.permute(0, 3, 1, 2).to(x_in.dtype)]}


# --------------------------------------------------------------------------
# detection decode / priors
# --------------------------------------------------------------------------


@register_op("yolo_box", no_grad=True)
def _yolo_box(ins, attrs, device):
    """Decode YOLOv3 head output to boxes and scores (reference:
    detection/yolo_box_op.cc). X [n, an*(5+cls), h, w]; ImgSize [n, 2]
    (h, w). Boxes [n, an*h*w, 4] clipped to the image, Scores
    [n, an*h*w, cls] (0 where the objectness is at or below
    ``conf_thresh``)."""
    x = _x(ins)
    img_size = _x(ins, "ImgSize")
    anchors = attrs["anchors"]                       # flat [ax, ay, ...]
    class_num = int(attrs["class_num"])
    conf_thresh = float(attrs.get("conf_thresh", 0.01))
    downsample = int(attrs.get("downsample_ratio", 32))
    n, _, h, w = x.shape
    an = len(anchors) // 2
    x = x.reshape(n, an, 5 + class_num, h, w)
    f32 = torch.float32
    grid_x = torch.arange(w, dtype=f32, device=x.device)
    grid_y = torch.arange(h, dtype=f32, device=x.device)
    input_h, input_w = downsample * h, downsample * w
    aw = _const(anchors[0::2], f32, x.device)[None, :, None, None]
    ah = _const(anchors[1::2], f32, x.device)[None, :, None, None]
    bx = (torch.sigmoid(x[:, :, 0]) + grid_x) / w
    by = (torch.sigmoid(x[:, :, 1]) + grid_y[:, None]) / h
    bw = torch.exp(x[:, :, 2]) * aw / input_w
    bh = torch.exp(x[:, :, 3]) * ah / input_h
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    probs = torch.where((conf > conf_thresh)[:, :, None], probs, 0.0)
    img_h = img_size[:, 0].to(f32)[:, None, None, None]
    img_w = img_size[:, 1].to(f32)[:, None, None, None]

    def clip(v, hi):
        return torch.minimum(torch.clamp_min(v, 0.0), hi - 1.0)

    x1 = clip((bx - bw / 2) * img_w, img_w)
    y1 = clip((by - bh / 2) * img_h, img_h)
    x2 = clip((bx + bw / 2) * img_w, img_w)
    y2 = clip((by + bh / 2) * img_h, img_h)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(n, -1, 4)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
    return {"Boxes": [boxes], "Scores": [scores]}


@register_op("box_clip", no_grad=True)
def _box_clip(ins, attrs, device):
    """Clip boxes to image bounds (reference: detection/box_clip_op.cc).
    Input [n, ..., 4], ImInfo [n, 3] (h, w, scale): x in [0, w / scale -
    1], y in [0, h / scale - 1]."""
    boxes = _x(ins, "Input")
    im_info = _x(ins, "ImInfo")
    tail = (1,) * (boxes.dim() - 2)
    h = (im_info[:, 0] / im_info[:, 2] - 1.0).reshape((-1,) + tail)
    w = (im_info[:, 1] / im_info[:, 2] - 1.0).reshape((-1,) + tail)

    def clip(v, hi):
        return torch.minimum(torch.clamp_min(v, 0), hi)

    return {"Output": [torch.stack([
        clip(boxes[..., 0], w), clip(boxes[..., 1], h),
        clip(boxes[..., 2], w), clip(boxes[..., 3], h)], dim=-1)]}


@register_op("density_prior_box", no_grad=True)
def _density_prior_box(ins, attrs, device):
    """Density prior boxes (reference: detection/density_prior_box_op.cc).
    Input [n, c, h, w] feature map, Image [n, c, ih, iw]. Boxes [h, w,
    num, 4] normalized and clipped to [0, 1], Variances alike; computed
    in f64 and returned in f32 (as ``prior_box``)."""
    feat = _x(ins, "Input")
    img = _x(ins, "Image")
    fixed_sizes = attrs.get("fixed_sizes", [])
    fixed_ratios = attrs.get("fixed_ratios", [1.0])
    densities = attrs.get("densities", [1])
    step_w = float(attrs.get("step_w", 0.0))
    step_h = float(attrs.get("step_h", 0.0))
    offset = float(attrs.get("offset", 0.5))
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    sw = step_w or iw / w
    sh = step_h or ih / h
    f64, dev = torch.float64, feat.device
    boxes = []
    for size, density in zip(fixed_sizes, densities):
        for ratio in fixed_ratios:
            bw = size * (ratio ** 0.5)
            bh = size / (ratio ** 0.5)
            shift = size / density
            for dy in range(density):
                for dx in range(density):
                    cx_off = (offset - 0.5 + (dx + 0.5) * shift / sw
                              if density > 1 else offset)
                    cy_off = (offset - 0.5 + (dy + 0.5) * shift / sh
                              if density > 1 else offset)
                    cx = (torch.arange(w, dtype=f64, device=dev)
                          + cx_off) * sw
                    cy = (torch.arange(h, dtype=f64, device=dev)
                          + cy_off) * sh
                    cxg = cx[None, :].expand(h, w)
                    cyg = cy[:, None].expand(h, w)
                    boxes.append(torch.stack([
                        (cxg - bw / 2) / iw, (cyg - bh / 2) / ih,
                        (cxg + bw / 2) / iw, (cyg + bh / 2) / ih], dim=-1))
    num = len(boxes)
    out = torch.clamp(torch.stack(boxes, dim=2), 0.0, 1.0)
    var = _const(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                 torch.float32, dev).expand(h, w, num, 4)
    return {"Boxes": [out.to(torch.float32)], "Variances": [var]}


# --------------------------------------------------------------------------
# 3-D conv / pool, pooling variants
# --------------------------------------------------------------------------


@register_op("conv3d", diff_inputs=("Input", "Filter"))
def _conv3d(ins, attrs, device):
    """3-D convolution, NCDHW input, [C_out, C_in / groups, kd, kh, kw]
    filter (conv_op.cc)."""
    x, w = _x(ins, "Input"), _x(ins, "Filter")
    return {"Output": [F.conv3d(
        x, w, None, stride=_tuple(attrs.get("strides", [1, 1, 1]), 3),
        padding=_tuple(attrs.get("paddings", [0, 0, 0]), 3),
        dilation=_tuple(attrs.get("dilations", [1, 1, 1]), 3),
        groups=int(attrs.get("groups", 1)))]}


@register_op("conv3d_transpose", diff_inputs=("Input", "Filter"))
def _conv3d_transpose(ins, attrs, device):
    """The gradient of conv3d as a forward op (conv_transpose_op.cc):
    filter [C_in, C_out / groups, kd, kh, kw], out D = (D - 1) s - 2p +
    d (k - 1) + 1."""
    x, w = _x(ins, "Input"), _x(ins, "Filter")
    return {"Output": [F.conv_transpose3d(
        x, w, None, stride=_tuple(attrs.get("strides", [1, 1, 1]), 3),
        padding=_tuple(attrs.get("paddings", [0, 0, 0]), 3),
        groups=int(attrs.get("groups", 1)),
        dilation=_tuple(attrs.get("dilations", [1, 1, 1]), 3))]}


@register_op("depthwise_conv2d_transpose", diff_inputs=("Input", "Filter"))
def _depthwise_conv2d_transpose(ins, attrs, device):
    """conv2d_transpose whose groups default to the input's channels
    (reference: conv_transpose_op.cc registration)."""
    a = dict(attrs)
    a.setdefault("groups", int(_x(ins, "Input").shape[1]))
    return get_op_def("conv2d_transpose").compute(ins, a, device)


def _pool_geometry(x, attrs, spatial):
    """(ksize, strides, paddings) of a pooling op's attrs, the global
    window where ``global_pooling``."""
    if attrs.get("global_pooling", False):
        return tuple(x.shape[2:]), tuple(x.shape[2:]), (0,) * spatial
    ksize = _tuple(attrs.get("ksize", [2] * spatial), spatial)
    strides = _tuple(attrs.get("strides", ksize), spatial)
    pads = _tuple(attrs.get("paddings", [0] * spatial), spatial)
    return ksize, strides, pads


def _pool_nd(x, attrs, spatial):
    """Max or average pooling over the trailing ``spatial`` dims, padding
    ``p`` on both sides of each (any width: the input is padded first),
    as the JAX op's reduce_window: max pads -inf; average divides the sum
    by the count of real cells when ``exclusive`` (the default), else by
    the window's size."""
    ksize, strides, pads = _pool_geometry(x, attrs, spatial)
    pad = [p for q in reversed(pads) for p in (q, q)]
    maxp = (F.max_pool2d, F.max_pool3d)[spatial - 2]
    avgp = (F.avg_pool2d, F.avg_pool3d)[spatial - 2]
    if attrs.get("pooling_type", "max") == "max":
        return maxp(F.pad(x, pad, value=-math.inf), ksize, strides)
    window = math.prod(ksize)
    s = avgp(F.pad(x, pad), ksize, strides) * window
    if not attrs.get("exclusive", True):
        return s / float(window)
    cnt = None
    for d in range(spatial):
        size, k, st, p = x.shape[2 + d], ksize[d], strides[d], pads[d]
        o = s.shape[2 + d]
        lo = torch.arange(o, device=x.device) * st - p
        c = (torch.clamp_max(lo + k, size) - torch.clamp_min(lo, 0))
        c = c.to(x.dtype).reshape((o,) + (1,) * (spatial - 1 - d))
        cnt = c if cnt is None else cnt * c
    return s / cnt


@register_op("pool3d", diff_inputs=("X",))
def _pool3d(ins, attrs, device):
    return {"Out": [_pool_nd(_x(ins), attrs, 3)]}


def _max_pool_with_index(x, attrs, spatial):
    """(Out, Mask) of max pooling with flat argmax indices over the
    trailing dims (reference: max_pool_with_index_op.cc). The window's
    positions are clipped into the input, the first maximum wins, and
    Out is X read at Mask by advanced indexing (a deterministic
    backward). The 2-D op takes its window from ``ksize`` even under
    ``global_pooling`` (whose Out is the global max), as the JAX op."""
    n, c = x.shape[:2]
    dims = tuple(x.shape[2:])
    if spatial == 3:
        ksize, strides, pads = _pool_geometry(x, attrs, 3)
    else:
        ksize = _tuple(attrs.get("ksize", [2, 2]), 2)
        strides = _tuple(attrs.get("strides", ksize), 2)
        pads = _tuple(attrs.get("paddings", [0, 0]), 2)
    if spatial == 2 and attrs.get("global_pooling", False):
        outs = (1, 1)
    else:
        outs = tuple((dims[d] + 2 * pads[d] - ksize[d]) // strides[d] + 1
                     for d in range(spatial))
    # the window's clipped positions along each dim: [o_d, k_d]
    pos = [torch.clamp(torch.arange(outs[d], device=x.device)[:, None]
                       * strides[d] - pads[d]
                       + torch.arange(ksize[d], device=x.device)[None],
                       0, dims[d] - 1) for d in range(spatial)]
    # flat input index of every (cell, window position): [*outs, *ksize]
    flat = torch.zeros((), dtype=torch.int64, device=x.device)
    for d in range(spatial):
        shape = [1] * (2 * spatial)
        shape[d], shape[spatial + d] = outs[d], ksize[d]
        flat = flat * dims[d] + pos[d].reshape(shape)
    flat = flat.reshape(*outs, math.prod(ksize))
    xf = x.reshape(n * c, -1)
    rows = torch.arange(n * c, device=x.device)[:, None]
    patch = xf.detach()[rows, flat.reshape(1, -1)].reshape(
        n * c, *flat.shape)
    arg = torch.argmax(patch, dim=-1, keepdim=True)
    idx = torch.gather(flat.expand(n * c, *flat.shape), -1, arg)[..., 0]
    out = xf[rows, idx.reshape(n * c, -1)].reshape(n, c, *outs)
    if spatial == 2 and attrs.get("global_pooling", False):
        out = torch.amax(x, dim=(2, 3), keepdim=True)
    return out, idx.reshape(n, c, *outs).to(torch.int32)


@register_op("max_pool2d_with_index", diff_inputs=("X",))
def _max_pool2d_with_index(ins, attrs, device):
    """Max pool emitting flat argmax indices (Mask, int32), consumed by
    unpool."""
    out, idx = _max_pool_with_index(_x(ins), attrs, 2)
    return {"Out": [out], "Mask": [idx]}


@register_op("max_pool3d_with_index", diff_inputs=("X",))
def _max_pool3d_with_index(ins, attrs, device):
    """3-D max pool emitting flat argmax indices (Mask, int32)."""
    out, idx = _max_pool_with_index(_x(ins), attrs, 3)
    return {"Out": [out], "Mask": [idx]}


@register_op("unpool", diff_inputs=("X",))
def _unpool(ins, attrs, device):
    """Max unpooling via saved indices (reference: unpool_op.cc): each
    value added at its flat index of the [unpooled_height,
    unpooled_width] plane (a sorted accumulation: the same bits on every
    run)."""
    x, idx = _x(ins), _x(ins, "Indices")
    out_h, out_w = int(attrs["unpooled_height"]), int(attrs["unpooled_width"])
    n, c = x.shape[:2]
    rows = torch.arange(n * c, device=x.device)[:, None].expand(
        n * c, idx[0, 0].numel())
    flat = torch.zeros(n * c, out_h * out_w, dtype=x.dtype, device=x.device)
    out = flat.index_put((rows, idx.reshape(n * c, -1).to(torch.int64)),
                         x.reshape(n * c, -1), accumulate=True)
    return {"Out": [out.reshape(n, c, out_h, out_w)]}


@register_op("spp", diff_inputs=("X",))
def _spp(ins, attrs, device):
    """Spatial pyramid pooling (reference: spp_op.cc): ``pyramid_height``
    levels of 1, 2, 4, ... bins a side, each level's map flattened and
    all concatenated."""
    x = _x(ins)
    levels = int(attrs.get("pyramid_height", 3))
    ptype = attrs.get("pooling_type", "max")
    n, c, h, w = x.shape
    outs = []
    for lvl in range(levels):
        bins = 2 ** lvl
        kh, kw = -(-h // bins), -(-w // bins)  # ceil
        ph, pw = kh * bins - h, kw * bins - w
        lvl_attrs = {"ksize": [kh, kw], "strides": [kh, kw],
                     "paddings": [(ph + 1) // 2, (pw + 1) // 2],
                     "pooling_type": ptype, "exclusive": False}
        outs.append(_pool_nd(x, lvl_attrs, 2).reshape(n, -1))
    return {"Out": [torch.cat(outs, dim=1)]}


@register_op("lrn", diff_inputs=("X",))
def _lrn(ins, attrs, device):
    """Local response normalization across channels (reference:
    lrn_op.cc): MidOut = k + alpha * (sum of the n nearest channels'
    squares), Out = X / MidOut ** beta."""
    x = _x(ins)
    nsize = int(attrs.get("n", 5))
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    k = float(attrs.get("k", 1.0))
    half = nsize // 2
    pad = F.pad(x * x, (0, 0, 0, 0, half, half))
    c = x.shape[1]
    acc = 0
    for i in range(nsize):
        acc = acc + pad[:, i:i + c]
    mid = k + alpha * acc
    return {"Out": [x / torch.pow(mid, beta)], "MidOut": [mid]}


def _adaptive_pool(x, out_sizes, ptype, spatial):
    """Exact adaptive pooling (reference: pool_op.cc adaptive=True): cell
    i of a dim of length L into o cells covers [floor(i L / o), ceil((i +
    1) L / o)), one dim at a time."""
    out = x
    for d in range(spatial):
        size, o = x.shape[x.dim() - spatial + d], int(out_sizes[d])
        axis = x.dim() - spatial + d
        cells = []
        for i in range(o):
            lo, hi = (i * size) // o, -(-((i + 1) * size) // o)
            seg = out.narrow(axis, lo, hi - lo)
            cells.append(torch.amax(seg, dim=axis, keepdim=True)
                         if ptype == "max"
                         else torch.mean(seg, dim=axis, keepdim=True))
        out = torch.cat(cells, dim=axis)
    return out


@register_op("adaptive_pool2d", diff_inputs=("X",))
def _adaptive_pool2d(ins, attrs, device):
    return {"Out": [_adaptive_pool(
        _x(ins), attrs["ksize"], attrs.get("pooling_type", "max"), 2)]}


@register_op("adaptive_pool3d", diff_inputs=("X",))
def _adaptive_pool3d(ins, attrs, device):
    return {"Out": [_adaptive_pool(
        _x(ins), attrs["ksize"], attrs.get("pooling_type", "max"), 3)]}


# --------------------------------------------------------------------------
# spatial transforms
# --------------------------------------------------------------------------


@register_op("affine_grid", diff_inputs=("Theta",))
def _affine_grid(ins, attrs, device):
    """2-D affine sampling grid (reference: affine_grid_op.cc). Theta
    [n, 2, 3] -> Output [n, h, w, 2], normalized coordinates; (h, w) from
    ``output_shape`` or a concrete OutputShape tensor."""
    theta = _x(ins, "Theta")
    shape = attrs.get("output_shape")
    if shape:
        h, w = int(shape[2]), int(shape[3])
    else:
        out_shape = _x(ins, "OutputShape")
        if out_shape.device.type == "meta":
            raise ValueError(
                "affine_grid: a tensor OutputShape is data-dependent and "
                "cannot set a static shape; pass output_shape as a Python "
                "list instead")
        h, w = int(out_shape[2]), int(out_shape[3])
    dt, dev = theta.dtype, theta.device
    ys = torch.linspace(-1.0, 1.0, h, dtype=dt, device=dev)
    xs = torch.linspace(-1.0, 1.0, w, dtype=dt, device=dev)
    grid = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w),
                        torch.ones(h, w, dtype=dt, device=dev)], dim=-1)
    return {"Output": [torch.einsum("hwk,njk->nhwj", grid, theta)]}


@register_op("random_crop", needs_rng=True, no_grad=True)
def _random_crop(ins, attrs, device, seed=None):
    """Random fixed-size crop of the trailing dims to ``shape``
    (reference: random_crop_op.cc). Dim i's start is drawn on the device
    from the op seed (``rng.op_words``: word i * (limit_i + 1) >> 32), so
    the CPU and the card crop alike and a captured step draws afresh;
    the bits differ from the JAX op's ``jax.random``."""
    x = _x(ins)
    shape = [int(s) for s in attrs["shape"]]
    lead = x.dim() - len(shape)
    words = rng.op_words(0 if seed is None else seed, (len(shape),),
                         x.device)
    out = x
    for i, s in enumerate(shape):
        limit = max(x.shape[lead + i] - s, 0)
        start = (words[i] * (limit + 1)) >> 32
        out = out.index_select(lead + i, start + torch.arange(
            s, device=x.device))
    return {"Out": [out]}


@register_op("polygon_box_transform", no_grad=True)
def _polygon_box_transform(ins, attrs, device):
    """EAST-style quad geometry decode (reference:
    detection/polygon_box_transform_op.cc): even channels are x offsets,
    odd channels y offsets; out = 4 * coordinate - in on the grid."""
    x = _x(ins, "Input")
    n, c, h, w = x.shape
    xs = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None]
    ys = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :, None]
    even = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None, None]
    return {"Output": [torch.where(even, 4.0 * xs - x, 4.0 * ys - x)]}


@register_op("similarity_focus", no_grad=True)
def _similarity_focus(ins, attrs, device):
    """Similarity-focus mask (reference: similarity_focus_op.h): for each
    selected index along ``axis``, greedily pick the largest remaining
    value of the other two dims, excluding its row and column after, and
    set 1 at each picked (row, column) across the whole focus axis; the
    masks of several indexes union. Every plane of the batch steps at
    once (no host read)."""
    x_in = _x(ins)
    x = x_in.to(torch.float32)
    axis = int(attrs.get("axis", 1))
    indexes = [int(i) for i in attrs.get("indexes", [0])]
    if x.dim() != 4 or axis not in (1, 2, 3):
        raise ValueError("similarity_focus expects a 4-D input, axis 1-3")
    perm = [0, axis] + [d for d in (1, 2, 3) if d != axis]
    inv = [perm.index(d) for d in range(4)]
    xt = x.permute(perm)                             # [N, C_axis, D2, D3]
    n, _, d2, d3 = xt.shape
    rows = torch.arange(d2, device=x.device)
    cols = torch.arange(d3, device=x.device)
    mask = torch.zeros(n, d2, d3, dtype=torch.float32, device=x.device)
    for idx in indexes:
        vals = xt[:, idx].clone()
        picked = torch.zeros(n, d2, d3, dtype=torch.bool, device=x.device)
        for _ in range(min(d2, d3)):
            flat = torch.argmax(vals.reshape(n, -1), dim=1)
            r, c = flat // d3, flat % d3
            ok = (vals.reshape(n, -1).gather(1, flat[:, None])[:, 0]
                  > -math.inf)[:, None, None]
            hit_r = (rows[None] == r[:, None])[:, :, None]
            hit_c = (cols[None] == c[:, None])[:, None, :]
            picked = picked | (ok & hit_r & hit_c)
            vals = torch.where(ok & (hit_r | hit_c), -math.inf, vals)
        mask = mask + picked.to(torch.float32)
    mask = torch.clamp_max(mask, 1.0)
    out = mask[:, None].expand(xt.shape)
    return {"Out": [out.permute(inv).to(x_in.dtype)]}

