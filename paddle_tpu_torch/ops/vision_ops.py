"""Vision ops of the JAX package's ops/vision_ops.py that the ported
detectors run: the static-shape multiclass NMS (reference:
detection/multiclass_nms_op.cc), fixed-capacity outputs padded with -1
labels instead of the reference's variable-length LoD results, and the
``bipartite_match`` op behind the layer of that name. The other ops of
that file are not ported (ROADMAP.md)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.box_util import greedy_bipartite_match


def _x(ins, slot="X", i=0):
    v = ins.get(slot)
    return v[i] if v else None


def desc_order(x):
    """The indices that sort the last dim of ``x`` largest first, equal
    values in index order: ``jnp.argsort(-x)`` (a stable sort). -0.0 is
    made +0.0 first, as JAX's sort does, because the card's radix sort
    would put -0.0 before +0.0."""
    return torch.sort(-x + 0.0, dim=-1, stable=True).indices


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


def _nms_keep(boxes, scores, iou_threshold, top_k):
    """Greedy NMS with static shapes over a batch of candidate sets:
    boxes [B, m, 4], scores [B, m] -> (order [B, top_k], keep [B, top_k]),
    the keep mask over the top_k score-sorted candidates (a stable sort:
    equal scores keep their index order, as ``jnp.argsort``). Candidate i
    is dropped if it overlaps an earlier kept one; the sweep over i is
    sequential, every set of the batch at once."""
    order = desc_order(scores)[..., :top_k]
    b = torch.gather(boxes, 1, order[..., None].expand(*order.shape, 4))
    s = torch.gather(scores, 1, order)
    over_t = _iou_matrix(b) > iou_threshold              # [B, m, m]
    m = s.shape[-1]
    earlier = torch.ones(m, m, dtype=torch.bool,
                         device=s.device).tril(diagonal=-1)
    over_t = over_t & earlier
    keep = s > 0
    for i in range(m):
        hit = (over_t[:, i, :] & keep).any(dim=-1)
        keep[:, i] = keep[:, i] & ~hit
    return order, keep


@register_op("multiclass_nms", no_grad=True)
def _multiclass_nms(ins, attrs, device):
    """BBoxes [n, m, 4]; Scores [n, cls, m]. Out [n, keep_top_k, 6] rows
    (label, score, x1, y1, x2, y2), label -1 padding. Each class of each
    image keeps its NMS survivors among its top ``nms_top_k`` scores above
    ``score_threshold``; the image's rows are the ``keep_top_k`` best of
    all classes (a stable sort over the classes in order)."""
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
    order, keep = _nms_keep(flat_b, flat_s, nms_thresh, nms_top_k)
    kept_s = torch.where(keep, torch.gather(flat_s, 1, order), 0.0)
    cs = kept_s.reshape(n, k * nms_top_k)
    cb = torch.gather(flat_b, 1, order[..., None].expand(
        n * k, nms_top_k, 4)).reshape(n, k * nms_top_k, 4)
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
