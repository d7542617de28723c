"""Detection ops of the JAX package's ops/detection_ops.py: target
assignment, hard-negative mining and the fused SSD loss, the RPN's anchor
labels and proposals, the second stage's RoI sampling and FPN routing,
the YOLOv3 loss, mAP and the Mask R-CNN mask targets (reference kernels:
paddle/fluid/operators/detection/{target_assign_op.cc,
mine_hard_examples_op.cc, yolov3_loss_op.h, rpn_target_assign_op.cc,
generate_proposals_op.cc, generate_proposal_labels_op.cc,
distribute_fpn_proposals_op.cc, collect_fpn_proposals_op.cc,
box_decoder_and_assign_op.cc, detection_map_op.cc,
generate_mask_labels_op.cc}, layers/detection.py ssd_loss).

Dense-padded design, as in the JAX package: where the reference passes
variable-length LoD tensors, these ops take fixed-capacity tensors padded
with sentinel rows (gt boxes of zero area, -1 indices) and return
fixed-capacity outputs plus weights and masks. Shapes are static and no
op reads a value on the host, so a captured step holds them. The ops
that sample (``rpn_target_assign``, ``generate_proposal_labels``) draw on
the device from the op seed (core/rng.py), as the other random ops; their
bits differ from the JAX package's ``jax.random``. ``generate_proposals``
runs the NMS sweep's kernels on the card (vision_ops.nms_sweep).
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.box_util import (
    greedy_bipartite_match,
    iou_xyxy,
    xyxy_area,
)
from paddle_tpu_torch.ops.tensor_ops import _const
from paddle_tpu_torch.ops.vision_ops import desc_order, nms_sweep

_NEG = -1e9


def _x(ins, slot="X", i=0):
    v = ins.get(slot)
    return v[i] if v else None


def _take_rows(x, idx):
    """x [N, G, K], idx [N, P] -> x[n, idx[n, p], :] as [N, P, K]."""
    return torch.gather(x, 1, idx.to(torch.int64)[..., None].expand(
        *idx.shape, x.shape[-1]))


def _rank_of(order):
    """The inverse permutation of each row of ``order`` [N, P]: rank[n,
    order[n, j]] = j (a scatter of distinct indices)."""
    n, p = order.shape
    ranks = torch.arange(p, dtype=torch.int32, device=order.device)
    return torch.empty(n, p, dtype=torch.int32,
                       device=order.device).scatter_(
        1, order, ranks.expand(n, p))


@register_op("target_assign", no_grad=True)
def _target_assign(ins, attrs, device):
    """Gather targets by match indices (reference: target_assign_op.cc).

    X [N, G, K] per-image entities, MatchIndices [N, P] int32 (-1 =
    unmatched), optional NegIndices [N, S] int32 (-1 padding). Out
    [N, P, K], OutWeight [N, P, 1]."""
    x = _x(ins)
    match = _x(ins, "MatchIndices")
    neg = _x(ins, "NegIndices")
    mismatch = attrs.get("mismatch_value", 0.0)
    out = _take_rows(x, torch.clamp_min(match, 0))
    matched = (match >= 0)[..., None]
    out = torch.where(matched, out, mismatch)
    weight = matched.to(x.dtype)
    if neg is not None:
        # the columns the negative list names (-1 padding names none)
        hit = torch.zeros(match.shape, dtype=torch.int32,
                          device=match.device).scatter_reduce(
            1, torch.clamp_min(neg, 0).to(torch.int64),
            (neg >= 0).to(torch.int32), reduce="amax")
        neg_hit = (hit > 0)[..., None]
        out = torch.where(neg_hit & ~matched, mismatch, out)
        weight = torch.maximum(weight, neg_hit.to(x.dtype))
    return {"Out": [out], "OutWeight": [weight]}


@register_op("mine_hard_examples", no_grad=True)
def _mine_hard_examples(ins, attrs, device):
    """Hard-negative mining (reference: mine_hard_examples_op.cc): per
    image, rank unmatched priors by loss (hardest first, a stable sort)
    and keep the top ``neg_pos_ratio * num_pos`` (``sample_size`` instead
    in hard_example mining). NegIndices [N, P] int32, -1 padded;
    UpdatedMatchIndices is MatchIndices."""
    cls_loss = _x(ins, "ClsLoss")
    loc_loss = _x(ins, "LocLoss")
    match = _x(ins, "MatchIndices")
    ratio = float(attrs.get("neg_pos_ratio", 3.0))
    overlap = attrs.get("neg_dist_threshold", 0.5)
    sample_size = int(attrs.get("sample_size", 0))
    dist = _x(ins, "MatchDist")
    mining_type = attrs.get("mining_type", "max_negative")
    loss = cls_loss.to(torch.float32)
    if loc_loss is not None and mining_type == "hard_example":
        loss = loss + loc_loss.to(torch.float32)
    p = match.shape[1]
    is_neg = match < 0
    if dist is not None:
        is_neg = is_neg & (dist < overlap)
    num_pos = torch.sum(match >= 0, dim=1)
    num_neg = torch.sum(is_neg, dim=1)
    if mining_type == "hard_example" and sample_size > 0:
        want = torch.clamp_max(num_neg, sample_size)
    else:
        want = torch.minimum((num_pos * ratio).to(torch.int32), num_neg)
    order = desc_order(torch.where(is_neg, loss, _NEG))
    rank = torch.arange(p, device=match.device)[None, :]
    neg_idx = torch.where(rank < want[:, None], order.to(torch.int32), -1)
    return {"NegIndices": [neg_idx.to(torch.int32)],
            "UpdatedMatchIndices": [match]}


@register_op("ssd_loss", diff_inputs=("Location", "Confidence"))
def _ssd_loss(ins, attrs, device):
    """Fused SSD multibox loss (reference: layers/detection.py ssd_loss:
    bipartite match + hard-negative mining + target assign + smooth-l1 +
    softmax CE) as one dense computation, the targets and masks outside
    the gradient. Location [N, P, 4], Confidence [N, P, C], GtBox [N, G, 4]
    xyxy (zero-area rows pad), GtLabel [N, G] int, PriorBox [P, 4],
    PriorBoxVar [P, 4] optional. Loss [N, 1] in Location's dtype."""
    loc = _x(ins, "Location")
    conf = _x(ins, "Confidence")
    gt_box = _x(ins, "GtBox").to(torch.float32)
    gt_label = _x(ins, "GtLabel")
    prior = _x(ins, "PriorBox").to(torch.float32)
    pvar = _x(ins, "PriorBoxVar")
    bg = int(attrs.get("background_label", 0))
    overlap_t = float(attrs.get("overlap_threshold", 0.5))
    neg_ratio = float(attrs.get("neg_pos_ratio", 3.0))
    neg_overlap = float(attrs.get("neg_overlap", 0.5))
    loc_w = float(attrs.get("loc_loss_weight", 1.0))
    conf_w = float(attrs.get("conf_loss_weight", 1.0))
    match_type = attrs.get("match_type", "per_prediction")
    normalize = bool(attrs.get("normalize", True))

    gt_valid = xyxy_area(gt_box) > 0                           # [N, G]
    iou = iou_xyxy(gt_box, prior[None])                        # [N, G, P]
    iou = torch.where(gt_valid[..., None], iou, -1.0)
    match = greedy_bipartite_match(iou)                        # [N, P]
    if match_type == "per_prediction":
        # unmatched priors also take their best gt at or above the
        # threshold (>=, as the standalone bipartite_match op)
        best_d, best = torch.max(iou, dim=1)
        match = torch.where((match < 0) & (best_d >= overlap_t),
                            best.to(torch.int32), match)
    matched = match >= 0
    safe = torch.clamp_min(match, 0).to(torch.int64)
    match_dist = torch.where(
        matched, torch.gather(iou, 1, safe[:, None, :])[:, 0, :], 0.0)
    tlabel = torch.where(
        matched, torch.gather(gt_label.to(torch.int64), 1, safe), bg)

    conf_f = conf.to(torch.float32)
    lse = torch.logsumexp(conf_f, dim=-1)
    pick = torch.gather(conf_f, -1, tlabel[..., None])[..., 0]
    conf_ce = lse - pick                                       # [N, P]

    # hard-negative mining on the pre-assignment CE (max_negative)
    is_neg = ~matched & (match_dist < neg_overlap)
    num_pos = torch.sum(matched, dim=1)
    want = torch.minimum((num_pos * neg_ratio).to(torch.int32),
                         torch.sum(is_neg, dim=1).to(torch.int32))[:, None]
    masked_loss = torch.where(is_neg, conf_ce.detach(), _NEG)
    rank = _rank_of(desc_order(masked_loss))
    neg_sel = is_neg & (rank < want)

    # regression targets: the matched gt encoded against its prior
    mg = _take_rows(gt_box, safe)                              # [N, P, 4]
    aw = prior[:, 2] - prior[:, 0]
    ah = prior[:, 3] - prior[:, 1]
    ax = prior[:, 0] + aw * 0.5
    ay = prior[:, 1] + ah * 0.5
    gw = torch.clamp_min(mg[..., 2] - mg[..., 0], 1e-6)
    gh = torch.clamp_min(mg[..., 3] - mg[..., 1], 1e-6)
    gx = mg[..., 0] + gw * 0.5
    gy = mg[..., 1] + gh * 0.5
    tgt = torch.stack([(gx - ax) / aw, (gy - ay) / ah,
                       torch.log(gw / aw), torch.log(gh / ah)], dim=-1)
    if pvar is not None:
        tgt = tgt / pvar.to(torch.float32)[None]
    tgt = torch.where(matched[..., None], tgt, 0.0).detach()

    diff = loc.to(torch.float32) - tgt
    ad = torch.abs(diff)
    sl1 = torch.sum(torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5), dim=-1)
    loc_loss = torch.where(matched, sl1, 0.0)
    conf_loss = torch.where(matched | neg_sel, conf_ce, 0.0)
    loss = conf_w * conf_loss + loc_w * loc_loss               # [N, P]
    loss = torch.sum(loss, dim=1, keepdim=True)
    if normalize:
        loss = loss / torch.clamp_min(torch.sum(matched.to(torch.float32)),
                                      1.0)
    return {"Loss": [loss.to(loc.dtype)]}


# --------------------------------------------------------------------------
# the RPN and the second stage
# --------------------------------------------------------------------------

# kBBoxClipDefault = log(1000 / 16): keeps exp() finite for wild deltas
_BBOX_CLIP = math.log(1000.0 / 16.0)


def _decode_anchor(anchors, deltas, variances=None):
    """Decode deltas against xyxy anchors with the +1 pixel convention
    (reference generate_proposals_op.cc BoxCoder), per-anchor variances
    where given."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    ax = anchors[..., 0] + aw * 0.5
    ay = anchors[..., 1] + ah * 0.5
    dx, dy, dw, dh = deltas.unbind(-1)
    if variances is not None:
        dx = dx * variances[..., 0]
        dy = dy * variances[..., 1]
        dw = dw * variances[..., 2]
        dh = dh * variances[..., 3]
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(torch.clamp_max(dw, _BBOX_CLIP)) * aw
    h = torch.exp(torch.clamp_max(dh, _BBOX_CLIP)) * ah
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5 - 1.0, cy + h * 0.5 - 1.0], dim=-1)


def _encode_plus1(ref, gt):
    """Regression targets of ``gt`` against ``ref`` boxes, +1 pixel
    widths: (dx, dy, log dw, log dh)."""
    rw = ref[..., 2] - ref[..., 0] + 1.0
    rh = ref[..., 3] - ref[..., 1] + 1.0
    rx = ref[..., 0] + rw * 0.5
    ry = ref[..., 1] + rh * 0.5
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    gx = gt[..., 0] + gw * 0.5
    gy = gt[..., 1] + gh * 0.5
    return torch.stack([(gx - rx) / rw, (gy - ry) / rh,
                        torch.log(gw / rw), torch.log(gh / rh)], dim=-1)


def _sample(mask, want, seed, lane, use_random):
    """The ``want`` [n, 1] entries of each row of ``mask`` [n, m] with the
    highest scores: uniform draws from the op seed (``rng.op_uniform01``
    on lane ``lane``) with ``use_random``, else the first ones in index
    order (-i / m)."""
    n, m = mask.shape
    if use_random:
        score = rng.op_uniform01(0 if seed is None else seed, (n, m),
                                 mask.device, lane=lane)
    else:
        score = (-torch.arange(m, dtype=torch.float32,
                               device=mask.device) / m)[None]
    score = torch.where(mask, score, -1.0)
    return mask & (_rank_of(desc_order(score)) < want)


@register_op("rpn_target_assign", no_grad=True, needs_rng=True)
def _rpn_target_assign(ins, attrs, device, seed=None):
    """Dense RPN anchor labelling (reference: rpn_target_assign_op.cc).
    Anchor [M, 4], GtBoxes [N, G, 4] (zero-area rows pad), ImInfo [N, 3],
    IsCrowd [N, G] (crowd boxes dropped). Per-anchor outputs instead of
    gathered LoD rows: ScoreLabel [N, M] (1 pos / 0 neg / -1 ignored),
    ScoreWeight [N, M] (1 on the sampled), BboxTarget [N, M, 4] (+1
    encoding on the sampled positives), BboxWeight [N, M, 4]. An anchor is
    positive at IoU >= ``rpn_positive_overlap`` or as a gt's best anchor,
    negative below ``rpn_negative_overlap``; at most
    ``rpn_batch_size_per_im * rpn_fg_fraction`` positives are kept and
    negatives fill the batch, drawn from the op seed with ``use_random``
    (``_sample``), else the first in anchor order."""
    anchors = _x(ins, "Anchor")
    gt = _x(ins, "GtBoxes").to(torch.float32)
    im_info = _x(ins, "ImInfo")
    is_crowd = _x(ins, "IsCrowd")
    batch_per_im = int(attrs.get("rpn_batch_size_per_im", 256))
    straddle = float(attrs.get("rpn_straddle_thresh", 0.0))
    fg_frac = float(attrs.get("rpn_fg_fraction", 0.5))
    pos_ov = float(attrs.get("rpn_positive_overlap", 0.7))
    neg_ov = float(attrs.get("rpn_negative_overlap", 0.3))
    use_random = bool(attrs.get("use_random", True))
    m, n = anchors.shape[0], gt.shape[0]
    gt_valid = xyxy_area(gt) > 0                                # [N, G]
    if is_crowd is not None:
        gt_valid = gt_valid & (is_crowd == 0)
    if straddle >= 0 and im_info is not None:
        hgt, wid = im_info[:, 0:1], im_info[:, 1:2]            # [N, 1]
        inside = ((anchors[None, :, 0] >= -straddle)
                  & (anchors[None, :, 1] >= -straddle)
                  & (anchors[None, :, 2] < wid + straddle)
                  & (anchors[None, :, 3] < hgt + straddle))     # [N, M]
    else:
        inside = torch.ones(n, m, dtype=torch.bool, device=gt.device)
    iou = iou_xyxy(anchors[None], gt)                           # [N, M, G]
    iou = torch.where(gt_valid[:, None, :] & inside[..., None], iou, -1.0)
    best_gt, best_iou = torch.argmax(iou, dim=2), torch.amax(iou, dim=2)
    gt_best = torch.amax(iou, dim=1, keepdim=True)              # [N, 1, G]
    is_gt_best = ((iou >= gt_best) & (gt_best > 0)
                  & gt_valid[:, None, :]).any(dim=2)
    pos = (best_iou >= pos_ov) | is_gt_best
    neg = (best_iou < neg_ov) & (best_iou >= 0) & ~pos
    want_fg = torch.clamp_max(pos.sum(1), int(batch_per_im * fg_frac))
    fg_sel = _sample(pos, want_fg[:, None], seed, 0, use_random)
    want_bg = torch.minimum(batch_per_im - fg_sel.sum(1), neg.sum(1))
    bg_sel = _sample(neg, want_bg[:, None], seed, 1, use_random)
    matched = _take_rows(gt, best_gt)                           # [N, M, 4]
    tgt = _encode_plus1(anchors[None], matched)
    label = torch.where(fg_sel, 1.0, torch.where(bg_sel, 0.0, -1.0))
    return {
        "ScoreLabel": [label.to(torch.float32)],
        "ScoreWeight": [(fg_sel | bg_sel).to(torch.float32)],
        "BboxTarget": [torch.where(fg_sel[..., None], tgt, 0.0)],
        "BboxWeight": [fg_sel[..., None].expand(tgt.shape).to(
            torch.float32)],
    }


def _nms_mask(boxes, keep0, thresh):
    """The greedy NMS keep mask of score-sorted sets, boxes [B, m, 4] and
    keep0 [B, m], with box_util's IoU: the JAX package's ``_nms_mask``
    without its top_k. At thresholds >= 0 that is ``nms_sweep``'s mask
    (csrc/nms_sweep.cu says why; the kernels on the card). Below 0 every
    earlier kept box suppresses, since box_util's IoU is never NaN: the
    first of keep0 stays alone."""
    if thresh >= 0:
        return nms_sweep(boxes, keep0, thresh)
    return keep0 & (torch.cumsum(keep0.to(torch.int32), dim=1) == 1)


@register_op("generate_proposals", no_grad=True)
def _generate_proposals(ins, attrs, device):
    """RPN proposal generation (reference: generate_proposals_op.cc).
    Scores [N, A, H, W], BboxDeltas [N, 4A, H, W], ImInfo [N, 3], Anchors
    [H, W, A, 4], Variances like Anchors. Per image: the ``pre_nms_topN``
    best scores (equal scores in index order, as ``jax.lax.top_k``),
    decoded, clipped, those under ``min_size`` dropped, greedy NMS
    (``_nms_mask``, box_util's IoU: the kernels on the card), the first
    ``post_nms_topN`` survivors. Dense outputs: RpnRois [N, post, 4]
    (rows beyond RpnRoisNum zero), RpnRoiProbs [N, post, 1], RpnRoisNum
    [N] int32."""
    scores = _x(ins, "Scores")
    deltas = _x(ins, "BboxDeltas")
    im_info = _x(ins, "ImInfo")
    anchors = _x(ins, "Anchors").reshape(-1, 4)
    variances = _x(ins, "Variances")
    if variances is not None:
        variances = variances.reshape(-1, 4)
    pre_n = int(attrs.get("pre_nms_topN", 6000))
    post_n = int(attrs.get("post_nms_topN", 1000))
    nms_thresh = float(attrs.get("nms_thresh", 0.5))
    min_size = float(attrs.get("min_size", 0.1))
    n, a, h, w = scores.shape
    total = a * h * w
    # [N, A, H, W] -> [N, H*W*A], the anchors' [H, W, A] order
    sc = scores.permute(0, 2, 3, 1).reshape(n, total).to(torch.float32)
    dl = (deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2)
          .reshape(n, total, 4).to(torch.float32))
    pre_n = min(pre_n, total)
    top_idx = desc_order(sc)[:, :pre_n]
    top_sc = torch.gather(sc, 1, top_idx)
    props = _decode_anchor(anchors[top_idx], _take_rows(dl, top_idx),
                           None if variances is None
                           else variances[top_idx])
    hgt, wid = im_info[:, 0:1, None], im_info[:, 1:2, None]

    def clip(v, hi):
        return torch.minimum(torch.clamp_min(v, 0.0), hi - 1.0)

    props = torch.cat([clip(props[..., 0:1], wid), clip(props[..., 1:2], hgt),
                       clip(props[..., 2:3], wid), clip(props[..., 3:4], hgt)],
                      dim=-1)
    ws = props[..., 2] - props[..., 0] + 1.0
    hs = props[..., 3] - props[..., 1] + 1.0
    min_sz = max(min_size, 1.0) * im_info[:, 2:3]
    top_sc = torch.where((ws >= min_sz) & (hs >= min_sz), top_sc, _NEG)
    order = desc_order(top_sc)
    boxes, sc = _take_rows(props, order), torch.gather(top_sc, 1, order)
    keep = _nms_mask(boxes, sc > _NEG / 2, nms_thresh)
    if post_n > 0:
        keep = keep & (torch.cumsum(keep.to(torch.int32), dim=1) <= post_n)
    sc = torch.where(keep, sc, _NEG)
    order2 = desc_order(sc)[:, :post_n]
    s2 = torch.gather(sc, 1, order2)
    live = s2 > _NEG / 2
    return {"RpnRois": [torch.where(live[..., None],
                                    _take_rows(boxes, order2), 0.0)],
            "RpnRoiProbs": [torch.where(live, s2, 0.0)[..., None]],
            "RpnRoisNum": [(sc > _NEG / 2).sum(1).to(torch.int32)]}


@register_op("generate_proposal_labels", no_grad=True, needs_rng=True)
def _generate_proposal_labels(ins, attrs, device, seed=None):
    """Sample RoIs for the second stage (reference:
    generate_proposal_labels_op.cc). RpnRois [N, R, 4] (zero-area rows
    pad), GtClasses [N, G], GtBoxes [N, G, 4], IsCrowd [N, G]. The gt
    boxes join the candidates; foreground at IoU >= ``fg_thresh`` (at
    most ``batch_size_per_im * fg_fraction``), background in [bg_lo,
    bg_hi) fills the batch; drawn from the op seed with ``use_random``,
    else in candidate order. Fixed ``batch_size_per_im`` rows an image,
    foreground first: Rois [N, B, 4], LabelsInt32 [N, B] (0 background,
    -1 unused), BboxTargets [N, B, 4 * class_nums] (the +1 encoding in
    the label's four columns), BboxInside/OutsideWeights alike."""
    rois = _x(ins, "RpnRois").to(torch.float32)
    gt_classes = _x(ins, "GtClasses")
    gt_boxes = _x(ins, "GtBoxes").to(torch.float32)
    is_crowd = _x(ins, "IsCrowd")
    batch = int(attrs.get("batch_size_per_im", 512))
    fg_frac = float(attrs.get("fg_fraction", 0.25))
    fg_thresh = float(attrs.get("fg_thresh", 0.5))
    bg_hi = float(attrs.get("bg_thresh_hi", 0.5))
    bg_lo = float(attrs.get("bg_thresh_lo", 0.0))
    class_nums = int(attrs.get("class_nums", 81))
    use_random = bool(attrs.get("use_random", True))
    n = rois.shape[0]
    gt_valid = xyxy_area(gt_boxes) > 0
    if is_crowd is not None:
        gt_valid = gt_valid & (is_crowd == 0)
    cand = torch.cat([rois, gt_boxes], dim=1)                  # [N, R+G, 4]
    cand_valid = torch.cat([xyxy_area(rois) > 0, gt_valid], dim=1)
    iou = iou_xyxy(cand, gt_boxes)
    # an invalid gt overlaps nothing; an invalid candidate is never
    # foreground or background
    iou = torch.where(gt_valid[:, None, :], iou, 0.0)
    iou = torch.where(cand_valid[..., None], iou, -1.0)
    best_gt, best_iou = torch.argmax(iou, dim=2), torch.amax(iou, dim=2)
    fg = best_iou >= fg_thresh
    bg = (best_iou < bg_hi) & (best_iou >= bg_lo)
    want_fg = torch.clamp_max(fg.sum(1), int(batch * fg_frac))
    fg_sel = _sample(fg, want_fg[:, None], seed, 0, use_random)
    want_bg = torch.minimum(batch - fg_sel.sum(1), bg.sum(1))
    bg_sel = _sample(bg, want_bg[:, None], seed, 1, use_random)
    # compact: foreground first, then background, padded to `batch`
    key = torch.where(fg_sel, 0, torch.where(bg_sel, 1, 2))
    order = torch.sort(key, dim=1, stable=True).indices[:, :batch]
    sel_rois = _take_rows(cand, order)
    sel_gt = torch.gather(best_gt, 1, order)
    sel_fg = torch.gather(fg_sel, 1, order)
    sel_used = torch.gather(fg_sel | bg_sel, 1, order)
    labels = torch.gather(gt_classes.to(torch.int64), 1, sel_gt)
    labels = torch.where(sel_fg, labels, torch.where(sel_used, 0, -1)).to(
        torch.int32)
    tgt = _encode_plus1(sel_rois, _take_rows(gt_boxes, sel_gt))
    onehot = (torch.clamp_min(labels, 0)[..., None] == torch.arange(
        class_nums, device=rois.device)).to(torch.float32)    # [N, B, C]
    col = onehot[..., None] * torch.where(sel_fg[..., None], tgt,
                                          0.0)[:, :, None, :]
    bbox_targets = col.reshape(n, batch, 4 * class_nums)
    w_in = (onehot * sel_fg[..., None])[..., None].expand(
        n, batch, class_nums, 4).reshape(n, batch, 4 * class_nums)
    return {
        "Rois": [torch.where(sel_used[..., None], sel_rois, 0.0)],
        "LabelsInt32": [labels],
        "BboxTargets": [bbox_targets],
        "BboxInsideWeights": [w_in],
        "BboxOutsideWeights": [w_in],
    }


@register_op("distribute_fpn_proposals", no_grad=True)
def _distribute_fpn_proposals(ins, attrs, device):
    """Route RoIs to FPN levels by scale (reference:
    distribute_fpn_proposals_op.cc): level = clip(floor(refer_level +
    log2(sqrt(area) / refer_scale)), min_level, max_level). FpnRois
    [N, R, 4] (zero rows pad). One [N, R, 4] tensor a level, its RoIs
    first (in input order), the rest zero; per-level counts; RestoreInd
    [N, R]: each input RoI's row in the concatenation of the levels'
    R-row bands (-1 for padding)."""
    rois = _x(ins, "FpnRois").to(torch.float32)
    min_level = int(attrs.get("min_level", 2))
    max_level = int(attrs.get("max_level", 5))
    refer_level = int(attrs.get("refer_level", 4))
    refer_scale = int(attrs.get("refer_scale", 224))
    n, r = rois.shape[:2]
    area = xyxy_area(rois)
    valid = area > 0
    lvl = torch.floor(refer_level + torch.log2(
        torch.sqrt(torch.clamp_min(area, 1e-6)) / refer_scale + 1e-12))
    lvl = torch.clamp(lvl, min_level, max_level).to(torch.int32)
    lvl = torch.where(valid, lvl, max_level + 1)
    outs, nums = [], []
    pos = torch.zeros(n, r, dtype=torch.int32, device=rois.device)
    cols = torch.arange(r, device=rois.device)[None]
    for li, level in enumerate(range(min_level, max_level + 1)):
        mask = lvl == level
        order = torch.sort((~mask).to(torch.uint8), dim=1,
                           stable=True).indices
        cnt = mask.sum(1).to(torch.int32)
        outs.append(torch.where((cols < cnt[:, None])[..., None],
                                _take_rows(rois, order), 0.0))
        nums.append(cnt)
        rank = torch.cumsum(mask.to(torch.int32), dim=1) - 1
        pos = torch.where(mask, (li * r + rank).to(torch.int32), pos)
    return {"MultiFpnRois": outs, "MultiLevelRoIsNum": nums,
            "RestoreInd": [torch.where(valid, pos, -1)]}


@register_op("collect_fpn_proposals", no_grad=True)
def _collect_fpn_proposals(ins, attrs, device):
    """Merge per-level RoIs by score (reference:
    collect_fpn_proposals_op.cc): the levels concatenated, the global
    ``post_nms_topN`` best kept (equal scores in index order).
    MultiLevelRois: [N, R_l, 4] each; MultiLevelScores: [N, R_l] (or
    [N, R_l, 1]); zero-area rows pad. FpnRois [N, K, 4], RoisNum [N]."""
    rois = torch.cat([x.to(torch.float32)
                      for x in ins.get("MultiLevelRois", [])], dim=1)
    scores = torch.cat([s.reshape(s.shape[0], -1).to(torch.float32)
                        for s in ins.get("MultiLevelScores", [])], dim=1)
    post = int(attrs.get("post_nms_topN", 1000))
    scores = torch.where(xyxy_area(rois) > 0, scores, _NEG)
    top_idx = desc_order(scores)[:, :min(post, rois.shape[1])]
    alive = torch.gather(scores, 1, top_idx) > _NEG / 2
    return {"FpnRois": [torch.where(alive[..., None],
                                    _take_rows(rois, top_idx), 0.0)],
            "RoisNum": [alive.sum(1).to(torch.int32)]}


@register_op("box_decoder_and_assign", no_grad=True)
def _box_decoder_and_assign(ins, attrs, device):
    """Decode per-class deltas and pick the best class's box (reference:
    box_decoder_and_assign_op.cc). PriorBox [P, 4], PriorBoxVar [4] or
    [P, 4], TargetBox [P, 4*C], BoxScore [P, C]. DecodeBox [P, 4*C],
    OutputAssignBox [P, 4]."""
    prior = _x(ins, "PriorBox").to(torch.float32)
    pvar = _x(ins, "PriorBoxVar")
    target = _x(ins, "TargetBox").to(torch.float32)
    score = _x(ins, "BoxScore").to(torch.float32)
    box_clip = float(attrs.get("box_clip", _BBOX_CLIP))
    p, c = prior.shape[0], score.shape[1]
    deltas = target.reshape(p, c, 4)
    if pvar is not None:
        var = pvar.to(torch.float32)
        var = var if var.dim() == 2 else var[None].expand(p, 4)
        deltas = deltas * var[:, None, :]
    aw = prior[:, 2] - prior[:, 0] + 1.0
    ah = prior[:, 3] - prior[:, 1] + 1.0
    ax = prior[:, 0] + aw * 0.5
    ay = prior[:, 1] + ah * 0.5
    cx = deltas[..., 0] * aw[:, None] + ax[:, None]
    cy = deltas[..., 1] * ah[:, None] + ay[:, None]
    w = torch.exp(torch.clamp_max(deltas[..., 2], box_clip)) * aw[:, None]
    h = torch.exp(torch.clamp_max(deltas[..., 3], box_clip)) * ah[:, None]
    decoded = torch.stack([cx - w * 0.5, cy - h * 0.5,
                           cx + w * 0.5 - 1.0, cy + h * 0.5 - 1.0], dim=-1)
    best = torch.argmax(score, dim=1)
    return {"DecodeBox": [decoded.reshape(p, c * 4)],
            "OutputAssignBox": [_take_rows(decoded, best[:, None])[:, 0]]}


# --------------------------------------------------------------------------
# YOLOv3
# --------------------------------------------------------------------------


def _yolo_grids(x, anchors, anchor_mask, class_num, downsample):
    n, c, h, w = x.shape
    m = len(anchor_mask)
    xr = x.reshape(n, m, 5 + class_num, h, w)
    input_size = downsample * h
    f32 = torch.float32
    gx = torch.arange(w, dtype=f32, device=x.device)
    gy = torch.arange(h, dtype=f32, device=x.device)[:, None]
    aw = _const([anchors[2 * i] for i in anchor_mask], f32, x.device)
    ah = _const([anchors[2 * i + 1] for i in anchor_mask], f32, x.device)
    px = (gx + torch.sigmoid(xr[:, :, 0])) / w
    py = (gy + torch.sigmoid(xr[:, :, 1])) / h
    pw = torch.exp(xr[:, :, 2]) * aw[None, :, None, None] / input_size
    ph = torch.exp(xr[:, :, 3]) * ah[None, :, None, None] / input_size
    return xr, (px, py, pw, ph), input_size


def _iou_cxcywh(ax, ay, aw, ah, bx, by, bw, bh):
    """IoU of center-format boxes (broadcasting)."""
    lft = torch.maximum(ax - aw / 2, bx - bw / 2)
    rgt = torch.minimum(ax + aw / 2, bx + bw / 2)
    top = torch.maximum(ay - ah / 2, by - bh / 2)
    bot = torch.minimum(ay + ah / 2, by + bh / 2)
    inter = torch.clamp_min(rgt - lft, 0.0) * torch.clamp_min(bot - top, 0.0)
    union = aw * ah + bw * bh - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-10), 0.0)


def _bce_logits(logit, target):
    return (torch.maximum(logit, torch.zeros_like(logit)) - logit * target
            + torch.log1p(torch.exp(-torch.abs(logit))))


@register_op("yolov3_loss", diff_inputs=("X",))
def _yolov3_loss(ins, attrs, device):
    """YOLOv3 loss (reference: yolov3_loss_op.h), in f32. X [N,
    m*(5+C), H, W]; GTBox [N, B, 4] center-format (x, y, w, h) normalized
    to [0, 1] (rows with w or h <= 0 pad); GTLabel [N, B]; GTScore [N, B]
    optional (mixup). Each gt is owned by its best anchor of the full set
    (by shape IoU) when that anchor is in ``anchor_mask``: location (BCE
    on x, y; L1 on log w, h, scaled by 2 - w h) and class (BCE, label
    smoothing) losses at its cell; objectness BCE everywhere but at
    predictions whose best IoU with a gt exceeds ``ignore_thresh``. Loss
    [N]; ObjectnessMask [N, m, H, W] (the gt's score at owned cells,
    where two gts own one cell the later row's, -1 ignored, else 0);
    GTMatchMask [N, B] int32 (the owning anchor's position in the mask,
    -1)."""
    x = _x(ins)
    gt_box = _x(ins, "GTBox").to(torch.float32)
    gt_label = _x(ins, "GTLabel")
    gt_score = _x(ins, "GTScore")
    anchors = [int(a) for a in attrs["anchors"]]
    anchor_mask = [int(a) for a in attrs["anchor_mask"]]
    class_num = int(attrs["class_num"])
    ignore_thresh = float(attrs.get("ignore_thresh", 0.7))
    downsample = int(attrs.get("downsample_ratio", 32))
    smooth = bool(attrs.get("use_label_smooth", True))
    n, c, h, w = x.shape
    m, b = len(anchor_mask), gt_box.shape[1]
    dev, f32 = x.device, torch.float32
    xr, (px, py, pw, ph), input_size = _yolo_grids(
        x.to(f32), anchors, anchor_mask, class_num, downsample)
    if gt_score is None:
        gt_score = torch.ones(n, b, dtype=f32, device=dev)
    gx, gy, gw, gh = gt_box.unbind(-1)                          # [N, B]
    valid = (gw > 0) & (gh > 0)

    # ignore mask: each prediction's best IoU over the valid gts
    def at_gts(v):
        return v[:, None, None, None, :]

    iou = _iou_cxcywh(px[..., None], py[..., None], pw[..., None],
                      ph[..., None], at_gts(gx), at_gts(gy), at_gts(gw),
                      at_gts(gh))
    best_iou = torch.amax(torch.where(at_gts(valid), iou, 0.0), dim=-1)

    # each gt's best anchor over the full set (shapes at the origin)
    aw_full = _const(anchors[0::2], f32, dev)
    ah_full = _const(anchors[1::2], f32, dev)
    gt_an_iou = _iou_cxcywh(0.0, 0.0, gw[..., None], gh[..., None], 0.0,
                            0.0, (aw_full / input_size)[None, None],
                            (ah_full / input_size)[None, None])  # [N, B, A]
    best_n = torch.argmax(gt_an_iou, dim=-1)
    lut = [-1] * (len(anchors) // 2)
    for pos, a in enumerate(anchor_mask):
        lut[a] = pos
    mask_idx = torch.where(valid, _const(lut, torch.int32, dev)[best_n], -1)
    sel = valid & (mask_idx >= 0)
    gi = torch.clamp((gx * w).to(torch.int64), 0, w - 1)
    gj = torch.clamp((gy * h).to(torch.int64), 0, h - 1)
    midx = torch.clamp_min(mask_idx, 0).to(torch.int64)
    bidx = torch.arange(n, device=dev)[:, None].expand(n, b)

    cell = xr[bidx, midx, :, gj, gi]                            # [N, B, 5+C]
    tx, ty = gx * w - gi, gy * h - gj
    tw = torch.log(torch.clamp_min(gw * input_size, 1e-9)
                   / torch.clamp_min(aw_full[best_n], 1e-9))
    th = torch.log(torch.clamp_min(gh * input_size, 1e-9)
                   / torch.clamp_min(ah_full[best_n], 1e-9))
    scale = (2.0 - gw * gh) * gt_score
    loc = (_bce_logits(cell[..., 0], tx) + _bce_logits(cell[..., 1], ty)
           + torch.abs(cell[..., 2] - tw) + torch.abs(cell[..., 3] - th))
    loc_loss = torch.where(sel, loc * scale, 0.0).sum(1)

    if smooth and class_num > 1:
        pos_t, neg_t = 1.0 - 1.0 / class_num, 1.0 / class_num
    else:
        pos_t, neg_t = 1.0, 0.0
    onehot = (gt_label.to(torch.int64)[..., None] == torch.arange(
        class_num, device=dev)).to(f32)
    tcls = onehot * pos_t + (1.0 - onehot) * neg_t
    cls = _bce_logits(cell[..., 5:], tcls).sum(-1)
    cls_loss = torch.where(sel, cls * gt_score, 0.0).sum(1)

    # objectness targets: the gt's score at owned cells (the later row
    # where two gts own one), -1 where ignored, else 0; written with
    # comparisons (no scatter), so the card writes the CPU's value
    obj = torch.where(best_iou > ignore_thresh, -1.0, 0.0).reshape(n, -1)
    cells = (midx * h + gj) * w + gi                            # [N, B]
    hits = (cells[..., None] == torch.arange(m * h * w, device=dev)) \
        & sel[..., None]                                        # [N, B, mhw]
    last = torch.argmax(hits * torch.arange(1, b + 1, device=dev)[:, None],
                        dim=1)                                  # [N, mhw]
    obj = torch.where(hits.any(dim=1),
                      torch.gather(gt_score.to(f32), 1, last), obj)
    obj = obj.reshape(n, m, h, w).detach()
    obj_logit = xr[:, :, 4]
    obj_loss = torch.where(
        obj > 1e-5, _bce_logits(obj_logit, 1.0) * obj,
        torch.where(obj > -0.5, _bce_logits(obj_logit, 0.0), 0.0)).sum(
            dim=(1, 2, 3))
    return {"Loss": [loc_loss + cls_loss + obj_loss],
            "ObjectnessMask": [obj],
            "GTMatchMask": [mask_idx.to(torch.int32)]}


# --------------------------------------------------------------------------
# mAP
# --------------------------------------------------------------------------


def _seq_sum(v):
    """The sum of ``v``'s last dim in index order (a chain of adds: the
    same bits on the CPU and the card)."""
    s = v[..., 0]
    for i in range(1, v.shape[-1]):
        s = s + v[..., i]
    return s


def _ap(prec, rec, alive, ap_type):
    """Average precision of each row of a PR curve: 11-point (the mean of
    the best precision at recall >= 0, 0.1, ..., 1) or integral (the sum
    of precision times the recall step, summed in f64)."""
    if ap_type == "11point":
        pts = [torch.amax(torch.where(rec >= i / 10.0, prec, 0.0), dim=-1)
               for i in range(11)]
        total = pts[0]
        for p in pts[1:]:
            total = total + p
        # a divisor on the device: the card divides an f32 tensor by a
        # Python number as a product with its reciprocal, the CPU does not
        return total / torch.full_like(total, 11.0)
    drec = torch.diff(rec, dim=-1, prepend=torch.zeros_like(rec[..., :1]))
    return (prec * drec * alive).to(torch.float64).sum(-1).to(torch.float32)


def _greedy_true_positives(det_label, det_score, det_valid, gt_label,
                           gt_valid, iou, overlap):
    """[N, D] bool: each detection, in score order (equal scores in index
    order), takes the unused gt of its label with the highest IoU (the
    first on ties) when that IoU >= ``overlap``: the JAX op's per-class
    greedy match, every class and image at once (a detection's match
    depends only on the earlier detections of its own label)."""
    n, d = det_label.shape
    dev = det_label.device
    order = desc_order(torch.where(det_valid, det_score, _NEG))
    used = torch.zeros_like(gt_valid)
    tp = torch.zeros(n, d, dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    det_cols = torch.arange(d, device=dev)[None]
    gt_cols = torch.arange(gt_valid.shape[1], device=dev)[None]
    for k in range(d):
        di = order[:, k]
        lab = det_label[rows, di]
        elig = gt_valid & (gt_label == lab[:, None]) & ~used
        ious = torch.where(elig, iou[rows, di], -1.0)
        best = torch.argmax(ious, dim=1)
        hit = (ious[rows, best] >= overlap) & det_valid[rows, di]
        used = used | ((gt_cols == best[:, None]) & hit[:, None])
        tp = tp | ((det_cols == di[:, None]) & hit[:, None])
    return tp


@register_op("detection_map", no_grad=True)
def _detection_map(ins, attrs, device):
    """mAP of a batch (reference: detection_map_op.cc, integral and
    11-point). DetectRes [N, D, 6] rows (label, score, x1, y1, x2, y2),
    label < 0 padding; Label [N, G, 5] rows (label, x1, y1, x2, y2) or
    [N, G, 6] (label, difficult, box). With evaluate_difficult=False a
    difficult gt neither counts nor takes a match. MAP: the mean AP of the
    classes that have a gt.

    With HasState / PosCount [C] / TruePos [C, bins] / FalsePos wired
    (metrics.DetectionMAP), the fixed-size accumulation of the JAX op:
    each class's TP / FP counts binned over ``score_bins`` confidence bins
    in [0, 1], added to the inputs where HasState is 1; AccumMAP walks the
    binned PR curve from the top bin down. Counts are whole numbers, so
    their sums are exact in any order; the means add in index order."""
    det = _x(ins, "DetectRes").to(torch.float32)
    gt = _x(ins, "Label").to(torch.float32)
    class_num = int(attrs["class_num"])
    overlap = float(attrs.get("overlap_threshold", 0.5))
    ap_type = attrs.get("ap_type", "integral")
    evaluate_difficult = bool(attrs.get("evaluate_difficult", True))
    has_state = _x(ins, "HasState")
    n_bins = int(attrs.get("score_bins", 1024))
    dev = det.device
    gt_boxes, gt_label = gt[..., -4:], gt[..., 0]
    gt_valid = gt_label >= 0
    if gt.shape[-1] >= 6 and not evaluate_difficult:
        gt_valid = gt_valid & (gt[..., 1] == 0)
    det_label, det_score, det_boxes = det[..., 0], det[..., 1], det[..., 2:]
    det_valid = det_label >= 0
    iou = iou_xyxy(det_boxes, gt_boxes)                         # [N, D, G]
    tp = _greedy_true_positives(det_label, det_score, det_valid, gt_label,
                                gt_valid, iou, overlap)

    cls = torch.arange(class_num, dtype=torch.float32, device=dev)[:, None,
                                                                 None]
    gmask = gt_valid[None] & (gt_label[None] == cls)            # [C, N, G]
    dmask = det_valid[None] & (det_label[None] == cls)          # [C, N, D]
    npos = gmask.sum(dim=(1, 2)).to(torch.float32)              # [C]
    sc_flat = torch.where(dmask, det_score[None], _NEG).reshape(class_num, -1)
    tp_flat = (tp[None] & dmask).reshape(class_num, -1).to(torch.float32)
    order = desc_order(sc_flat)
    tp_sorted = torch.gather(tp_flat, 1, order)
    alive = (torch.gather(sc_flat, 1, order) > _NEG / 2).to(torch.float32)
    ctp = torch.cumsum(tp_sorted * alive, dim=1)
    cfp = torch.cumsum((1.0 - tp_sorted) * alive, dim=1)
    prec = ctp / torch.clamp_min(ctp + cfp, 1.0)
    rec = ctp / torch.clamp_min(npos, 1.0)[:, None]
    aps = torch.where(npos > 0, _ap(prec, rec, alive, ap_type), -1.0)
    have = aps >= 0
    out = {"MAP": [_seq_sum(torch.where(have, aps, 0.0))
                   / torch.clamp_min(have.sum(), 1)]}
    if has_state is None:
        return out
    w_alive = dmask.reshape(class_num, -1).to(torch.float32)
    bins = torch.clamp((sc_flat * n_bins).to(torch.int64), 0, n_bins - 1)
    zeros = torch.zeros(class_num, n_bins, dtype=torch.float32, device=dev)
    tp_hist = zeros.scatter_add(1, bins, tp_flat * w_alive)
    fp_hist = zeros.scatter_add(1, bins, (1.0 - tp_flat) * w_alive)
    has = has_state.reshape(()).to(torch.float32)
    tp_acc = tp_hist + has * _x(ins, "TruePos").to(torch.float32)
    fp_acc = fp_hist + has * _x(ins, "FalsePos").to(torch.float32)
    npos_acc = npos + has * _x(ins, "PosCount").to(torch.float32)
    ctp = torch.cumsum(tp_acc.flip(1), dim=1)                   # [C, bins]
    cfp = torch.cumsum(fp_acc.flip(1), dim=1)
    prec = ctp / torch.clamp_min(ctp + cfp, 1.0)
    rec = ctp / torch.clamp_min(npos_acc[:, None], 1.0)
    acc_aps = _ap(prec, rec, torch.ones_like(prec), ap_type)
    have_a = npos_acc > 0
    out["AccumMAP"] = [_seq_sum(torch.where(have_a, acc_aps, 0.0))
                       / torch.clamp_min(have_a.sum(), 1)]
    out["AccumTruePos"] = [tp_acc]
    out["AccumFalsePos"] = [fp_acc]
    out["AccumPosCount"] = [npos_acc]
    return out


# --------------------------------------------------------------------------
# Mask R-CNN mask targets
# --------------------------------------------------------------------------


def _point_in_polygon(px, py, verts, n_valid):
    """Crossing-number fill over padded vertex lists: px / py [M, M]
    sample points; verts [..., V, 2]; n_valid [...] real vertices (edges
    wrap at n_valid). Returns [..., M, M] bool."""
    v = verts.shape[-2]
    idx = torch.arange(v, device=verts.device)
    nxt = torch.where(idx + 1 >= n_valid[..., None], 0, idx + 1)  # [..., V]
    x1, y1 = verts[..., 0], verts[..., 1]
    x2 = torch.gather(x1, -1, nxt)
    y2 = torch.gather(y1, -1, nxt)
    edge_ok = idx < n_valid[..., None]

    def at_points(e):                                   # [..., 1, 1, V]
        return e[..., None, None, :]

    x1, y1, x2, y2, edge_ok = (at_points(e) for e in (x1, y1, x2, y2,
                                                       edge_ok))
    px, py = px[..., None], py[..., None]
    dy = y2 - y1
    crosses = ((y1 > py) != (y2 > py)) & (
        px < (x2 - x1) * (py - y1) / torch.where(dy == 0, 1e-12, dy) + x1
    ) & edge_ok
    return crosses.sum(-1) % 2 == 1


@register_op("generate_mask_labels", no_grad=True)
def _generate_mask_labels(ins, attrs, device):
    """Mask R-CNN mask targets (reference: generate_mask_labels_op.cc),
    the JAX op's dense-padded redesign of the polygon LoD input: GtSegms
    [N, G, Q, V, 2] (up to Q polygon parts of up to V vertices a gt),
    PolyLens [N, G, Q] (real vertex counts, 0 = unused part), GtClasses /
    IsCrowd [N, G] (class 0 pads), Rois [N, R, 4], LabelsInt32 [N, R]
    (0 background), ImInfo [N, 3]. Each foreground RoI takes the polygons
    of the gt whose bounding box it overlaps most, rasterized at the
    ``resolution``^2 pixel centers of the (unscaled) RoI by a
    crossing-number fill. Outputs, foreground RoIs first: MaskRois [N, R,
    4] (-1 rows pad), RoiHasMaskInt32 [N, R] (source RoI, -1 pad),
    MaskInt32 [N, R, resolution^2 * num_classes] (the mask in the RoI's
    class block, -1 elsewhere), MaskNum [N]; an image without foreground
    keeps its first RoI with an all -1 mask."""
    im_info = _x(ins, "ImInfo").to(torch.float32)
    gt_classes = _x(ins, "GtClasses").to(torch.int32)
    is_crowd = _x(ins, "IsCrowd")
    segs = _x(ins, "GtSegms").to(torch.float32)
    poly_lens = _x(ins, "PolyLens")
    rois = _x(ins, "Rois").to(torch.float32)
    labels = _x(ins, "LabelsInt32").to(torch.int64)
    num_classes = int(attrs["num_classes"])
    m = int(attrs["resolution"])
    n, g, q, v, _ = segs.shape
    r = rois.shape[1]
    dev = segs.device
    if is_crowd is None:
        is_crowd = torch.zeros_like(gt_classes)
    if poly_lens is None:
        poly_lens = torch.full((n, g, q), v, dtype=torch.int64, device=dev)
    plens = poly_lens.to(torch.int64)
    valid_gt = (gt_classes > 0) & (is_crowd.to(torch.int32) == 0) & (
        plens.sum(-1) > 0)                                      # [N, G]
    vert_ok = torch.arange(v, device=dev) < plens[..., None]    # [N, G, Q, V]
    xs, ys = segs[..., 0], segs[..., 1]
    inf = math.inf
    poly_boxes = torch.stack([
        torch.where(vert_ok, xs, inf).amin(dim=(2, 3)),
        torch.where(vert_ok, ys, inf).amin(dim=(2, 3)),
        torch.where(vert_ok, xs, -inf).amax(dim=(2, 3)),
        torch.where(vert_ok, ys, -inf).amax(dim=(2, 3))], dim=-1)
    poly_boxes = torch.where(valid_gt[..., None], poly_boxes, 0.0)

    roi_s = rois / im_info[:, 2, None, None]
    iou = torch.where(valid_gt[:, None, :], iou_xyxy(roi_s, poly_boxes),
                      -1.0)                                     # [N, R, G]
    best_gt = torch.argmax(iou, dim=2)                          # [N, R]
    fg = labels > 0
    fg_num = fg.sum(1).to(torch.int32)                          # [N]

    bx0, by0 = roi_s[..., 0], roi_s[..., 1]
    bw = torch.clamp_min(roi_s[..., 2] - bx0, 1.0)
    bh = torch.clamp_min(roi_s[..., 3] - by0, 1.0)
    grid = torch.arange(m, dtype=torch.float32, device=dev) + 0.5
    py_, px_ = torch.meshgrid(grid, grid, indexing="ij")        # [M, M]
    rows = torch.arange(n, device=dev)[:, None]
    segs_r = segs[rows, best_gt]                                # [N, R, Q, V, 2]
    plens_r = plens[rows, best_gt]                              # [N, R, Q]

    def to_roi(coord, lo, size):
        return (coord - lo[..., None, None]) * m / size[..., None, None]

    verts = torch.stack([to_roi(segs_r[..., 0], bx0, bw),
                         to_roi(segs_r[..., 1], by0, bh)], dim=-1)
    parts = _point_in_polygon(px_, py_, verts, plens_r) & (
        plens_r > 2)[..., None, None]                           # [N, R, Q, M, M]
    masks = parts.any(dim=2).reshape(n, r, m * m).to(torch.int32)

    # the mask in the RoI's class block, -1 elsewhere and for background
    in_block = (labels[..., None] == torch.arange(
        num_classes, device=dev))[..., None]                    # [N, R, C, 1]
    expanded = torch.where(in_block & fg[..., None, None],
                           masks[:, :, None, :], -1).reshape(
        n, r, num_classes * m * m)

    # foreground RoIs first (stable); no foreground: the first RoI, class 0
    order = torch.sort(torch.where(fg, 0, 1), dim=1, stable=True).indices
    has_fg = (fg_num > 0)[:, None]
    cols = torch.arange(r, device=dev)[None]
    take = torch.where(has_fg, order, cols)
    keep = torch.where(has_fg, cols < fg_num[:, None], cols < 1)
    mask_rois = torch.where(keep[..., None], _take_rows(rois, take), -1.0)
    roi_has_mask = torch.where(keep, take.to(torch.int32), -1)
    out_masks = torch.where((keep & has_fg)[..., None],
                            _take_rows(expanded, take), -1)
    count = torch.where(has_fg[:, 0], fg_num, 1)
    return {"MaskRois": [mask_rois], "RoiHasMaskInt32": [roi_has_mask],
            "MaskInt32": [out_masks], "MaskNum": [count.to(torch.int32)]}
