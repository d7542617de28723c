"""Detection ops of the JAX package's ops/detection_ops.py that SSD runs:
``target_assign``, ``mine_hard_examples`` and the fused ``ssd_loss``
(reference kernels: paddle/fluid/operators/detection/{target_assign_op.cc,
mine_hard_examples_op.cc}, layers/detection.py ssd_loss). The other ops of
that file are not ported (ROADMAP.md).

Dense-padded design, as in the JAX package: where the reference passes
variable-length LoD tensors, these ops take fixed-capacity tensors padded
with sentinel rows (gt boxes of zero area, -1 indices) and return
fixed-capacity outputs plus weights and masks. Shapes are static and no
op reads a value on the host, so a captured step holds them.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.box_util import (
    greedy_bipartite_match,
    iou_xyxy,
    xyxy_area,
)
from paddle_tpu_torch.ops.vision_ops import desc_order

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
