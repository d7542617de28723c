"""Detection layers of the JAX package's layers/detection.py (reference:
python/paddle/fluid/layers/detection.py) whose ops the port has: IoU,
box coding, prior boxes, bipartite matching, target assignment, the
fused SSD loss, the NMS'd detection output and the multi-box head.

Signatures mirror the JAX package's, with its one systematic change:
ground truth that the reference passes as LoD tensors ([Ng, 4] with
per-image offsets) is dense and padded ([N, G, 4] with zero-area rows as
padding, labels alongside), and outputs that were LoD lists are
fixed-capacity tensors plus counts or weights. The other layers of that
file (``density_prior_box``, ``anchor_generator``, ``box_clip``,
``yolov3_loss``, ``detection_map``, ``rpn_target_assign``,
``generate_proposals``, ``generate_proposal_labels``,
``distribute_fpn_proposals``, ``collect_fpn_proposals``,
``box_decoder_and_assign``, ``generate_mask_labels``) wait for their ops
(ROADMAP.md) and are not defined here.
"""

from __future__ import annotations

from paddle_tpu_torch.layer_helper import append_simple_op as _op
from paddle_tpu_torch.layers import nn as _nn

__all__ = [
    "iou_similarity", "box_coder", "prior_box", "bipartite_match",
    "target_assign", "ssd_loss", "detection_output", "multi_box_head",
    "anchor_generator",
]


def iou_similarity(x, y, name=None):
    """Pairwise IoU (reference: detection.py:328)."""
    return _op("iou_similarity", {"X": x, "Y": y}, name=name,
               stop_gradient=True)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None, axis=0):
    """Encode/decode boxes against priors (reference: detection.py:365)."""
    return _op("box_coder",
               {"PriorBox": prior_box, "PriorBoxVar": prior_box_var,
                "TargetBox": target_box},
               {"code_type": code_type, "box_normalized": box_normalized,
                "axis": axis},
               out_slots=("OutputBox",), name=name)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    """SSD prior boxes per feature-map cell (reference: detection.py:1247).
    Outputs Boxes/Variances [H, W, P, 4]."""
    attrs = {
        "min_sizes": list(min_sizes),
        "max_sizes": list(max_sizes or []),
        "aspect_ratios": list(aspect_ratios),
        "variances": list(variance),
        "flip": flip, "clip": clip,
        "step_w": steps[0], "step_h": steps[1], "offset": offset,
        "min_max_aspect_ratios_order": min_max_aspect_ratios_order,
    }
    return _op("prior_box", {"Input": input, "Image": image}, attrs,
               out_slots=("Boxes", "Variances"), name=name,
               stop_gradient=True)


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    """Greedy bipartite matching (reference: detection.py:830).
    ``dist_matrix`` [G, P] or batched [N, G, P]."""
    return _op("bipartite_match", {"DistMat": dist_matrix},
               {"match_type": match_type or "bipartite",
                "dist_threshold":
                    0.5 if dist_threshold is None else dist_threshold},
               out_slots=("ColToRowMatchIndices", "ColToRowMatchDist"),
               dtypes=("int32", None), name=name, stop_gradient=True)


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    """Assign targets by match indices (reference: detection.py:916).
    ``input`` [N, G, K] dense per-image entities."""
    return _op("target_assign",
               {"X": input, "MatchIndices": matched_indices,
                "NegIndices": negative_indices},
               {"mismatch_value":
                    0.0 if mismatch_value is None else mismatch_value},
               out_slots=("Out", "OutWeight"), name=name,
               stop_gradient=True)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None,
             name=None):
    """SSD multibox loss -> [N, 1] (reference: detection.py:1013; the
    bipartite-match/mining/target-assign pipeline runs as one fused dense
    op, see ops/detection_ops.py ssd_loss). ``gt_box`` [N, G, 4] padded
    dense, ``gt_label`` [N, G]."""
    if mining_type != "max_negative":
        raise ValueError("Only mining_type == 'max_negative' is supported")
    return _op("ssd_loss",
               {"Location": location, "Confidence": confidence,
                "GtBox": gt_box, "GtLabel": gt_label,
                "PriorBox": prior_box, "PriorBoxVar": prior_box_var},
               {"background_label": background_label,
                "overlap_threshold": overlap_threshold,
                "neg_pos_ratio": neg_pos_ratio, "neg_overlap": neg_overlap,
                "loc_loss_weight": loc_loss_weight,
                "conf_loss_weight": conf_loss_weight,
                "match_type": match_type, "normalize": normalize},
               out_slots=("Loss",), name=name)


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     name=None):
    """Decode + multiclass NMS (reference: detection.py:213). ``loc``
    [N, P, 4], ``scores`` [N, P, C] (post-softmax). Output
    [N, keep_top_k, 6] rows (label, score, x1, y1, x2, y2), label -1
    padding — the dense analog of the reference's LoD output."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    scores_t = _nn.transpose(scores, [0, 2, 1])     # [N, C, P]
    return _nn.multiclass_nms(
        decoded, scores_t, score_threshold=score_threshold,
        nms_top_k=nms_top_k, keep_top_k=keep_top_k,
        nms_threshold=nms_threshold, background_label=background_label,
        name=name)


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD detection head over multiple feature maps (reference:
    detection.py:1497): per-map loc/conf convs + prior boxes,
    concatenated. Returns (mbox_locs [N, P, 4], mbox_confs [N, P, C],
    boxes [P, 4], variances [P, 4])."""
    if isinstance(inputs, (list, tuple)) is False:
        inputs = [inputs]
    n_maps = len(inputs)
    if min_sizes is None:
        # reference ratio schedule (detection.py:1657)
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n_maps - 2.0)) if n_maps > 2 \
            else 100
        min_sizes.append(base_size * 0.1)
        max_sizes.append(base_size * 0.2)
        for r in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * r / 100.0)
            max_sizes.append(base_size * (r + step) / 100.0)
        min_sizes = min_sizes[:n_maps]
        max_sizes = max_sizes[:n_maps]
    locs, confs, boxes_l, vars_l = [], [], [], []
    for i, x in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        mins = mins if isinstance(mins, (list, tuple)) else [mins]
        maxs = (maxs if isinstance(maxs, (list, tuple)) else [maxs]) \
            if maxs is not None else None
        ars = aspect_ratios[i]
        ars = ars if isinstance(ars, (list, tuple)) else [ars]
        step_pair = (steps[i] if steps else
                     ((step_w[i] if step_w else 0.0),
                      (step_h[i] if step_h else 0.0)))
        if not isinstance(step_pair, (list, tuple)):
            step_pair = (step_pair, step_pair)
        box, var = prior_box(
            x, image, mins, maxs, ars, variance, flip, clip,
            step_pair, offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order)
        # priors per cell: mirror the prior_box op's aspect-ratio dedup
        # (1.0 implicit; flip adds the reciprocal of each non-1 ratio)
        uniq = [1.0]
        for a in ars:
            if not any(abs(a - u) < 1e-6 for u in uniq):
                uniq.append(a)
                if flip:
                    uniq.append(1.0 / a)
        n_priors = len(mins) * len(uniq) + (len(maxs) if maxs else 0)
        loc = _nn.conv2d(x, n_priors * 4, kernel_size, stride=stride,
                         padding=pad)
        conf = _nn.conv2d(x, n_priors * num_classes, kernel_size,
                          stride=stride, padding=pad)
        # [N, P_i*4, H, W] -> [N, H, W, P_i*4] -> [N, -1, 4]
        loc = _nn.transpose(loc, [0, 2, 3, 1])
        conf = _nn.transpose(conf, [0, 2, 3, 1])
        locs.append(_nn.reshape(loc, [0, -1, 4]))
        confs.append(_nn.reshape(conf, [0, -1, num_classes]))
        boxes_l.append(_nn.reshape(box, [-1, 4]))
        vars_l.append(_nn.reshape(var, [-1, 4]))
    mbox_locs = _nn.concat(locs, axis=1)
    mbox_confs = _nn.concat(confs, axis=1)
    boxes = _nn.concat(boxes_l, axis=0)
    variances = _nn.concat(vars_l, axis=0)
    return mbox_locs, mbox_confs, boxes, variances


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None, offset=0.5,
                     name=None):
    """RPN anchors and their variances per feature-map cell [H, W, A, 4]
    (reference: detection.py:1753)."""
    attrs = {
        "anchor_sizes": list(anchor_sizes or [64.0, 128.0, 256.0, 512.0]),
        "aspect_ratios": list(aspect_ratios or [0.5, 1.0, 2.0]),
        "variances": list(variance),
        "stride": list(stride or [16.0, 16.0]),
        "offset": offset,
    }
    return _op("anchor_generator", {"Input": input}, attrs,
               out_slots=("Anchors", "Variances"), name=name,
               stop_gradient=True)
