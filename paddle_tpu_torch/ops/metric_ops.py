"""Evaluation-metric ops: chunk_eval, precision_recall,
positive_negative_pair.

The JAX package's ``ops/metric_ops.py`` (the reference's chunk_eval_op.h,
metrics/precision_recall_op.h, positive_negative_pair_op.h): LoD
sequences are padded [B, T] tensors with a SeqLength input, and the
metric outputs (counts and ratios) are the reference's. All on the
device, with no host read: ``chunk_eval``'s walk along a row is a loop
of T elementwise steps over the batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op


def _x(ins, slot="X", i=0):
    v = ins.get(slot)
    return v[i] if v else None


def _shift_right(x, fill):
    """x[:, t-1] at t (``fill`` at 0)."""
    return F.pad(x[:, :-1], (1, 0), value=fill)


def _chunk_marks(tags, types, valid, scheme, other_type):
    """(starts, ends) bool marks a position of one tag sequence.

    IOB: tag 0 = begin, 1 = inside. plain: every tag is its own chunk. A
    chunk starts at B, or at I whose predecessor is padding, other or a
    different type (the reference's tolerance of malformed sequences,
    ChunkEvalKernel::GetSegments); it ends before a start or at the
    sequence's end."""
    is_chunk = valid & (types != other_type)
    if scheme == "plain":
        return is_chunk, is_chunk
    prev_chunk = _shift_right(is_chunk, False)
    prev_type = _shift_right(types, -1)
    begins = is_chunk & ((tags == 0) | ~prev_chunk | (prev_type != types))
    next_begin = F.pad(begins[:, 1:], (0, 1), value=False)
    next_chunk = F.pad(is_chunk[:, 1:], (0, 1), value=False)
    return begins, is_chunk & (next_begin | ~next_chunk)


@register_op("chunk_eval", no_grad=True)
def _chunk_eval(ins, attrs, device):
    """Chunk-level precision / recall / F1 for sequence tagging
    (reference: chunk_eval_op.h). Inference / Label [B, T] int labels
    encoded ``chunk_type * num_tag_types + tag`` (IOB: B=0, I=1),
    SeqLength [B] optional. Schemes: 'IOB' (default) and 'plain'."""
    infer = _x(ins, "Inference")
    label = _x(ins, "Label")
    length = _x(ins, "SeqLength")
    num_chunk_types = int(attrs["num_chunk_types"])
    scheme = attrs.get("chunk_scheme", "IOB")
    excluded = set(int(t) for t in attrs.get("excluded_chunk_types", []))
    if scheme not in ("IOB", "plain"):
        raise ValueError(f"chunk_eval: unsupported scheme '{scheme}' "
                         "(IOB and plain implemented)")
    num_tags = 1 if scheme == "plain" else 2
    other_type = num_chunk_types  # labels >= num_chunk_types * num_tags
    infer = infer.reshape(infer.shape[0], -1).to(torch.int64)
    label = label.reshape(label.shape[0], -1).to(torch.int64)
    b, t = infer.shape
    pos = torch.arange(t, device=infer.device)[None, :]
    valid = (pos < length.reshape(-1, 1).to(torch.int64)
             if length is not None
             else torch.ones((b, t), dtype=torch.bool, device=infer.device))

    def split(x):
        types = torch.where(x < other_type * num_tags, x // num_tags,
                            other_type)
        for e in excluded:
            types = torch.where(types == e, other_type, types)
        return x % num_tags, types

    i_tag, i_type = split(infer)
    l_tag, l_type = split(label)
    i_start, i_end = _chunk_marks(i_tag, i_type, valid, scheme, other_type)
    l_start, l_end = _chunk_marks(l_tag, l_type, valid, scheme, other_type)
    # a chunk is correct iff both start it at p with one type, it matches
    # (no one-sided start, equal types) through its extent, and both end
    # it at the same q: a left-to-right walk a row that tracks whether
    # the jointly started chunk still matches
    both_start = i_start & l_start & (i_type == l_type)
    run_ok = (i_type == l_type) & valid
    active = torch.zeros((b,), dtype=torch.bool, device=infer.device)
    num_correct = torch.zeros((), dtype=torch.int64, device=infer.device)
    for s in range(t):
        bs = both_start[:, s]
        active = torch.where(bs, True, active)
        active = active & run_ok[:, s] & ~((l_start[:, s] | i_start[:, s])
                                           & ~bs)
        num_correct = num_correct + (active & l_end[:, s] & i_end[:, s]).sum()
        active = active & ~(l_end[:, s] | i_end[:, s])
    num_infer = i_start.sum()
    num_label = l_start.sum()
    n_i, n_l, n_c = (v.to(torch.float32)
                     for v in (num_infer, num_label, num_correct))
    precision = torch.where(n_i > 0, n_c / n_i, 0.0)
    recall = torch.where(n_l > 0, n_c / n_l, 0.0)
    f1 = torch.where(precision + recall > 0,
                     2 * precision * recall / (precision + recall), 0.0)
    return {
        "Precision": [precision.reshape(1)],
        "Recall": [recall.reshape(1)],
        "F1-Score": [f1.reshape(1)],
        "NumInferChunks": [num_infer.to(torch.int64).reshape(1)],
        "NumLabelChunks": [num_label.to(torch.int64).reshape(1)],
        "NumCorrectChunks": [num_correct.to(torch.int64).reshape(1)],
    }


@register_op("precision_recall", no_grad=True)
def _precision_recall(ins, attrs, device):
    """Multi-class precision / recall / F1, macro and micro averaged
    (reference: metrics/precision_recall_op.h). MaxProbs [N, 1] with
    Indices [N, 1] (the argmax class), Labels [N, 1]; optional Weights.
    Outputs BatchMetrics [6] (macro P/R/F1, micro P/R/F1) and
    AccumMetrics / AccumStatesInfo for streaming (accumulated with the
    optional StatesInfo input [C, 4])."""
    indices = _x(ins, "Indices").reshape(-1).to(torch.int64)
    labels = _x(ins, "Labels").reshape(-1).to(torch.int64)
    weights = _x(ins, "Weights")
    states_in = _x(ins, "StatesInfo")
    c = int(attrs["class_number"])
    w = (weights.reshape(-1).to(torch.float32) if weights is not None
         else torch.ones(labels.shape, dtype=torch.float32,
                         device=labels.device))
    pred = F.one_hot(indices, c).to(torch.float32)
    lab = F.one_hot(labels, c).to(torch.float32)
    tp = (pred * lab * w[:, None]).sum(0)                 # [C]
    fp = (pred * (1 - lab) * w[:, None]).sum(0)
    fn = ((1 - pred) * lab * w[:, None]).sum(0)
    tn = w.sum() - tp - fp - fn

    def metrics(tp, fp, fn):
        prec = torch.where(tp + fp > 0, tp / (tp + fp), 1.0)
        rec = torch.where(tp + fn > 0, tp / (tp + fn), 1.0)
        f1 = torch.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
        return prec, rec, f1

    def both(tp, fp, fn):
        mp, mr, mf = metrics(tp, fp, fn)
        up, ur, uf = metrics(tp.sum(), fp.sum(), fn.sum())
        return torch.stack([mp.mean(), mr.mean(), mf.mean(), up, ur, uf])

    states = torch.stack([tp, fp, tn, fn], dim=1)          # [C, 4]
    if states_in is not None:
        states = states + states_in.to(torch.float32)
    return {
        "BatchMetrics": [both(tp, fp, fn)],
        "AccumMetrics": [both(states[:, 0], states[:, 1], states[:, 3])],
        "AccumStatesInfo": [states],
    }


@register_op("positive_negative_pair", no_grad=True)
def _positive_negative_pair(ins, attrs, device):
    """Ranking pair statistics a query (reference:
    positive_negative_pair_op.h): among same-query item pairs with
    different labels, the pairs Score ranks correctly (positive),
    wrongly (negative), and ties (neutral)."""
    score = _x(ins, "Score").reshape(-1).to(torch.float32)
    label = _x(ins, "Label").reshape(-1).to(torch.float32)
    qid = _x(ins, "QueryID").reshape(-1).to(torch.int64)
    acc = [_x(ins, s) for s in ("AccumulatePositivePair",
                                "AccumulateNegativePair",
                                "AccumulateNeutralPair")]
    n = score.shape[0]
    same_q = qid[:, None] == qid[None, :]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=score.device), diagonal=1)
    pairs = same_q & upper & (label[:, None] != label[None, :])
    hi_lab = label[:, None] > label[None, :]
    hi_score = score[:, None] > score[None, :]
    eq_score = score[:, None] == score[None, :]
    pos = (pairs & ~eq_score & (hi_lab == hi_score)).sum()
    neu = (pairs & eq_score).sum()
    neg = pairs.sum() - pos - neu
    pos, neg, neu = (v.to(torch.float32) for v in (pos, neg, neu))
    if all(a is not None for a in acc):
        pos = pos + acc[0].reshape(())
        neg = neg + acc[1].reshape(())
        neu = neu + acc[2].reshape(())
    elif any(a is not None for a in acc):
        raise ValueError(
            "positive_negative_pair: Accumulate{Positive,Negative,Neutral}"
            "Pair must be wired together or not at all")
    return {"PositivePair": [pos.reshape(1)],
            "NegativePair": [neg.reshape(1)],
            "NeutralPair": [neu.reshape(1)]}
