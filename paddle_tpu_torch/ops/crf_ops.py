"""Structured-prediction ops: linear-chain CRF, CTC loss, edit distance
and CTC alignment.

The JAX package's ``ops/crf_ops.py`` (the reference's
linear_chain_crf_op.cc, crf_decoding_op.cc, warpctc_op.cc over the
warp-ctc library, edit_distance_op.cc, ctc_align_op.h). Ragged LoD inputs
are padded ``[B, T, ...]`` batches with ``Length`` vectors, as there. The
dynamic programmes (the CRF's forward algorithm, Viterbi, CTC's alpha
recursion, Levenshtein rows) are Python loops of T steps of plain tensor
ops inside the op, so a captured step holds every step's kernels, as the
``lstm`` op's loop (ops/rnn_ops.py); no step reads a value on the host.
The two losses differentiate through the derived grad op, which re-runs
the loop under autograd. Log-space arithmetic runs in at least f32 (a
bf16 input under AMP is promoted, as the JAX ops promote it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op

NEG = -1e30


def _lengths(ins, slot, b, t, device):
    """The ``slot`` lengths as int64 [B] (squeezed from [B, 1]); ``t`` for
    every row when the slot is absent."""
    v = ins.get(slot)
    ln = v[0] if v else None
    if ln is None:
        return torch.full((b,), t, dtype=torch.int64, device=device)
    if ln.dim() > 1:
        ln = ln.squeeze(-1)
    return ln.to(torch.int64)


def _promoted(x):
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _marks(lengths, t):
    """(live [B, T], is_last [B, T]) of the padded layout."""
    steps = torch.arange(t, device=lengths.device)
    return (steps[None, :] < lengths[:, None],
            steps[None, :] == (lengths[:, None] - 1))


def _add_end(x, last_t, end):
    return x + torch.where(last_t[:, None], end[None, :], 0.0)


@register_op("linear_chain_crf", diff_inputs=("Emission", "Transition"))
def _linear_chain_crf(ins, attrs, device):
    """Negative log-likelihood of a linear-chain CRF.

    inputs: Emission [B, T, C] unary scores; Transition [C+2, C] (row 0 =
    start scores, row 1 = end scores, rows 2.. = pairwise a->b, the
    reference's layout); Label [B, T] int; Length [B] optional.
    outputs: LogLikelihood [B, 1]: despite the (reference-inherited) name,
    the NEGATIVE log-likelihood -log p(label|x), as the reference kernel's
    ``return -ll`` (linear_chain_crf_op.h:193): minimize it directly.
    """
    em = _promoted(ins["Emission"][0])
    trans = ins["Transition"][0].to(em.dtype)
    label = ins["Label"][0]
    if label.dim() > 2:
        label = label.squeeze(-1)
    b, t, c = em.shape
    lengths = _lengths(ins, "Length", b, t, em.device)
    start, end, pair = trans[0], trans[1], trans[2:]
    live, is_last = _marks(lengths, t)

    # the partition function: the forward algorithm in log space; the
    # end scores added once, at each row's last live step
    alpha = _add_end(start[None, :] + em[:, 0, :], is_last[:, 0], end)
    for s in range(1, t):
        scores = alpha[:, :, None] + pair[None, :, :]   # [B, Cprev, C]
        new = torch.logsumexp(scores, dim=1) + em[:, s, :]
        alpha = torch.where(live[:, s, None], new, alpha)
        alpha = _add_end(alpha, is_last[:, s], end)
    log_z = torch.logsumexp(alpha, dim=-1)              # [B]

    # the gold path's score
    lab = label.to(torch.int64)
    emit = torch.gather(em, 2, lab[:, :, None])[..., 0]  # [B, T]
    emit_sum = (emit * live.to(em.dtype)).sum(1)
    trans_pair = pair[lab[:, :-1], lab[:, 1:]]          # [B, T-1]
    trans_sum = (trans_pair * live[:, 1:].to(em.dtype)).sum(1)
    last_idx = torch.clamp(lengths - 1, 0, t - 1)
    last_tag = torch.gather(lab, 1, last_idx[:, None])[:, 0]
    gold = emit_sum + trans_sum + start[lab[:, 0]] + end[last_tag]
    return {"LogLikelihood": [(log_z - gold)[:, None]]}


@register_op("crf_decoding", no_grad=True)
def _crf_decoding(ins, attrs, device):
    """Viterbi decode (reference: operators/crf_decoding_op.cc).

    inputs: Emission [B, T, C], Transition [C+2, C], Length [B] optional.
    outputs: ViterbiPath [B, T] int64 (padding positions 0). Ties go to
    the lowest tag, as ``jnp.argmax``'s.
    """
    em = _promoted(ins["Emission"][0])
    trans = ins["Transition"][0].to(em.dtype)
    b, t, c = em.shape
    lengths = _lengths(ins, "Length", b, t, em.device)
    start, end, pair = trans[0], trans[1], trans[2:]
    live, is_last = _marks(lengths, t)
    ident = torch.arange(c, device=em.device)[None, :]

    delta = _add_end(start[None, :] + em[:, 0, :], is_last[:, 0], end)
    ptrs = []
    for s in range(1, t):
        scores = delta[:, :, None] + pair[None, :, :]   # [B, Cprev, C]
        best, best_prev = torch.max(scores, dim=1)
        new = best + em[:, s, :]
        delta = _add_end(torch.where(live[:, s, None], new, delta),
                         is_last[:, s], end)
        # dead steps backtrack to themselves (the identity pointer)
        ptrs.append(torch.where(live[:, s, None], best_prev, ident))
    tag = torch.argmax(delta, dim=-1)                   # [B]
    path = [tag]
    for ptr in reversed(ptrs):
        tag = torch.gather(ptr, 1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)               # [B, T]
    return {"ViterbiPath": [(path * live).to(torch.int64)]}


@register_op("warpctc", diff_inputs=("Logits",))
def _warpctc(ins, attrs, device):
    """CTC loss (reference: operators/warpctc_op.cc over warp-ctc; here
    the log-space alpha recursion).

    inputs: Logits [B, T, C] unnormalized; Label [B, L] int (padded with
    ``blank``); LogitsLength [B] optional; LabelLength [B] optional.
    attrs: blank (default 0), norm_by_times (divide each loss by its
    logit length).
    outputs: Loss [B, 1] (positive NLL).
    """
    logits = _promoted(ins["Logits"][0])
    label = ins["Label"][0].to(torch.int64)
    b, t, c = logits.shape
    nl = label.shape[1]
    blank = int(attrs.get("blank", 0))
    dev = logits.device
    logit_len = _lengths(ins, "LogitsLength", b, t, dev)
    label_len = _lengths(ins, "LabelLength", b, nl, dev)
    logp = torch.log_softmax(logits, dim=-1)            # [B, T, C]

    # the extended label sequence: blank y1 blank y2 ... yL blank
    s = 2 * nl + 1
    ext = torch.full((b, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = label
    ext_len = 2 * label_len + 1
    valid = torch.arange(s, device=dev)[None, :] < ext_len[:, None]
    # the skip s-2 -> s is allowed where ext[s] is no blank and differs
    # from ext[s-2]
    ext_m2 = F.pad(ext, (2, 0), value=-1)[:, :-2]
    can_skip = (ext != blank) & (ext != ext_m2)

    def emit(logp_t):                                   # [B, C] -> [B, S]
        return torch.gather(logp_t, 1, ext)

    e0 = emit(logp[:, 0])
    cols = [e0[:, :1]]
    if s > 1:
        cols.append(torch.where(label_len > 0, e0[:, 1], NEG)[:, None])
        cols.append(torch.full((b, s - 2), NEG, dtype=logp.dtype,
                               device=dev))
    alpha = torch.cat(cols, dim=1)
    live = torch.arange(t, device=dev)[None, :] < logit_len[:, None]
    for st in range(1, t):
        prev1 = F.pad(alpha, (1, 0), value=NEG)[:, :-1]
        prev2 = torch.where(can_skip, F.pad(alpha, (2, 0), value=NEG)[:, :-2],
                            NEG)
        tot = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new = torch.where(valid, tot + emit(logp[:, st]), NEG)
        alpha = torch.where(live[:, st, None], new, alpha)

    idx_last = torch.clamp(ext_len - 1, 0, s - 1)
    a_last = torch.gather(alpha, 1, idx_last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1,
                          torch.clamp(idx_last - 1, min=0)[:, None])[:, 0]
    # an empty label has only the single blank path: a_prev would alias
    # a_last and count it twice
    a_prev = torch.where(ext_len >= 2, a_prev, NEG)
    loss = -torch.logaddexp(a_last, a_prev)
    if attrs.get("norm_by_times", False):
        loss = loss / logit_len.to(loss.dtype)
    return {"Loss": [loss[:, None]]}


@register_op("edit_distance", no_grad=True)
def _edit_distance(ins, attrs, device):
    """Levenshtein distance a row (reference: operators/edit_distance_op.cc).
    Hyps [B, L1], Refs [B, L2] int padded; HypsLength / RefsLength [B]
    optional; attr ``normalized`` divides by the ref length. outputs: Out
    [B, 1] f32, SequenceNum [1].

    One step a hypothesis position; a row's left-to-right minimum
    new[j+1] = min(new[j] + 1, c[j]) is ``j + min(new[0] + 1,
    cummin_k(c[k] - k))``, exact in f32 for these small integers."""
    hyp = ins["Hyps"][0].to(torch.int64)
    ref = ins["Refs"][0].to(torch.int64)
    b, l1 = hyp.shape
    l2 = ref.shape[1]
    dev = hyp.device
    hlen = _lengths(ins, "HypsLength", b, l1, dev)
    rlen = _lengths(ins, "RefsLength", b, l2, dev)
    cols = torch.arange(l2 + 1, dtype=torch.float32, device=dev)
    # positions past a row's ref length hold its length
    row = torch.minimum(cols[None, :].expand(b, l2 + 1),
                        rlen[:, None].to(torch.float32))
    j = cols[:l2]
    live_r = j[None, :] < rlen[:, None]                 # [B, L2]
    r_idx = rlen.clamp(0, l2)[:, None]  # gathers clamp, as the JAX ones
    for i in range(l1):
        live_h = i < hlen                               # [B]
        sub_cost = (hyp[:, i, None] != ref).to(torch.float32)
        first = torch.where(live_h, float(i + 1), row[:, 0])
        c = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + sub_cost)
        run = torch.cummin(c - j[None, :], dim=1).values
        tail = j[None, :] + torch.minimum(first[:, None] + 1.0, run)
        # past the ref's length each entry repeats the one before it
        held = torch.cat([first[:, None], tail], dim=1)
        keep = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                          live_r], dim=1)
        last_live = torch.gather(held, 1, r_idx)
        new = torch.where(keep, held, last_live)
        row = torch.where(live_h[:, None], new, row)
    dist = torch.gather(row, 1, r_idx)[:, 0]
    if attrs.get("normalized", False):
        dist = dist / torch.clamp(rlen.to(dist.dtype), min=1.0)
    return {"Out": [dist[:, None]],
            "SequenceNum": [torch.full((1,), b, dtype=torch.int64,
                                       device=dev)]}


@register_op("ctc_align", no_grad=True)
def _ctc_align(ins, attrs, device):
    """CTC decode alignment: merge repeats, drop blanks (reference:
    ctc_align_op.h). Dense form: Input [B, T] int tokens (+ optional
    InputLength [B]); Output [B, T] left-compacted with ``padding_value``
    (default 0) fill, OutputLength [B, 1] kept tokens a row; a row with
    nothing kept emits -1 at position 0 (the reference's empty-sequence
    convention)."""
    x = ins["Input"][0]
    li = ins.get("InputLength")
    length = li[0] if li else None
    blank = int(attrs.get("blank", 0))
    merge = bool(attrs.get("merge_repeated", True))
    pad_v = int(attrs.get("padding_value", 0))
    x2 = x.reshape(x.shape[0], -1).to(torch.int64)
    b, t = x2.shape
    pos = torch.arange(t, device=x2.device)[None, :]
    valid = (pos < length.reshape(-1, 1) if length is not None
             else torch.ones((b, t), dtype=torch.bool, device=x2.device))
    prev = F.pad(x2[:, :-1], (1, 0), value=-1)
    keep = valid & (x2 != blank)
    if merge:
        keep = keep & (x2 != prev)
    # left-compact the kept tokens (a stable order)
    order = torch.sort((~keep).to(torch.int32), dim=1, stable=True).indices
    compact = torch.gather(x2, 1, order)
    n_keep = keep.sum(1)
    out = torch.where(pos < n_keep[:, None], compact, pad_v)
    out = torch.where((n_keep == 0)[:, None] & (pos == 0), -1, out)
    return {"Output": [out.to(x.dtype)],
            "OutputLength": [n_keep.to(torch.int32).reshape(-1, 1)]}
