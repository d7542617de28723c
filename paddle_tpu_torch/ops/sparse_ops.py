"""Row-sparse gradients: the JAX package's SelectedRows equivalent
(reference: framework/selected_rows.h:32, lookup_table_op.cc grad kernel,
math/selected_rows_functor.cc MergeAdd, optimizers/adam_op.h lazy mode).

An embedding built with ``is_sparse=True`` gets ``lookup_table_sparse_grad``
instead of a dense [V, D] gradient: two ordinary variables,
``{W}@GRAD@ROWS`` (int32 [n]) and ``{W}@GRAD@VALUES`` ([n, D]). The
sparse optimizer ops consume them and write ONLY the touched rows of the
parameter and its accumulators; the dense gradient never exists.

Static shapes, no host read, so a captured step may hold every op here:

- **Merging duplicates** (``_merge_rows``): the ids are sorted (stable)
  and each run of equal ids is summed by a segmented doubling scan, a
  fixed order of elementwise adds, so the sums have the same bits on
  every device and every launch (no atomics: a CUDA ``index_add_`` adds
  duplicates in no fixed order). A run's sum lands in its last slot; the
  other slots get the sentinel row ``vocab`` (as the JAX package's
  ``mode="drop"`` sentinel; JAX puts the sums in the first ``#runs``
  slots, which changes nothing for the consumers).
- **Writing rows** (``_write_rows``): a PyTorch scatter to row ``vocab``
  is out of range, and clamping it to ``vocab - 1`` would overwrite a
  real row. Every update is computed as a row's new value and written
  with one indexed store; a sentinel slot writes row ``vocab - 1``'s own
  final value there (its new value where the batch touches it, else its
  old one), so every store into a row carries the same bits and the
  result does not depend on which store lands last. Untouched rows keep
  their bits.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op


def _g(ins, slot):
    v = ins.get(slot)
    return v[0] if v else None


@register_op("lookup_table_sparse_grad", no_grad=True)
def _lookup_table_sparse_grad(ins, attrs, device):
    """(Ids, dOut) -> (Rows [n] int32, Values [n, D]). Padding ids get the
    ``vocab_size`` sentinel, as the dense path zeroes their gradient."""
    ids, g = _g(ins, "Ids"), _g(ins, "GRAD::Out")
    vocab = int(attrs["vocab_size"])
    squeeze_last = attrs.get("squeeze_last",
                             ids.dim() > 1 and ids.shape[-1] == 1)
    if squeeze_last:
        ids = ids.squeeze(-1)
    rows = ids.reshape(-1).to(torch.int32)
    rows = torch.where(rows < 0, rows + vocab, rows)
    values = g.reshape(-1, g.shape[-1])
    padding_idx = attrs.get("padding_idx", None)
    if padding_idx is not None:
        if padding_idx < 0:
            padding_idx = vocab + padding_idx
        rows = torch.where(rows == padding_idx, vocab, rows)
    return {"Rows": [rows], "Values": [values]}


def _merge_rows(rows, values, vocab):
    """Each distinct row's summed values in one slot (the last of its run
    among the sorted ids); the other slots hold the ``vocab`` sentinel and
    zeros. Returns (rows [n] int64, values [n, D]) in sorted order."""
    n = rows.shape[0]
    order = torch.sort(rows.to(torch.int64), stable=True).indices
    r = rows.to(torch.int64)[order]
    v = values[order]
    # inclusive segmented scan: after the step of offset k, slot i holds
    # the sum of its run's slots in (i - 2k, i]. -0.0 is the exact
    # identity of +, so a slot with nothing to add keeps its bits.
    k = 1
    while k < n:
        same = (r[k:] == r[:-k]).unsqueeze(-1)
        v = torch.cat([v[:k], v[k:] + torch.where(same, v[:-k], -0.0)])
        k *= 2
    last = torch.ones(n, dtype=torch.bool, device=r.device)
    last[:-1] = r[1:] != r[:-1]
    merged_r = torch.where(last, r, vocab)
    merged_v = torch.where(last.unsqueeze(-1), v, 0.0)
    return merged_r, merged_v


def _safe(rows, vocab):
    """Rows to read a slot's old values from: the sentinel reads row
    ``vocab - 1`` (its result is never written there, ``_write_rows``)."""
    return torch.clamp(rows, max=vocab - 1)


def _write_rows(table, rows, new_rows):
    """``table`` with ``new_rows[i]`` stored at row ``rows[i]``; real rows
    are distinct, sentinel rows (``>= vocab``) store row ``vocab - 1``'s
    final value there (see the module docstring)."""
    vocab = table.shape[0]
    sentinel = rows >= vocab
    hit = rows == vocab - 1
    # the slot that updates row vocab - 1, if any (argmax: first True;
    # an index_select, as a 0-d index would be read on the host)
    j = torch.argmax(hit.to(torch.int32)).reshape(1)
    last_val = torch.where(hit.any(), new_rows.index_select(0, j)[0],
                           table[vocab - 1])
    idx = torch.where(sentinel, vocab - 1, rows)
    vals = torch.where(sentinel.unsqueeze(-1), last_val, new_rows)
    out = table.clone()
    out[idx] = vals.to(table.dtype)
    return out


@register_op("sgd_sparse", no_grad=True)
def _sgd_sparse(ins, attrs, device):
    p = _g(ins, "Param")
    rows, values = _g(ins, "Rows"), _g(ins, "Values")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    vocab = p.shape[0]
    # SGD is linear: one update of the merged sum per row (the JAX op
    # scatter-adds each duplicate; the sums differ only by rounding)
    rows_m, g_m = _merge_rows(rows, values.to(p.dtype), vocab)
    upd = (-lr) * g_m
    return {"ParamOut": [_write_rows(p, rows_m,
                                     p[_safe(rows_m, vocab)] + upd)]}


@register_op("momentum_sparse", no_grad=True)
def _momentum_sparse(ins, attrs, device):
    p, v = _g(ins, "Param"), _g(ins, "Velocity")
    rows, values = _g(ins, "Rows"), _g(ins, "Values")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    mu = attrs.get("mu", 0.9)
    vocab = p.shape[0]
    rows_m, g_m = _merge_rows(rows, values.to(p.dtype), vocab)
    safe = _safe(rows_m, vocab)
    v_rows = mu * v[safe] + g_m
    if attrs.get("use_nesterov", False):
        step = (g_m + mu * v_rows) * lr
    else:
        step = lr * v_rows
    return {"ParamOut": [_write_rows(p, rows_m, p[safe] + (-step))],
            "VelocityOut": [_write_rows(v, rows_m, v_rows)]}


@register_op("adam_sparse", no_grad=True)
def _adam_sparse(ins, attrs, device):
    """Lazy Adam on the touched rows only (reference: adam_op.h lazy_mode;
    untouched rows' moments do not decay)."""
    p = _g(ins, "Param")
    m1, m2 = _g(ins, "Moment1"), _g(ins, "Moment2")
    b1p, b2p = _g(ins, "Beta1Pow"), _g(ins, "Beta2Pow")
    rows, values = _g(ins, "Rows"), _g(ins, "Values")
    lr = _g(ins, "LearningRate").reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    vocab = p.shape[0]
    rows_m, g_m = _merge_rows(rows, values.to(m1.dtype), vocab)
    safe = _safe(rows_m, vocab)
    m1_r = b1 * m1[safe] + (1 - b1) * g_m
    m2_r = b2 * m2[safe] + (1 - b2) * torch.square(g_m)
    b1pn, b2pn = b1p * b1, b2p * b2
    lr_t = lr * torch.sqrt(1 - b2pn.reshape(())) / (1 - b1pn.reshape(()))
    upd = lr_t.to(p.dtype) * (m1_r / (torch.sqrt(m2_r) + eps)).to(p.dtype)
    return {
        "ParamOut": [_write_rows(p, rows_m, p[safe] + (-upd))],
        "Moment1Out": [_write_rows(m1, rows_m, m1_r)],
        "Moment2Out": [_write_rows(m2, rows_m, m2_r)],
        "Beta1PowOut": [b1pn],
        "Beta2PowOut": [b2pn],
    }
