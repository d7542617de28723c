"""Decoding ops: beam search.

The JAX package's redesign of the reference's beam-search operators:
beams are a dense ``[batch, beam]`` axis at static shapes, and each step
gathers the whole id history by parent beam (O(T) copies a step, no
branch and no host read), so a step can sit in a captured ``while`` body.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op


def _top_k_stable(x: torch.Tensor, k: int):
    """The k largest entries of the last dim, largest first, the lower
    index first among equal entries (``jax.lax.top_k``'s order; the
    ``top_k`` op's stable descending sort: ``torch.topk`` promises no
    order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("beam_search_step", no_grad=True)
def _beam_search_step(ins, attrs, device):
    """One beam-search expansion step.

    inputs:
      Ids      [B, K, T] int   — id history (position >= StepIdx is garbage)
      Scores   [B, K] f32      — cumulative log-probs per live hypothesis
      LogProbs [B, K, V] f32   — log p(next token) at the current position
      Finished [B, K] bool     — hypotheses that already emitted end_id
      StepIdx  [] or [1] int   — time position the chosen token is written
                                 to (read on the device, clamped into
                                 [0, T))
    attrs: end_id (int).
    outputs: Ids / Scores / Finished (updated), Parent [B, K] int64.

    A finished hypothesis extends only with end_id, at zero cost (every
    other token gets the dtype's lowest finite value), so it competes in
    the top-k on its frozen score.
    """
    ids = ins["Ids"][0]
    scores = ins["Scores"][0]
    logp = ins["LogProbs"][0]
    finished = ins["Finished"][0].to(torch.bool)
    end_id = int(attrs.get("end_id", 1))
    b, k, v = logp.shape
    t_len = ids.shape[2]

    eos_row = torch.full((v,), torch.finfo(logp.dtype).min, dtype=logp.dtype,
                         device=logp.device)
    # a fill (the value a kernel argument): an indexed store of a Python
    # number copies it from the host, which a captured graph refuses
    eos_row.narrow(0, end_id, 1).fill_(0.0)
    logp = torch.where(finished[:, :, None], eos_row, logp)

    total = scores[:, :, None] + logp                      # [B, K, V]
    top_scores, top_idx = _top_k_stable(total.reshape(b, k * v), k)
    parent = top_idx // v                                  # [B, K]
    token = (top_idx % v).to(ids.dtype)

    new_ids = ids.gather(1, parent[:, :, None].expand(b, k, t_len))
    t = ins["StepIdx"][0].reshape(1).to(torch.int64).clamp(0, t_len - 1)
    new_ids = new_ids.index_copy(2, t, token[:, :, None])
    new_finished = finished.gather(1, parent) | (token == end_id)
    return {"Ids": [new_ids], "Scores": [top_scores],
            "Finished": [new_finished], "Parent": [parent]}


@register_op("beam_gather", no_grad=True)
def _beam_gather(ins, attrs, device):
    """Per-row beam selection: X [B, K, ...] gathered by Index [B] ->
    [B, ...] (the final pick of a beam decode)."""
    x = ins["X"][0]
    idx = ins["Index"][0].to(torch.int64).reshape(-1)
    idx = idx.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand(
        (x.shape[0], 1) + tuple(x.shape[2:]))
    return {"Out": [x.gather(1, idx).squeeze(1)]}
