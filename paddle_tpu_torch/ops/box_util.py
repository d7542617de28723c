"""Shared box geometry of the detection ops (the JAX package's
ops/box_util.py): one IoU for every pairwise-xyxy consumer
(``iou_similarity``, ``ssd_loss``), zero-clamped edge lengths and no +1
pixel offsets, and the greedy bipartite match."""

from __future__ import annotations

import torch


def xyxy_area(b):
    return (torch.clamp_min(b[..., 2] - b[..., 0], 0.0)
            * torch.clamp_min(b[..., 3] - b[..., 1], 0.0))


def iou_xyxy(a, b):
    """Pairwise IoU: a [..., M, 4], b [..., G, 4] -> [..., M, G]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = xyxy_area(a)[..., :, None] + xyxy_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-10),
                       torch.zeros((), dtype=inter.dtype,
                                   device=inter.device))


def greedy_bipartite_match(dist):
    """Greedy bipartite matching (reference: detection/bipartite_match_op.cc
    BipartiteMatch) over a batch: ``dist`` [n, m, p]; per image, take the
    global arg-max of the matrix, record column -> row, erase that row and
    column, ``min(m, p)`` times. Returns col_match [n, p] int32 (-1
    unmatched).

    Every image takes its step at once, so a step is one arg-max over the
    batch and two small scatters; the steps unroll into straight-line
    device code (no host read, so a captured step may hold them), as the
    JAX package unrolls them below 64. Ties take the first index in
    row-major order, as ``jnp.argmax`` does."""
    n, m, p = dist.shape
    d = dist.to(torch.float32).clone()
    col = torch.full((n, p), -1, dtype=torch.int32, device=d.device)
    batch = torch.arange(n, device=d.device)
    neg = torch.full((), -1.0, device=d.device)
    for _ in range(min(m, p)):
        idx = torch.argmax(d.reshape(n, m * p), dim=1)
        r, c = idx // p, idx % p
        ok = d.reshape(n, m * p).gather(1, idx[:, None])[:, 0] > 0
        # col[i, c_i] = r_i where the best pair is positive
        old = col.gather(1, c[:, None])
        col.scatter_(1, c[:, None],
                     torch.where(ok[:, None], r[:, None].to(torch.int32),
                                 old))
        # erase row r_i and column c_i of the images that matched
        d[batch, r] = torch.where(ok[:, None], neg, d[batch, r])
        cidx = c[:, None, None].expand(n, m, 1)
        d.scatter_(2, cidx, torch.where(ok[:, None, None], neg,
                                        d.gather(2, cidx)))
    return col
