"""Serving-plane ops: slot-indexed KV-cache maintenance for the
continuous-batching decode path (serving.py, models/transformer.py
``build_decode_step``).

The cache is ONE dense device-resident tensor shared by every in-flight
request — axis 0 is the batch *slot*, axis 1 the time position — so a
single decode program serves requests at different positions. Per-slot
positions come in as a ``Pos [S]`` vector.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op

NEG_INF = -1e9


@register_op("kv_cache_write", no_grad=True)
def _kv_cache_write(ins, attrs, device):
    """Write this step's K/V rows into the slot-indexed cache.

    inputs:
      Cache [S, T, ...]  — the persistable KV ring (slot-major)
      New   [S, 1, ...]  — the freshly projected per-slot row
      Pos   [S] int      — per-slot write position (clipped to T-1, so a
                           frozen/dead slot rewriting its last position
                           stays in bounds)
    output: Out [S, T, ...] — cache with ``Out[s, Pos[s]] = New[s, 0]``.
    """
    cache = ins["Cache"][0]
    new = ins["New"][0]
    pos = ins["Pos"][0].to(torch.int64).clamp(0, cache.shape[1] - 1)
    out = cache.clone()
    slots = torch.arange(cache.shape[0], device=cache.device)
    out[slots, pos] = new.squeeze(1).to(cache.dtype)
    return {"Out": [out]}


@register_op("kv_step_bias", no_grad=True)
def _kv_step_bias(ins, attrs, device):
    """Per-slot additive attention bias over the KV cache: position j of
    slot s is visible iff ``j <= Pos[s]``.

    inputs: Pos [S] int; attrs: length (the cache's T axis).
    output: Out [S, 1, 1, T] float32 — 0 where visible, -1e9 elsewhere.
    """
    pos = ins["Pos"][0].to(torch.int64)
    t = int(attrs["length"])
    vis = torch.arange(t, device=pos.device)[None, :] <= pos[:, None]
    bias = torch.where(vis, 0.0, NEG_INF).to(torch.float32)
    return {"Out": [bias[:, None, None, :]]}
