"""Tensor creation & manipulation ops.

Random fills draw from the host-seeded ``torch.Generator`` the
interpreter hands them (seeded per op from the run's step seed, see
core/interp.py), so a seeded run is reproducible on one device; they are
``host_rng`` ops, and a block that holds one (a startup program) runs
eagerly, never as a CUDA graph. The streams differ from the JAX
package's PRNG: weights carry across by name (io.scope_from_numpy), never
by re-drawing them.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.framework import torch_dtype


def _x(ins, slot="X", i=0):
    return ins[slot][i]


@register_op("fill_constant", no_grad=True)
def _fill_constant(ins, attrs, device):
    shape = tuple(attrs.get("shape", []))
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(shape, attrs.get("value", 0.0), dtype=dtype,
                               device=device)]}


@register_op("fill_zeros_like", no_grad=True)
def _fill_zeros_like(ins, attrs, device):
    return {"Out": [torch.zeros_like(_x(ins))]}


@register_op("fill_any_like", no_grad=True)
def _fill_any_like(ins, attrs, device):
    return {"Out": [torch.full_like(_x(ins), attrs.get("value", 0.0))]}


@register_op("gaussian_random", no_grad=True, host_rng=True)
def _gaussian_random(ins, attrs, device, generator=None):
    shape = tuple(attrs["shape"])
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    out = torch.empty(shape, dtype=dtype, device=device).normal_(
        attrs.get("mean", 0.0), attrs.get("std", 1.0), generator=generator)
    return {"Out": [out]}


@register_op("uniform_random", no_grad=True, host_rng=True)
def _uniform_random(ins, attrs, device, generator=None):
    shape = tuple(attrs["shape"])
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    out = torch.empty(shape, dtype=dtype, device=device).uniform_(
        attrs.get("min", -1.0), attrs.get("max", 1.0), generator=generator)
    return {"Out": [out]}


@register_op("assign")
def _assign(ins, attrs, device):
    return {"Out": [_x(ins)]}


@register_op("assign_value", no_grad=True)
def _assign_value(ins, attrs, device):
    shape = tuple(attrs["shape"])
    vals = np.asarray(attrs["values"], dtype=np.float64).reshape(shape)
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.from_numpy(vals).to(device=device, dtype=dtype)]}


@register_op("reshape2")
def _reshape2(ins, attrs, device):
    x = _x(ins)
    # Fluid semantics: 0 copies the input dim, -1 infers (reshape_op.cc).
    shape = [x.shape[i] if d == 0 else d for i, d in enumerate(attrs["shape"])]
    return {"Out": [x.reshape(shape)], "XShape": []}


@register_op("split")
def _split(ins, attrs, device):
    x = _x(ins)
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    num = attrs.get("num", 0)
    if x.shape[axis] % num:
        raise ValueError(
            f"split: dim {axis} of size {x.shape[axis]} is not divisible "
            f"into {num} equal parts")
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}


@register_op("unsqueeze2")
def _unsqueeze2(ins, attrs, device):
    x = _x(ins)
    for ax in sorted(attrs["axes"]):
        x = x.unsqueeze(ax)
    return {"Out": [x], "XShape": []}


@register_op("scatter", diff_inputs=("X", "Updates"))
def _scatter(ins, attrs, device):
    x, ids, updates = _x(ins), _x(ins, "Ids"), _x(ins, "Updates")
    out = x.clone()
    if attrs.get("overwrite", True):
        out[ids] = updates.to(x.dtype)
    else:
        out.index_add_(0, ids, updates.to(x.dtype))
    return {"Out": [out]}


@register_op("one_hot", no_grad=True)
def _one_hot(ins, attrs, device):
    x = _x(ins)
    if x.dim() > 1 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    classes = torch.arange(attrs["depth"], device=x.device)
    hot = x.unsqueeze(-1) == classes
    return {"Out": [hot.to(torch_dtype(attrs.get("dtype", "float32")))]}


def _lookup_table_grad_maker(op, block, out_grads, provide, should_skip):
    """A dense table takes the derived grad op (a scatter-add into W);
    the row-sparse gradient of ``is_sparse=True`` is not ported."""
    if op.attrs.get("is_sparse", False):
        raise NotImplementedError(
            "lookup_table(is_sparse=True): the row-sparse gradient is not "
            "ported; build the embedding with is_sparse=False")
    return None


@register_op("lookup_table", diff_inputs=("W",),
             grad_maker=_lookup_table_grad_maker,
             doc="embedding lookup over int ids (lookup_table_op.cc)")
def _lookup_table(ins, attrs, device):
    w, ids = _x(ins, "W"), _x(ins, "Ids")
    # [N, 1] column-ids convention: squeeze unless the layer says the ids
    # are already a padded [b, t] batch (a [b, 1] batch is ambiguous).
    squeeze_last = attrs.get(
        "squeeze_last", ids.dim() > 1 and ids.shape[-1] == 1)
    if squeeze_last:
        ids = ids.squeeze(-1)
    out = w[ids]
    # Fluid semantics: no padding when absent; negative = vocab + idx.
    padding_idx = attrs.get("padding_idx", None)
    if padding_idx is not None:
        if padding_idx < 0:
            padding_idx = w.shape[0] + padding_idx
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return {"Out": [out]}


@register_op("top_k", no_grad=True)
def _top_k(ins, attrs, device):
    """The k largest entries of the last dim, largest first, and their
    int64 indices; among equal entries the lower index comes first, as
    ``jax.lax.top_k`` orders them (the first k of a stable descending
    sort: ``torch.topk`` promises no order among ties)."""
    k = attrs["k"]
    vals, idx = torch.sort(_x(ins), dim=-1, descending=True, stable=True)
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}


@register_op("arg_max", no_grad=True)
def _arg_max(ins, attrs, device):
    return {"Out": [torch.argmax(_x(ins), dim=attrs.get("axis", -1))]}


@register_op("where", diff_inputs=("X", "Y"))
def _where(ins, attrs, device):
    return {"Out": [torch.where(_x(ins, "Condition"), _x(ins), _x(ins, "Y"))]}


@register_op("dynamic_update", diff_inputs=("X", "Value"))
def _dynamic_update(ins, attrs, device):
    """Write Value at the (device-resident) position Index along axis 0
    of X. The index clamps into range like ``lax.dynamic_update_slice``,
    and stays a tensor so the op never syncs the host."""
    x = _x(ins)
    idx = ins["Index"][0].reshape(1).clamp(0, x.shape[0] - 1)
    v = ins["Value"][0].to(x.dtype).unsqueeze(0)
    return {"Out": [x.index_copy(0, idx, v)]}
