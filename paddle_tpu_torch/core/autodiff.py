"""Derived gradient ops.

As in the JAX package (whose ``<type>_grad`` kernels come from
``jax.vjp``), an op without a registered grad gets one built from its
forward compute: the grad op re-runs the forward under
``torch.enable_grad()`` and takes the vector-Jacobian product with
``torch.autograd.grad``. The executor runs blocks under
``torch.no_grad()``; autograd is on only inside a derived grad op, so no
graph outlives the op.

Grad op desc convention (produced by backward.append_backward):

- inputs: every forward input slot (same slot names), every forward
  output slot, plus ``GRAD::<out_slot>`` slots holding output gradients;
- outputs: ``GRAD::<in_slot>`` slots holding input gradients, aligned
  with the forward input slot; "" marks a hole (no grad needed);
- attrs: the forward attrs + ``fwd_input_slots`` / ``fwd_output_slots``
  + ``forward_op_idx`` (so random ops replay their forward's seed).

An op whose forward calls a hand-written kernel must stay differentiable
when a derived grad re-runs it (a ``scan`` body's attention and dropout):
with grad enabled those ops go through ``torch.autograd.Function``s whose
backward is their registered grad's arithmetic, since a kernel's outputs
are opaque to autograd on the card.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.core.registry import OpDef

GRAD_SLOT_PREFIX = "GRAD::"
_GRAD_META_ATTRS = ("fwd_input_slots", "fwd_output_slots", "forward_op_idx")
# the profiler range around a derived grad op's re-run of its forward
# (opened only while a profile is taken: a range costs ~10 us of host
# time, the test 0.2)
RERUN_RANGE = "derived_grad_forward_rerun"


def _rerun_range():
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(RERUN_RANGE)
    return contextlib.nullcontext()


def _floatp(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def vjp(ys, primals, cots):
    """``torch.autograd.grad(ys, primals, cots)`` (None for a primal no
    output reaches). Autograd runs the backward of CUDA tensors on its
    own device threads: their kernel launches count into the calling
    thread's recording (a capture's; kernels.lend_recording)."""
    if not (ys and primals):
        return [None] * len(primals)
    with kernels.lend_recording():
        return torch.autograd.grad(ys, primals, cots, allow_unused=True)


def make_grad_compute(fwd: OpDef):
    """Build the compute fn of the derived grad op of ``fwd``."""

    def grad_compute(ins: Dict[str, List[Any]], attrs: Dict[str, Any],
                     device, seed=None, generator=None, amp=False):
        in_slots = list(attrs["fwd_input_slots"])
        out_slots = list(attrs["fwd_output_slots"])
        fwd_attrs = {k: v for k, v in attrs.items()
                     if k not in _GRAD_META_ATTRS}
        kwargs = {"device": device}
        if fwd.needs_rng:
            kwargs["seed"] = seed
        if fwd.host_rng:
            kwargs["generator"] = generator
        if fwd.sub_blocks:
            kwargs["amp"] = amp
        fwd_ins = {s: list(ins.get(s, [])) for s in in_slots}

        # which (slot, position) entries are differentiable
        diff_keys: List[tuple] = []
        for s in in_slots:
            if fwd.diff_inputs is not None and s not in fwd.diff_inputs:
                continue
            for i, x in enumerate(fwd_ins[s]):
                if _floatp(x):
                    diff_keys.append((s, i))

        with torch.enable_grad():
            primals = [fwd_ins[s][i].detach().requires_grad_(True)
                       for s, i in diff_keys]
            merged = {s: list(v) for s, v in fwd_ins.items()}
            for (s, i), p in zip(diff_keys, primals):
                merged[s][i] = p
            with _rerun_range():
                outs = fwd.compute(merged, fwd_attrs, **kwargs)
            # An output the program supplies no gradient for has a zero
            # cotangent, which adds nothing to the product: leave it out.
            ys, cots = [], []
            for o in out_slots:
                gslot = ins.get(GRAD_SLOT_PREFIX + o, [])
                for i, y in enumerate(outs.get(o, [])):
                    g = gslot[i] if i < len(gslot) else None
                    if y is None or g is None or not y.requires_grad:
                        continue
                    g = g.to(y.dtype)
                    if g.shape != y.shape:
                        g = g.expand(y.shape)
                    ys.append(y)
                    cots.append(g)
            grads = vjp(ys, primals, cots)

        result: Dict[str, List[Any]] = {}
        for (s, i), p, g in zip(diff_keys, primals, grads):
            lst = result.setdefault(GRAD_SLOT_PREFIX + s,
                                    [None] * len(fwd_ins[s]))
            lst[i] = torch.zeros_like(p) if g is None else g
        return result

    grad_compute.__name__ = f"{fwd.type}_grad_compute"
    return grad_compute
