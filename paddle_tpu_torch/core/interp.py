"""The op-list interpreter: runs a block's ops eagerly, in order, against
an environment (name -> tensor). Each op's compute is called with the
run's ``torch.device`` and, for random ops, a seed (core/rng.py).

Randomness: a run has one step seed (executor.py), held in a 0-d int64
device tensor, the run's seed buffer. A random op (``needs_rng``)
receives ``rng.SeedHandle(buffer, forward_op_idx or its index)``; its op
seed is ``rng.mix64(step seed, index)``, the counterpart of the JAX
package's ``fold_in(key, forward_op_idx)``, and is mixed on the device
(the kernels' prologue, or tensor ops), so the same Python runs eagerly
and inside a CUDA graph. A grad op carries its forward's index, so it
replays the forward's seed (the attention backward regenerates the
forward's dropout mask). A ``host_rng`` op (a startup program's random
fill) instead receives a ``torch.Generator`` seeded on the host with the
same op seed, from ``host_seed``.

AMP (bf16 activation stream) casting is applied here, with the JAX
package's op sets.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from paddle_tpu_torch.core import autodiff, rng
from paddle_tpu_torch.core.registry import (
    GRAD_OP_SUFFIX,
    OpDef,
    get_op_def,
    has_op,
)

# Matmul-heavy ops that run in bfloat16 under AMP: every f32 input
# (master weights included) is cast to bf16 and the output stays bf16,
# so the activation stream between matmuls lives in bf16. bf16 needs no
# loss scaling.
AMP_OP_TYPES = {
    "mul",
    "matmul",
    "conv2d",
    "depthwise_conv2d",
    "conv2d_transpose",
    "scaled_dot_product_attention",
}

# Precision-following ops: when any input is already bf16, their other
# f32 float inputs (layer params, residual branches) are cast down so the
# op does not promote the stream back to f32. (layer_norm is absent: it
# computes in f32 and returns X's dtype itself.)
AMP_FLOW_OP_TYPES = {
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "scale",
    "dropout",
    "relu",
    "gelu",
    "tanh",
    "sigmoid",
    "softmax",
    "concat",
    "stack",
}

# Slots that stay f32 under AMP (saved statistics, not streams).
AMP_KEEP_F32_SLOTS = frozenset({"Lse", "GRAD::Lse"})

def _is_f32(v):
    return isinstance(v, torch.Tensor) and v.dtype == torch.float32


def _is_bf16(v):
    return isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16


def _amp_cast_ins(ins):
    out = {}
    for slot, vals in ins.items():
        if slot in AMP_KEEP_F32_SLOTS:
            out[slot] = list(vals)
            continue
        out[slot] = [v.to(torch.bfloat16) if _is_f32(v) else v for v in vals]
    return out


def _amp_flow_cast_ins(ins):
    """Cast f32 inputs to bf16 only when the op already consumes bf16."""
    if not any(_is_bf16(v) for vals in ins.values() for v in vals):
        return ins
    return _amp_cast_ins(ins)


def resolve_op_def(op_type: str) -> OpDef:
    """Resolve an op type to its compute, deriving ``<type>_grad`` on
    demand (raises naming unknown ops)."""
    if has_op(op_type):
        return get_op_def(op_type)
    if op_type.endswith(GRAD_OP_SUFFIX):
        base = op_type[: -len(GRAD_OP_SUFFIX)]
        if has_op(base):
            fwd = get_op_def(base)
            return OpDef(
                type=op_type,
                compute=autodiff.make_grad_compute(fwd),
                needs_rng=fwd.needs_rng,
                host_rng=fwd.host_rng,
                no_grad=True,
            )
    return get_op_def(op_type)


def exec_ops(
    ops,
    env: Dict[str, Any],
    *,
    device: torch.device,
    seed: Optional[torch.Tensor] = None,
    host_seed: Optional[int] = None,
    amp: bool = False,
    op_defs: Optional[List[OpDef]] = None,
):
    """Execute an op list against ``env`` in place; returns ``env``.
    ``seed`` is the run's seed buffer (a 0-d int64 tensor on ``device``,
    required when an op is random); ``host_seed`` the same step seed as an
    int, required only by ``host_rng`` ops. An op that raises gets a note
    naming its index and type."""
    if op_defs is None:
        op_defs = [resolve_op_def(op.type) for op in ops]
    gen_device = device if device.type == "cuda" else torch.device("cpu")
    for idx, (op, opdef) in enumerate(zip(ops, op_defs)):
        ins = {
            slot: [env[n] if n else None for n in names]
            for slot, names in op.inputs.items()
        }
        kwargs = {"device": device}
        if opdef.needs_rng:
            kwargs["seed"] = rng.SeedHandle(
                seed, op.attrs.get("forward_op_idx", idx))
        if opdef.host_rng:
            gen = torch.Generator(device=gen_device)
            gen.manual_seed(rng.mix64(host_seed,
                                      op.attrs.get("forward_op_idx", idx)))
            kwargs["generator"] = gen
        if amp:
            base_type = (op.type[: -len(GRAD_OP_SUFFIX)]
                         if op.type.endswith(GRAD_OP_SUFFIX) else op.type)
            if base_type in AMP_OP_TYPES:
                ins = _amp_cast_ins(ins)
            elif base_type in AMP_FLOW_OP_TYPES:
                ins = _amp_flow_cast_ins(ins)
        try:
            outs = opdef.compute(ins, dict(op.attrs), **kwargs)
        except Exception as e:
            e.add_note(f"in op {idx} ({op.type}) of the block")
            raise
        for slot, names in op.outputs.items():
            vals = outs.get(slot, [])
            for i, n in enumerate(names):
                if n and i < len(vals) and vals[i] is not None:
                    env[n] = vals[i]
    return env
