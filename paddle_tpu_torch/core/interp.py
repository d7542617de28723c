"""The op-list interpreter: runs a block's ops eagerly, in order, against
an environment (name -> tensor). Each op's compute is called with the
run's ``torch.device`` and, for random ops, its ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from paddle_tpu_torch.core.registry import OpDef, get_op_def


def resolve_op_def(op_type: str) -> OpDef:
    """Resolve an op type to its compute (raises naming unknown ops)."""
    return get_op_def(op_type)


def exec_ops(
    ops,
    env: Dict[str, Any],
    *,
    device: torch.device,
    generator: Optional[torch.Generator] = None,
    op_defs: Optional[List[OpDef]] = None,
):
    """Execute an op list against ``env`` in place; returns ``env``."""
    if op_defs is None:
        op_defs = [resolve_op_def(op.type) for op in ops]
    for op, opdef in zip(ops, op_defs):
        ins = {
            slot: [env[n] if n else None for n in names]
            for slot, names in op.inputs.items()
        }
        kwargs = {"device": device}
        if opdef.needs_rng:
            kwargs["generator"] = generator
        outs = opdef.compute(ins, dict(op.attrs), **kwargs)
        for slot, names in op.outputs.items():
            vals = outs.get(slot, [])
            for i, n in enumerate(names):
                if n and i < len(vals) and vals[i] is not None:
                    env[n] = vals[i]
    return env
