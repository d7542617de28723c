"""Operator registry.

Each op type maps to an ``OpDef`` whose ``compute`` is a plain PyTorch
function over tensors: ``compute(ins, attrs, device, [generator])`` with
slot-keyed inputs and outputs (``{"X": [t, ...]}``). ``device`` is the
``torch.device`` the executor runs on (ops that create tensors from
attrs alone need it); ops registered with ``needs_rng`` also receive the
run's ``torch.Generator``. Shape inference runs the same function over
tensors on ``device="meta"`` (framework.infer_op_outputs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

# Slot-keyed values: {"X": [tensor, ...], "Y": [tensor]}
Ins = Dict[str, List[Any]]
Outs = Dict[str, List[Any]]
ComputeFn = Callable[..., Outs]  # compute(ins, attrs, device, [generator])


@dataclasses.dataclass
class OpDef:
    """Definition of one operator type."""

    type: str
    compute: ComputeFn
    # True if compute wants a `generator` keyword (torch.Generator).
    needs_rng: bool = False
    doc: str = ""


_OP_REGISTRY: Dict[str, OpDef] = {}


def register_op(
    type: str,
    *,
    needs_rng: bool = False,
    doc: str = "",
) -> Callable[[ComputeFn], ComputeFn]:
    """Decorator registering ``fn`` as the compute for op ``type``."""

    def deco(fn: ComputeFn) -> ComputeFn:
        if type in _OP_REGISTRY:
            raise ValueError(f"op '{type}' registered twice")
        _OP_REGISTRY[type] = OpDef(
            type=type,
            compute=fn,
            needs_rng=needs_rng,
            doc=doc or (fn.__doc__ or ""),
        )
        return fn

    return deco


def get_op_def(type: str) -> OpDef:
    _ensure_ops_loaded()
    try:
        return _OP_REGISTRY[type]
    except KeyError:
        raise KeyError(
            f"operator '{type}' is not registered; known ops: "
            f"{sorted(_OP_REGISTRY)[:40]}..."
        ) from None


def has_op(type: str) -> bool:
    _ensure_ops_loaded()
    return type in _OP_REGISTRY


def registered_ops() -> List[str]:
    _ensure_ops_loaded()
    return sorted(_OP_REGISTRY)


_ops_loaded = False


def _ensure_ops_loaded():
    # Lazy import to break the registry <-> ops module cycle.
    global _ops_loaded
    if not _ops_loaded:
        _ops_loaded = True
        try:
            from paddle_tpu_torch import ops  # noqa: F401  (registers everything)
        except Exception:
            # Re-surface the real import error on the next call instead of
            # reporting an empty registry forever.
            _ops_loaded = False
            raise
