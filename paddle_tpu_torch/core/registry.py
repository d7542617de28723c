"""Operator registry.

Each op type maps to an ``OpDef`` whose ``compute`` is a plain PyTorch
function over tensors: ``compute(ins, attrs, device, [generator])`` with
slot-keyed inputs and outputs (``{"X": [t, ...]}``). ``device`` is the
``torch.device`` the executor runs on (ops that create tensors from
attrs alone need it). Random ops registered with ``needs_rng`` also
receive ``seed``, a ``core.rng.SeedHandle`` (the run's device seed buffer
and the op's index, core/interp.py; None during shape inference), whose
value they never read on the host, so a block of them can run as a CUDA
graph. Ops registered with ``host_rng`` (the startup program's random
fills) instead receive ``generator``, a ``torch.Generator`` seeded on the
host for the op and the run: a block that holds one is never captured
(core/lowering.py). A ``host_loop`` op (``while``) runs a loop on the
host, so its block is never captured whole either: the op captures its
loop body itself (ops/control_flow_ops.py). A ``host_callback`` op
(``print``, ``py_func``) calls back into Python on the host each time it
runs, so a block that holds one, at any depth of sub-blocks, is never
captured, and the executor counts its steps as uncaptured
(core/lowering.py). A ``sub_blocks`` op (``scan``, ``cond``,
``bounded_while``) runs the ops of its sub-blocks inside its compute and
receives ``amp``, the block's AMP setting, for them. Shape inference
runs the same function over tensors on ``device="meta"``
(framework.infer_op_outputs).

Gradients follow the JAX package's convention: an op without a
registered ``<type>_grad`` gets one derived from its forward compute
(core/autodiff.py); ``grad_maker`` may emit other grad ops instead, and
``no_grad`` ops take no part in the backward pass.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

# Slot-keyed values: {"X": [tensor, ...], "Y": [tensor]}
Ins = Dict[str, List[Any]]
Outs = Dict[str, List[Any]]
# compute(ins, attrs, device, [seed | generator])
ComputeFn = Callable[..., Outs]

GRAD_SUFFIX = "@GRAD"
GRAD_OP_SUFFIX = "_grad"


@dataclasses.dataclass
class OpDef:
    """Definition of one operator type."""

    type: str
    compute: ComputeFn
    # Slots that hold differentiable (float) inputs. None = all float inputs.
    diff_inputs: Optional[Sequence[str]] = None
    # Custom grad maker: fn(op, block, out_grads, provide, should_skip) ->
    # list of op-desc dicts, or None to defer to the derived grad op.
    grad_maker: Optional[Callable] = None
    # True if this op has no gradient (fills, metrics, masks).
    no_grad: bool = False
    # True if compute wants a `seed` keyword (core.rng.SeedHandle).
    needs_rng: bool = False
    # True if compute wants a `generator` keyword (a host-seeded
    # torch.Generator); a block that holds such an op is never captured.
    host_rng: bool = False
    # True if compute loops on the host (``while``: it reads its condition
    # after each iteration); a block that holds such an op is never
    # captured whole, the op captures its body itself.
    host_loop: bool = False
    # True if compute calls back into Python on the host (print, py_func);
    # a block that holds such an op, at any depth, is never captured.
    host_callback: bool = False
    # True if compute runs the ops of its sub-blocks (scan, cond,
    # bounded_while) and wants the block's ``amp`` setting for them.
    sub_blocks: bool = False
    doc: str = ""

    def __post_init__(self):
        if self.diff_inputs is not None:
            self.diff_inputs = tuple(self.diff_inputs)


_OP_REGISTRY: Dict[str, OpDef] = {}


def register_op(
    type: str,
    *,
    diff_inputs: Optional[Sequence[str]] = None,
    grad_maker: Optional[Callable] = None,
    no_grad: bool = False,
    needs_rng: bool = False,
    host_rng: bool = False,
    host_loop: bool = False,
    host_callback: bool = False,
    sub_blocks: bool = False,
    doc: str = "",
) -> Callable[[ComputeFn], ComputeFn]:
    """Decorator registering ``fn`` as the compute for op ``type``."""

    def deco(fn: ComputeFn) -> ComputeFn:
        if type in _OP_REGISTRY:
            raise ValueError(f"op '{type}' registered twice")
        _OP_REGISTRY[type] = OpDef(
            type=type,
            compute=fn,
            diff_inputs=diff_inputs,
            grad_maker=grad_maker,
            no_grad=no_grad,
            needs_rng=needs_rng,
            host_rng=host_rng,
            host_loop=host_loop,
            host_callback=host_callback,
            sub_blocks=sub_blocks,
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
