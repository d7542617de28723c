"""Program IR: Program / Block / Operator / Variable / Parameter.

The define-then-run contract of the JAX package's framework.py, kept in
plain Python: layers append ops into the blocks of a Program, and the
executor runs a block's ops eagerly on a ``torch.device``
(core/lowering.py). Serialization (protobuf ``ProgramDesc``, the
``__model__`` format) is not part of this package yet.

Shape and dtype inference is advisory: every appended op's compute runs
over tensors on ``device="meta"`` (no memory, no arithmetic) to fill its
output variables' metadata. Where that cannot run, the gap is recorded
(``shape_infer_gaps``) and real shapes resolve when the op executes.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.core.registry import (
    GRAD_OP_SUFFIX,
    GRAD_SUFFIX,
    get_op_def,
    has_op,
)

# Sentinel used to stand in for a symbolic (-1) batch dim during abstract
# shape inference. Prime and unlikely to appear as a real static dim.
_BATCH_SENTINEL = 997

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


def torch_dtype(name) -> torch.dtype:
    """Dtype name (or anything ``convert_np_dtype_to_dtype_`` accepts)
    -> ``torch.dtype``."""
    return _TORCH_DTYPES[convert_np_dtype_to_dtype_(name)]


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.dtype`` -> the numpy-style name Variables carry."""
    return _DTYPE_NAMES[dtype]


def convert_np_dtype_to_dtype_(dtype) -> str:
    """Canonicalize any dtype spec to a numpy dtype name string."""
    if isinstance(dtype, str) and dtype in ("bfloat16",):
        return "bfloat16"
    return np.dtype(dtype).name


# VarDesc kinds of the JAX package's program proto (paddle_tpu/proto/
# framework.proto): a var is a dense tensor unless it says otherwise
DENSE_TENSOR = 0


class Variable:
    """A named tensor in a Block; ``kind`` is its VarDesc kind."""

    def __init__(
        self,
        block: "Block",
        name: str,
        shape: Optional[Sequence[int]] = None,
        dtype: Any = "float32",
        persistable: bool = False,
        stop_gradient: bool = False,
        is_parameter: bool = False,
        trainable: bool = True,
        kind: int = DENSE_TENSOR,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(int(d) for d in shape) if shape is not None else None
        self.dtype = convert_np_dtype_to_dtype_(dtype) if dtype is not None else None
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_parameter = is_parameter
        self.trainable = trainable
        self.kind = kind

    def __repr__(self):
        return (
            f"Var({self.name}, shape={self.shape}, dtype={self.dtype}"
            + (", persistable" if self.persistable else "")
            + (", stop_gradient" if self.stop_gradient else "")
            + ")"
        )

    __str__ = __repr__


class Parameter(Variable):
    """A trainable persistable variable."""

    def __init__(self, block, name, shape, dtype, **kwargs):
        self.initializer = kwargs.pop("initializer", None)
        self.regularizer = kwargs.pop("regularizer", None)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        trainable = kwargs.pop("trainable", True)
        super().__init__(
            block,
            name,
            shape=shape,
            dtype=dtype,
            persistable=True,
            stop_gradient=not trainable,
            is_parameter=True,
            trainable=trainable,
            **kwargs,
        )


class Operator:
    """One op invocation: type + slot-keyed inputs/outputs + attrs."""

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, Any]] = None,
        outputs: Optional[Dict[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = _normalize_slots(inputs)
        self.outputs: Dict[str, List[str]] = _normalize_slots(outputs)
        self.attrs: Dict[str, Any] = dict(attrs or {})

    @property
    def input_arg_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def __repr__(self):
        ins = ", ".join(f"{s}={n}" for s, n in self.inputs.items())
        outs = ", ".join(f"{s}={n}" for s, n in self.outputs.items())
        return f"{{{outs}}} = {self.type}({ins}) attrs={self.attrs}"


def _normalize_slots(slots) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for slot, v in (slots or {}).items():
        if v is None:
            continue
        if isinstance(v, (Variable, str)):
            v = [v]
        names = [x.name if isinstance(x, Variable) else str(x) for x in v]
        if names:
            out[slot] = names
    return out


class Block:
    """An ordered op list + var table."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        return None if self.parent_idx < 0 else self.program.blocks[self.parent_idx]

    # --- variables ---

    def create_var(self, name: Optional[str] = None, **kwargs) -> Variable:
        if name is None:
            name = unique_name.generate("tmp")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kwargs)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype, **kwargs) -> Parameter:
        p = Parameter(self, name, shape, dtype, **kwargs)
        self.vars[name] = p
        return p

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"variable '{name}' not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # --- ops ---

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        self._infer_shapes(op)
        return op

    def _infer_shapes(self, op: Operator):
        """Run the op's compute on meta tensors to fill output metadata."""
        outs, gap = infer_op_outputs(self, op)
        if outs is None:
            if gap is not None:
                _note_infer_gap(op.type, gap)
            return
        try:
            apply_inferred_outputs(self, op, outs)
        except Exception as e:
            # a compute returning a malformed result structure stays an
            # advisory gap (real shapes resolve at execution), not a
            # build abort
            _note_infer_gap(op.type,
                            f"eval_failed:{type(e).__name__}: {e}")

    def __repr__(self):
        lines = [f"block {self.idx} (parent {self.parent_idx}):"]
        lines += [f"  {v}" for v in self.vars.values()]
        lines += [f"  {op}" for op in self.ops]
        return "\n".join(lines)


# (op_type, gap kind) pairs where shape inference could not run. Kinds:
# 'no_kernel' (op type has no registered compute), 'autodiff_grad' (a
# derived <type>_grad op), 'missing_input_meta'
# (an input var lacks shape/dtype), 'eval_failed:<Error>' (the meta
# evaluation raised).
# Bounded by the op-type vocabulary.
_SHAPE_INFER_GAPS: set = set()


def shape_infer_gaps() -> set:
    """Snapshot of recorded inference-coverage gaps (see above)."""
    return set(_SHAPE_INFER_GAPS)


def _note_infer_gap(op_type: str, gap: str):
    # dedup on the 'eval_failed:<Type>' prefix; the logged line keeps the
    # full diagnostic message
    sig = (op_type, gap.split(": ", 1)[0])
    if sig in _SHAPE_INFER_GAPS:
        return
    _SHAPE_INFER_GAPS.add(sig)
    log = logging.getLogger("paddle_tpu_torch")
    if gap.startswith("eval_failed"):
        log.warning(
            "shape inference failed for op '%s': %s "
            "(advisory; real shapes resolved at execution)", op_type, gap)
    else:
        log.debug("shape inference skipped for op '%s': %s", op_type, gap)


_META = torch.device("meta")


def infer_op_outputs(block: "Block", op: Operator):
    """Evaluate ``op``'s compute over meta tensors built from the block's
    declared metadata. Returns ``(outs, gap)``: ``outs`` maps output slot
    -> list of meta tensors (``None`` when inference could not run, with
    ``gap`` naming why)."""
    if not has_op(op.type):
        if op.type.endswith(GRAD_OP_SUFFIX) and \
                has_op(op.type[: -len(GRAD_OP_SUFFIX)]):
            # derived when the block runs (core/autodiff.py); shapes
            # mirror the differentiated inputs
            return None, "autodiff_grad"
        return None, "no_kernel"
    opdef = get_op_def(op.type)
    try:
        ins = {}
        for slot, names in op.inputs.items():
            specs = []
            for n in names:
                if not n:  # a hole: the op sees None, as when it runs
                    specs.append(None)
                    continue
                v = block._find_var_recursive(n)
                if v is None or v.shape is None or v.dtype is None:
                    return None, "missing_input_meta"
                shape = tuple(
                    _BATCH_SENTINEL if d == -1 else d for d in v.shape
                )
                specs.append(torch.empty(shape, dtype=torch_dtype(v.dtype),
                                         device=_META))
            ins[slot] = specs
        kwargs = {"device": _META}
        if opdef.needs_rng:
            kwargs["seed"] = None
        if opdef.host_rng:
            kwargs["generator"] = None
        return opdef.compute(ins, dict(op.attrs), **kwargs), None
    except Exception as e:
        # the message carries the real diagnostic (broadcast shapes, bad
        # attr, ...); _note_infer_gap dedups on the prefix only
        return None, f"eval_failed:{type(e).__name__}: {e}"


def apply_inferred_outputs(block: "Block", op: Operator, outs) -> None:
    """Write ``infer_op_outputs`` results back into the block's var
    metadata (extra/None entries skipped)."""
    for slot, names in op.outputs.items():
        results = outs.get(slot, [])
        for n, r in zip(names, results):
            if r is None:
                continue
            v = block._find_var_recursive(n)
            if v is None:
                v = block.create_var(name=n)
            v.shape = tuple(
                -1 if d == _BATCH_SENTINEL else int(d) for d in r.shape
            )
            v.dtype = dtype_name(r.dtype)


class Program:
    """A list of blocks; block 0 is global."""

    _uid_counter = 0

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0, -1)]
        self.current_block_idx = 0
        # monotonic global uid: executor cache keys use this instead of
        # id() (id reuse after GC could alias a stale cached entry)
        Program._uid_counter += 1
        self._uid = Program._uid_counter
        self._version = 0
        self.random_seed: Optional[int] = None
        # bf16 execution of the matmul-heavy ops (amp.enable_amp)
        self._amp = False
        # param name -> its gradient var (backward.append_backward)
        self._param_grad_map: Dict[str, str] = {}

    def _bump_version(self):
        self._version += 1

    @property
    def version(self) -> int:
        return self._version

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self) -> List[Parameter]:
        return [v for b in self.blocks for v in b.all_parameters()]

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)

    __str__ = __repr__


# --- default programs & guards ---

_main_program_ = Program()
_startup_program_ = Program()


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(program: Program) -> Program:
    global _main_program_
    old, _main_program_ = _main_program_, program
    return old


def switch_startup_program(program: Program) -> Program:
    global _startup_program_
    old, _startup_program_ = _startup_program_, program
    return old


class program_guard:
    def __init__(self, main_program: Program, startup_program: Optional[Program] = None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        self.old_main = switch_main_program(self.main)
        if self.startup is not None:
            self.old_startup = switch_startup_program(self.startup)
        return self

    def __exit__(self, *exc):
        switch_main_program(self.old_main)
        if self.startup is not None:
            switch_startup_program(self.old_startup)
        return False


# --- places: which torch.device the executor runs on ---


class CPUPlace:
    def torch_device(self) -> torch.device:
        return torch.device("cpu")

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace:
    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


def resolve_device(place=None) -> torch.device:
    """The ``torch.device`` an entry point runs on: ``place`` defaults to
    ``CUDAPlace(0)``, and a CUDA place raises when this process has no
    CUDA device (callers opt into the CPU with ``CPUPlace()``)."""
    place = CUDAPlace(0) if place is None else place
    device = place.torch_device()
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{place!r} requested but torch.cuda.is_available() is False; "
            f"pass CPUPlace() to run on the CPU")
    return device
