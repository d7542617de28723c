"""Program IR: Program / Block / Operator / Variable / Parameter.

The define-then-run contract of the JAX package's framework.py, kept in
plain Python: layers append ops into the blocks of a Program, and the
executor runs a block's ops eagerly on a ``torch.device``
(core/lowering.py). A Program serializes to the JAX package's
``ProgramDesc`` bytes (``desc_str`` / ``parse_from_string``), written and
read by the port's own proto2 codec (proto/framework_wire.py, no protobuf
runtime), so a ``__model__`` written by either package loads in the
other; ``clone(for_test)`` goes through those bytes, as in the JAX
package.

Shape and dtype inference is advisory: every appended op's compute runs
over tensors on ``device="meta"`` (no memory, no arithmetic) to fill its
output variables' metadata. Where that cannot run, the gap is recorded
(``shape_infer_gaps``) and real shapes resolve when the op executes.
"""

from __future__ import annotations

import hashlib
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
from paddle_tpu_torch.proto import framework_wire as pb

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

    @property
    def grad_name(self) -> str:
        return grad_var_name(self.name)

    def to_proto(self) -> pb.VarDesc:
        d = pb.VarDesc(name=self.name, kind=self.kind)
        if self.dtype is not None:
            d.dtype = self.dtype
        if self.shape is not None:
            d.shape.extend(self.shape)
        d.persistable = self.persistable
        d.stop_gradient = self.stop_gradient
        d.is_parameter = self.is_parameter
        d.trainable = self.trainable
        return d

    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    def astype(self, dtype):
        from paddle_tpu_torch import layers

        return layers.cast(self, dtype)

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

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def _set_attr(self, name: str, val):
        self.attrs[name] = val

    def to_proto(self) -> pb.OpDesc:
        d = pb.OpDesc(type=self.type)
        for slot, names in self.inputs.items():
            d.inputs.append(pb.OpDesc.Var(parameter=slot, arguments=names))
        for slot, names in self.outputs.items():
            d.outputs.append(pb.OpDesc.Var(parameter=slot, arguments=names))
        for k, val in self.attrs.items():
            a = pb.OpDesc.Attr(name=k)
            _attr_to_proto(a, val)
            d.attrs.append(a)
        return d

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


def _attr_to_proto(a: pb.OpDesc.Attr, val):
    """One attr value into ``a``, by the JAX package's type rules: bool
    before int, an int as LONG, a float as FLOAT64, an empty list as
    LONGS; anything else (a numpy integer, None) raises TypeError."""
    if isinstance(val, bool):
        a.type, a.b = pb.BOOLEAN, val
    elif isinstance(val, int):
        a.type, a.l = pb.LONG, val
    elif isinstance(val, float):
        a.type, a.float64 = pb.FLOAT64, val
    elif isinstance(val, str):
        a.type, a.s = pb.STRING, val
    elif isinstance(val, Block):
        a.type, a.block_idx = pb.BLOCK, val.idx
    elif isinstance(val, (list, tuple)):
        if all(isinstance(x, bool) for x in val) and val:
            a.type = pb.BOOLEANS
            a.bools.extend(val)
        elif all(isinstance(x, int) for x in val):
            a.type = pb.LONGS
            a.longs.extend(val)
        elif all(isinstance(x, float) for x in val):
            a.type = pb.FLOATS
            a.floats.extend(float(x) for x in val)
        elif all(isinstance(x, str) for x in val):
            a.type = pb.STRINGS
            a.strings.extend(val)
        elif all(isinstance(x, Block) for x in val):
            a.type = pb.BLOCKS
            a.blocks_idx.extend(b.idx for b in val)
        else:
            raise TypeError(f"unsupported list attr {val!r}")
    else:
        raise TypeError(f"unsupported attr {val!r} ({type(val)})")


def _attr_from_proto(a: pb.OpDesc.Attr, program: "Program"):
    t = a.type
    if t == pb.BOOLEAN:
        return a.b
    if t == pb.LONG:
        return int(a.l)
    if t == pb.INT:
        return int(a.i)
    if t == pb.FLOAT:
        return float(a.f)
    if t == pb.FLOAT64:
        return float(a.float64)
    if t == pb.STRING:
        return a.s
    if t == pb.BLOCK:
        return program.blocks[a.block_idx]
    if t == pb.BOOLEANS:
        return list(a.bools)
    if t == pb.LONGS:
        return [int(x) for x in a.longs]
    if t == pb.INTS:
        return [int(x) for x in a.ints]
    if t == pb.FLOATS:
        return [float(x) for x in a.floats]
    if t == pb.STRINGS:
        return list(a.strings)
    if t == pb.BLOCKS:
        return [program.blocks[i] for i in a.blocks_idx]
    raise TypeError(f"unsupported proto attr type {t}")


def _canonical_attr_bytes(val) -> bytes:
    """Deterministic cross-process rendering of one op attr for
    Program.content_digest: blocks as their index (the block content is
    digested in block order), arrays as a data digest, floats via repr
    (full precision)."""
    if isinstance(val, Block):
        return f"block:{val.idx}".encode()
    if isinstance(val, np.ndarray):
        data = hashlib.sha256(np.ascontiguousarray(val).tobytes())
        return f"ndarray:{val.shape}:{val.dtype}:{data.hexdigest()[:16]}" \
            .encode()
    if isinstance(val, (list, tuple)):
        return b"[" + b",".join(_canonical_attr_bytes(x) for x in val) + b"]"
    return repr(val).encode()


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

    def _prepend_op(self, type: str, inputs=None, outputs=None,
                    attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
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

    def to_proto(self) -> pb.BlockDesc:
        d = pb.BlockDesc(idx=self.idx, parent_idx=self.parent_idx)
        for v in self.vars.values():
            d.vars.append(v.to_proto())
        for op in self.ops:
            d.ops.append(op.to_proto())
        return d

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
        # (version, digest) of content_digest
        self._content_digest_cache: Optional[tuple] = None

    def _bump_version(self):
        self._version += 1

    @property
    def version(self) -> int:
        return self._version

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        """Append a sub-block (a ``while`` body) whose parent is the
        current block, or ``parent_idx``, and make it current."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        return b

    def _rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self) -> List[Parameter]:
        return [v for b in self.blocks for v in b.all_parameters()]

    def content_digest(self) -> str:
        """sha256 hex digest of the program's content (blocks, vars, ops
        with slot-keyed arguments and canonical attrs, random_seed) with
        no process-local identity in it: programs built alike in two
        processes, or parsed from the same bytes in either package,
        digest alike. Cached per version."""
        cache = self._content_digest_cache
        if cache is not None and cache[0] == self._version:
            return cache[1]
        h = hashlib.sha256()
        h.update(repr(self.random_seed).encode())
        for b in self.blocks:
            h.update(f"B{b.idx}:{b.parent_idx}".encode())
            for name in sorted(b.vars):
                v = b.vars[name]
                h.update(repr((
                    name, v.shape, str(v.dtype), bool(v.persistable),
                    bool(v.stop_gradient), bool(v.is_parameter),
                    v.kind,
                )).encode())
            for op in b.ops:
                h.update(op.type.encode())
                h.update(repr(sorted(op.inputs.items())).encode())
                h.update(repr(sorted(op.outputs.items())).encode())
                for k in sorted(op.attrs):
                    h.update(k.encode())
                    h.update(_canonical_attr_bytes(op.attrs[k]))
        digest = h.hexdigest()
        self._content_digest_cache = (self._version, digest)
        return digest

    # --- serialization ---

    def to_proto(self) -> pb.ProgramDesc:
        d = pb.ProgramDesc(version=self._version)
        if self.random_seed is not None:
            d.random_seed = self.random_seed
        for b in self.blocks:
            d.blocks.append(b.to_proto())
        return d

    def desc_str(self) -> bytes:
        return self.to_proto().SerializeToString()

    @staticmethod
    def from_proto(d: pb.ProgramDesc) -> "Program":
        p = Program()
        p.blocks = [Block(p, bd.idx, bd.parent_idx) for bd in d.blocks]
        for bd, b in zip(d.blocks, p.blocks):
            for vd in bd.vars:
                shape = tuple(vd.shape) if vd.shape else None
                if vd.is_parameter:
                    b.create_parameter(vd.name, shape, vd.dtype or "float32",
                                       trainable=vd.trainable)
                else:
                    b.create_var(name=vd.name, shape=shape,
                                 dtype=vd.dtype or None,
                                 persistable=vd.persistable,
                                 stop_gradient=vd.stop_gradient,
                                 trainable=vd.trainable, kind=vd.kind)
            for od in bd.ops:
                b.ops.append(Operator(
                    b, od.type,
                    inputs={v.parameter: list(v.arguments) for v in od.inputs},
                    outputs={v.parameter: list(v.arguments)
                             for v in od.outputs},
                    attrs={a.name: _attr_from_proto(a, p) for a in od.attrs},
                ))
        p._version = d.version
        if d.HasField("random_seed"):
            p.random_seed = d.random_seed
        return p

    @staticmethod
    def parse_from_string(s: bytes) -> "Program":
        d = pb.ProgramDesc()
        d.ParseFromString(s)
        return Program.from_proto(d)

    def clone(self, for_test: bool = False) -> "Program":
        """A copy through the program's bytes (a new program to the
        executor's cache, which captures its own graphs); ``for_test``
        sets every op's ``is_test`` attr where it has one, and dropout's
        and batch_norm's always."""
        p = Program.parse_from_string(self.desc_str())
        p._param_grad_map = dict(self._param_grad_map)
        p._amp = self._amp
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if ("is_test" in op.attrs
                            or op.type in ("dropout", "batch_norm")):
                        op.attrs["is_test"] = True
        p._bump_version()
        return p

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
