"""Control-flow layers: While / while_loop / cond / StaticRNN / Switch /
DynamicRNN / IfElse / Print and the dense arrays.

The graph-building front end of the structural ops in
ops/control_flow_ops.py, as in the JAX package (the reference's
python/paddle/fluid/layers/control_flow.py — While:697, StaticRNN:396,
Switch:1058, the ConditionalBlock machinery:996): each body is a
sub-block of the program, which its op runs inside the step.

- ``StaticRNN`` and ``DynamicRNN`` build a ``scan`` op, the
  differentiable recurrence of training.
- ``While`` builds a ``while`` op (a data-dependent trip count, no
  gradient: decoding and inference loops), or with ``max_trip_count`` a
  ``bounded_while``, which trains.
- ``cond`` and ``Switch`` build ``cond`` ops; ``IfElse`` selects rows.
- Values crossing a block boundary become op inputs (``X`` / ``Init`` /
  ``Captured``), found from the sub-block's read and write sets, so state
  analysis and autodiff see them without annotation.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.framework import (
    Block,
    Variable,
    default_main_program,
)
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layers.tensor import range_

__all__ = [
    "While",
    "while_loop",
    "cond",
    "StaticRNN",
    "DynamicRNN",
    "IfElse",
    "Switch",
    "increment",
    "array_fill",
    "array_write_step",
    "Print",
]


def _broadcast_row_mask(mask: Variable, v: Variable) -> Variable:
    """Reshape a [B, 1] per-row mask to broadcast against rank(v): [B]
    for rank-1 values, [B, 1, ...] for higher ranks (a bare [B, 1] mask
    against a [B] value would outer-broadcast to [B, B])."""
    from paddle_tpu_torch import layers

    rank = len(v.shape or ())
    if rank == 1:
        return layers.reshape(mask, [-1])
    if rank > 2:
        return layers.reshape(mask, [-1, 1] + [1] * (rank - 2))
    return mask


def _ordered_unique(names):
    seen = set()
    out = []
    for n in names:
        if n and n not in seen:
            seen.add(n)
            out.append(n)
    return out


def _read_write_sets(sub: Block) -> Tuple[List[str], List[str]]:
    """(reads-before-local-write, writes) name lists for a sub-block."""
    written: set = set()
    reads: List[str] = []
    writes: List[str] = []
    for op in sub.ops:
        for n in op.input_arg_names:
            if n and n not in written:
                reads.append(n)
        for n in op.output_arg_names:
            if n and n not in written:
                written.add(n)
                writes.append(n)
    return _ordered_unique(reads), writes


def _captured_names(
    sub: Block, parent: Block, exclude: Sequence[str]
) -> List[str]:
    """Names the sub-block reads from enclosing scopes (closure inputs)."""
    reads, _ = _read_write_sets(sub)
    ex = set(exclude)
    out = []
    for n in reads:
        if n in ex or n in sub.vars:
            continue
        if parent._find_var_recursive(n) is not None:
            out.append(n)
    return out


class While:
    """``with While(cond).block():`` — run the body while ``cond`` is true.

    The body must refresh ``cond`` (e.g. via ``layers.less_than(..,
    cond=cond)`` or ``layers.assign(new_cond, output=cond)``); loop-carried
    variables are exactly the enclosing-scope variables the body writes to.
    Reference: layers/control_flow.py:697 (While),
    operators/controlflow/while_op.cc:43; here a host loop whose body runs
    as a captured graph (ops/control_flow_ops.py).
    """

    def __init__(self, cond: Variable, is_test: bool = False, name=None,
                 max_trip_count: Optional[int] = None):
        """``max_trip_count``: upper bound on iterations. When given, the
        loop lowers DIFFERENTIABLY (``bounded_while``: a scan over
        exactly N steps with dead iterations masked through selects), so
        programs that backprop through a data-dependent loop — which the
        reference trains via WhileGradOp — work here too, at the cost of
        always executing N body evaluations. Without it, the loop is a
        ``while`` op (dynamic trip count, NO gradient — backprop through
        it raises; use scan/StaticRNN for recurrences)."""
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.max_trip_count = max_trip_count
        self._steps_var: Optional[Variable] = None

    @contextlib.contextmanager
    def block(self):
        program = default_main_program()
        parent = program.current_block()
        sub = program._create_block()
        try:
            yield
        finally:
            program._rollback()

        reads, writes = _read_write_sets(sub)
        cond_name = self.cond_var.name
        if cond_name not in writes:
            raise ValueError(
                "While body never updates the condition variable "
                f"'{cond_name}' — the loop would not terminate. Refresh it "
                "with layers.less_than(..., cond=cond) or layers.assign."
            )
        # Loop-carried: enclosing-scope names the body writes (minus cond).
        carry_names = [
            n
            for n in writes
            if n != cond_name
            and n not in sub.vars
            and parent._find_var_recursive(n) is not None
        ]
        captured = _captured_names(
            sub, parent, exclude=[cond_name] + carry_names
        )
        steps = parent.create_var(
            name=unique_name.generate("while_steps"),
            dtype="int32",
            shape=(),
            stop_gradient=True,
        )
        self._steps_var = steps
        attrs = {
            "sub_block": sub,
            "carry_names": carry_names,
            "cond_name": cond_name,
            "captured_names": captured,
        }
        op_type = "while"
        if self.max_trip_count is not None:
            op_type = "bounded_while"
            attrs["max_trip_count"] = int(self.max_trip_count)
        parent.append_op(
            op_type,
            inputs={
                "Condition": [cond_name],
                "X": carry_names,
                "Captured": captured,
            },
            outputs={
                "Out": carry_names,
                "CondOut": [cond_name],
                "Steps": [steps],
            },
            attrs=attrs,
        )


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """Functional while: ``loop_vars = body_fn(*loop_vars) while cond_fn``.

    Shapes/dtypes of loop vars must be loop-invariant.
    Returns the loop variables (updated in place by name).
    """
    from paddle_tpu_torch import layers

    if isinstance(loop_vars, Variable):
        loop_vars = [loop_vars]
    loop_vars = list(loop_vars)
    cond0 = cond_fn(*loop_vars)
    w = While(cond0, is_test=is_test, name=name)
    with w.block():
        new_vars = body_fn(*loop_vars)
        if new_vars is None:
            new_vars = []
        if isinstance(new_vars, Variable):
            new_vars = [new_vars]
        if len(new_vars) != len(loop_vars):
            raise ValueError(
                f"body_fn returned {len(new_vars)} values for "
                f"{len(loop_vars)} loop vars"
            )
        for old, new in zip(loop_vars, new_vars):
            if new is not old:
                layers.assign(new, output=old)
        layers.assign(cond_fn(*loop_vars), output=cond0)
    return loop_vars


def cond(pred: Variable, true_fn, false_fn, name=None):
    """Two-way branch: ``true_fn()`` if pred else ``false_fn()``.

    Both branches build sub-blocks of one ``cond`` op; their return
    structures must match (same arity, shapes, dtypes). Differentiable with
    respect to values the branches read from the enclosing scope.
    Reference: the ConditionalBlock pair in layers/control_flow.py:996 /
    operators/controlflow/conditional_block_op.cc:75.
    """
    program = default_main_program()
    parent = program.current_block()

    def build(fn):
        sub = program._create_block()
        try:
            outs = fn()
        finally:
            program._rollback()
        if outs is None:
            outs = []
        if isinstance(outs, Variable):
            outs = [outs]
        return sub, list(outs)

    tb, t_outs = build(true_fn)
    fb, f_outs = build(false_fn)
    if len(t_outs) != len(f_outs):
        raise ValueError(
            f"cond branches returned different arities: {len(t_outs)} vs "
            f"{len(f_outs)}"
        )
    cap = _ordered_unique(
        _captured_names(tb, parent, exclude=[])
        + _captured_names(fb, parent, exclude=[])
    )
    out_vars = [
        parent.create_var(
            name=unique_name.generate("cond_out"),
            dtype=t.dtype,
            shape=t.shape,
        )
        for t in t_outs
    ]
    parent.append_op(
        "cond",
        inputs={"Cond": [pred.name], "Captured": cap},
        outputs={"Out": [v.name for v in out_vars]},
        attrs={
            "true_block": tb,
            "false_block": fb,
            "true_out_names": [v.name for v in t_outs],
            "false_out_names": [v.name for v in f_outs],
            "captured_names": cap,
        },
    )
    if not out_vars:
        return None
    return out_vars[0] if len(out_vars) == 1 else out_vars


class StaticRNN:
    """Fixed-length recurrence over a sequence, built on the ``scan`` op.

    Usage (reference: layers/control_flow.py:396):

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # x: [B, T, D] batch-major
            h_prev = rnn.memory(init=h0)     # carried state
            h = layers.fc(...)               # any graph ops
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()                          # [B, T, H]

    Differentiable: builds one ``scan`` op, whose derived grad re-runs
    the loop under autograd — the reference's RecurrentGradOp tape
    (operators/recurrent_op.cc:250).
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._program = default_main_program()
        self._sub: Optional[Block] = None
        self._parent: Optional[Block] = None
        self._inputs: List[Tuple[Variable, Variable]] = []  # (parent, step)
        self._mems: List[Dict] = []  # {init, pre, new_name}
        self._outputs: List[Variable] = []
        self._seq_len: Optional[int] = None
        self._out_vars: List[Variable] = []
        self._final_vars: List[Variable] = []

    @contextlib.contextmanager
    def step(self):
        self._parent = self._program.current_block()
        self._sub = self._program._create_block()
        try:
            yield
        finally:
            self._program._rollback()
        self._complete()

    def step_input(self, x: Variable) -> Variable:
        """Register ``x`` ([B, T, ...]) as a scanned input; returns the
        per-step slice ([B, ...])."""
        if x.shape is None or len(x.shape) < 2 or x.shape[1] < 0:
            raise ValueError(
                "StaticRNN.step_input needs a static sequence length in "
                f"x.shape[1]; got {x.shape}"
            )
        if self._seq_len is None:
            self._seq_len = int(x.shape[1])
        elif self._seq_len != int(x.shape[1]):
            raise ValueError(
                f"inconsistent sequence lengths: {self._seq_len} vs "
                f"{x.shape[1]}"
            )
        step = self._sub.create_var(
            name=unique_name.generate("rnn_step_in"),
            dtype=x.dtype,
            shape=(x.shape[0],) + tuple(x.shape[2:]),
        )
        self._inputs.append((x, step))
        return step

    def memory(
        self,
        init: Optional[Variable] = None,
        shape=None,
        batch_ref: Optional[Variable] = None,
        init_value: float = 0.0,
        init_batch_dim_idx: int = 0,
        ref_batch_dim_idx: int = 1,
        dtype="float32",
    ) -> Variable:
        from paddle_tpu_torch import layers

        if init is None:
            if shape is None:
                raise ValueError("memory() needs init= or shape=")
            # The boundary value is a parent-block computation (it feeds the
            # scan op's Init slot), but memory() is called inside step() —
            # build it in the parent block explicitly.
            cur = self._program.current_block_idx
            self._program.current_block_idx = self._parent.idx
            try:
                if batch_ref is not None:
                    # batch dim read from batch_ref.shape[ref_batch_dim_idx]
                    # and written at init_batch_dim_idx (reference
                    # StaticRNN.memory fill_constant_batch_size_like)
                    helper = LayerHelper("rnn_mem_init")
                    init = helper.create_variable_for_type_inference(
                        dtype=dtype)
                    helper.append_op(
                        "fill_constant_batch_size_like",
                        inputs={"Input": batch_ref},
                        outputs={"Out": init},
                        attrs={"shape": [-1] + list(shape),
                               "value": init_value, "dtype": dtype,
                               "input_dim_idx": ref_batch_dim_idx,
                               "output_dim_idx": init_batch_dim_idx})
                else:
                    init = layers.fill_constant(
                        shape=list(shape), dtype=dtype, value=init_value
                    )
            finally:
                self._program.current_block_idx = cur
        pre = self._sub.create_var(
            name=unique_name.generate("rnn_mem"),
            dtype=init.dtype,
            shape=init.shape,
        )
        self._mems.append({"init": init, "pre": pre, "new_name": None})
        return pre

    def update_memory(self, mem: Variable, var: Variable):
        for m in self._mems:
            if m["pre"].name == mem.name:
                m["new_name"] = var.name
                return
        raise ValueError(f"'{mem.name}' is not a memory of this StaticRNN")

    def step_output(self, o: Variable):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        from paddle_tpu_torch import layers

        sub, parent = self._sub, self._parent
        for m in self._mems:
            if m["new_name"] is None:
                raise ValueError(
                    f"memory '{m['pre'].name}' was never update_memory()'d"
                )
        if self._seq_len is None:
            raise ValueError("StaticRNN needs at least one step_input")

        # Time-major views of the scanned inputs: [B, T, ...] -> [T, B, ...].
        xt_names = []
        for x, _step in self._inputs:
            perm = [1, 0] + list(range(2, len(x.shape)))
            xt = layers.transpose(x, perm)
            xt_names.append(xt.name)

        x_names = [s.name for _x, s in self._inputs]
        s_in = [m["pre"].name for m in self._mems]
        s_out = [m["new_name"] for m in self._mems]
        init_names = [m["init"].name for m in self._mems]
        y_names = [o.name for o in self._outputs]
        captured = _captured_names(
            sub, parent, exclude=x_names + s_in
        )

        y_tm = [
            parent.create_var(
                name=unique_name.generate("rnn_out_tm"),
                dtype=o.dtype,
                shape=(self._seq_len,) + tuple(o.shape or ()),
            )
            for o in self._outputs
        ]
        finals = [
            parent.create_var(
                name=unique_name.generate("rnn_final"),
                dtype=m["init"].dtype,
                shape=m["init"].shape,
            )
            for m in self._mems
        ]
        parent.append_op(
            "scan",
            inputs={"X": xt_names, "Init": init_names, "Captured": captured},
            outputs={
                "Y": [v.name for v in y_tm],
                "FinalState": [v.name for v in finals],
            },
            attrs={
                "sub_block": sub,
                "x_names": x_names,
                "state_in_names": s_in,
                "state_out_names": s_out,
                "y_names": y_names,
                "captured_names": captured,
            },
        )
        # Back to batch-major [B, T, ...].
        self._out_vars = []
        for v, o in zip(y_tm, self._outputs):
            perm = [1, 0] + list(range(2, 1 + len(o.shape or ())))
            self._out_vars.append(layers.transpose(v, perm))
        self._final_vars = finals

    def __call__(self):
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return list(self._out_vars)

    @property
    def outputs(self):
        return list(self._out_vars)

    @property
    def final_states(self):
        return list(self._final_vars)


class Switch:
    """``with switch.case(cond): ... with switch.default(): ...``

    Reference: layers/control_flow.py:1058. Built on nested ``cond`` ops:
    each case body must assign to the same output variables (via
    ``layers.assign(..., output=...)`` / ``fill_constant(out=...)``), and
    those assignments are rewritten into a branch chain.
    """

    def __init__(self, name=None):
        self._cases: List[Tuple[Optional[Variable], object]] = []
        self._entered = False

    @contextlib.contextmanager
    def case(self, condition: Variable):
        program = default_main_program()
        sub = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        self._cases.append((condition, sub))

    @contextlib.contextmanager
    def default(self):
        program = default_main_program()
        sub = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        self._cases.append((None, sub))

    def __enter__(self):
        self._entered = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        program = default_main_program()
        parent = program.current_block()
        # Output names: union of names every case writes into parent scope.
        out_names: List[str] = []
        for _c, sub in self._cases:
            _reads, writes = _read_write_sets(sub)
            for n in writes:
                if n not in sub.vars and parent._find_var_recursive(n):
                    if n not in out_names:
                        out_names.append(n)
        if not out_names:
            return False
        conds = [c for c, _ in self._cases if c is not None]
        subs = [s for _, s in self._cases]
        has_default = any(c is None for c, _ in self._cases)
        if not has_default:
            raise ValueError("Switch requires a default() case")

        # Chain: cond(c0, case0, cond(c1, case1, ... default))
        def make_branch(i):
            def branch():
                from paddle_tpu_torch import layers

                if i >= len(self._cases):
                    raise AssertionError
                c, sub = self._cases[i]
                # Re-play the recorded block inside a fresh sub-block by
                # moving its ops (blocks are only built once; reuse ops).
                cur = program.current_block()
                cur.ops.extend(sub.ops)
                cur.vars.update(sub.vars)
                return [layers.assign(parent.var(n)) for n in out_names]

            return branch

        def chain(i):
            c, _sub = self._cases[i]
            if c is None or i == len(self._cases) - 1:
                return make_branch(i)()
            return cond(c, make_branch(i), lambda: chain(i + 1))

        results = chain(0)
        if isinstance(results, Variable):
            results = [results]
        from paddle_tpu_torch import layers

        for n, r in zip(out_names, results):
            layers.assign(r, output=parent.var(n))
        return False


def increment(x, value=1.0, in_place=True):
    from paddle_tpu_torch import layers

    return layers.increment(x, value=value, in_place=in_place)


def array_fill(maxlen: int, template: Variable, value: float = 0.0):
    """Dense stand-in for the reference's LoDTensorArray: a preallocated
    ``[maxlen, ...]`` buffer written by ``array_write_step``. A captured
    step needs static shapes, so the array is a fixed tensor, not a growable list
    (reference: operators/controlflow/tensor_array_read_write_op.cc)."""
    from paddle_tpu_torch import layers

    shape = [maxlen] + list(template.shape or ())
    return layers.fill_constant(shape=shape, dtype=template.dtype, value=value)


def array_write_step(array: Variable, index: Variable, value: Variable):
    """Write ``value`` at position ``index`` (dynamic scalar) of ``array``."""
    helper = LayerHelper("array_write")
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    helper.append_op(
        "dynamic_update",
        inputs={"X": array, "Index": index, "Value": value},
        outputs={"Out": out},
    )
    out.shape = array.shape
    return out


class DynamicRNN:
    """Batch RNN over padded sequences (reference:
    layers/control_flow.py:1661 ``DynamicRNN``).

    The reference unfolds LoD sequences through a While loop with rank
    tables shrinking the batch as sequences end. The dense design
    keeps the batch DENSE and static: inputs are padded [B, T, ...]
    tensors with an optional per-sample ``length`` [B] (the SURVEY.md
    section 5 padding design); the recurrence lowers to the same
    differentiable ``scan`` op as StaticRNN, and masking replaces the
    shrinking batch — memories freeze (carry their last valid value) and
    outputs are zeroed once ``t >= length``.

    Usage::

        drnn = DynamicRNN()
        with drnn.block():
            w = drnn.step_input(emb, length=seq_len)   # emb [B, T, D]
            prev = drnn.memory(shape=[200])
            h = layers.fc([w, prev], 200, act="relu")
            drnn.update_memory(prev, h)
            drnn.output(h)
        out = drnn()                      # [B, T, 200], zero past length
        last = layers.sequence_pool(out, "last", length=seq_len)
    """

    def __init__(self, name=None):
        self._rnn = StaticRNN(name)
        self._length: Optional[Variable] = None
        self._keep: Optional[Variable] = None   # [B, 1] bool in-block
        self._batch_ref: Optional[Variable] = None
        self._in_block = False

    @contextlib.contextmanager
    def block(self):
        with self._rnn.step():
            self._in_block = True
            try:
                yield
            finally:
                self._in_block = False

    def _ensure_keep(self):
        """Lazy [B, 1] bool keep mask = (t < length), built once per
        block."""
        from paddle_tpu_torch import layers

        if self._keep is not None or self._length is None:
            return
        prog = self._rnn._program
        t = self._rnn._seq_len
        cur = prog.current_block_idx
        prog.current_block_idx = self._rnn._parent.idx
        try:
            steps = layers.reshape(range_(0, t, 1, "int64"), [1, t, 1])
        finally:
            prog.current_block_idx = cur
        t_step = self._rnn.step_input(steps)          # [1, 1] int64
        # normalize length to [B, 1] whatever its declared/fed rank
        length = layers.reshape(self._length, [-1, 1])
        self._keep = layers.less_than(
            t_step, layers.cast(length, "int64"))      # [B, 1] bool

    def _keep_as(self, v: Variable):
        return _broadcast_row_mask(self._keep, v)

    def _require_block(self, what):
        if not self._in_block:
            raise ValueError(
                f"DynamicRNN.{what}() must be called inside "
                "`with drnn.block():` (reference DynamicRNN._assert_in_rnn_"
                "block_ semantics)")

    def step_input(self, x: Variable, level=0, length: Optional[Variable] = None):
        self._require_block("step_input")
        step = self._rnn.step_input(x)
        if self._batch_ref is None:
            self._batch_ref = x
        if length is not None:
            if self._length is not None and length.name != self._length.name:
                raise ValueError(
                    "DynamicRNN: conflicting `length` on a second "
                    f"step_input ('{self._length.name}' vs '{length.name}')"
                    " — all scanned inputs share one length tensor")
            self._length = length
        return step

    def static_input(self, x: Variable) -> Variable:
        """Non-scanned input, visible at every step (reference
        drnn.static_input; dense: captured as-is)."""
        return x

    def memory(self, init: Optional[Variable] = None, shape=None,
               value: float = 0.0, need_reorder: bool = False,
               dtype="float32"):
        self._require_block("memory")
        if init is not None:
            return self._rnn.memory(init=init)
        if shape is None:
            raise ValueError("DynamicRNN.memory needs init= or shape=")
        if self._batch_ref is None:
            raise ValueError(
                "DynamicRNN.memory(shape=...) must follow step_input so "
                "the batch size is known")
        return self._rnn.memory(shape=list(shape),
                                batch_ref=self._batch_ref,
                                init_batch_dim_idx=0, ref_batch_dim_idx=0,
                                init_value=value, dtype=dtype)

    def update_memory(self, mem: Variable, new: Variable):
        from paddle_tpu_torch import layers

        self._require_block("update_memory")
        self._ensure_keep()
        if self._keep is not None:
            # freeze finished rows: carry keeps its last valid value
            new = layers.where(self._keep_as(new), new, mem)
        self._rnn.update_memory(mem, new)

    def output(self, *outputs):
        from paddle_tpu_torch import layers

        self._require_block("output")
        self._ensure_keep()
        for o in outputs:
            if self._keep is not None:
                o = layers.where(self._keep_as(o), o,
                                 layers.fill_constant_like(o, 0))
            self._rnn.step_output(o)

    def __call__(self):
        return self._rnn()


class IfElse:
    """Per-sample two-way branch (reference:
    layers/control_flow.py:1525 ``IfElse``).

    The reference gathers the true/false row subsets into separate
    sub-blocks and scatters results back (dynamic row counts). The
    dense design computes BOTH branches over the full batch and merges
    rows with a select — static shapes, no host sync, same
    results for the row-wise computations the construct exists for (the
    branches cost compute for all rows, which is cheaper than
    dynamic-shape gathers).

    Usage::

        ie = IfElse(cond)                  # cond [B, 1] bool
        with ie.true_block():
            ie.output(fc_true(ie.input(x)))
        with ie.false_block():
            ie.output(fc_false(ie.input(x)))
        out = ie()
    """

    def __init__(self, cond: Variable, name=None):
        self._cond = cond
        self._true_outs: List[Variable] = []
        self._false_outs: List[Variable] = []
        self._phase: Optional[str] = None

    @contextlib.contextmanager
    def true_block(self):
        self._phase = "true"
        try:
            yield
        finally:
            self._phase = None

    @contextlib.contextmanager
    def false_block(self):
        self._phase = "false"
        try:
            yield
        finally:
            self._phase = None

    def input(self, x: Variable) -> Variable:
        if self._phase is None:
            raise ValueError("IfElse.input() outside true_block/false_block")
        return x

    def output(self, *outs):
        if self._phase == "true":
            self._true_outs.extend(outs)
        elif self._phase == "false":
            self._false_outs.extend(outs)
        else:
            raise ValueError(
                "IfElse.output() outside true_block/false_block")

    def __call__(self):
        from paddle_tpu_torch import layers

        if len(self._true_outs) != len(self._false_outs):
            raise ValueError(
                f"IfElse branches produced {len(self._true_outs)} vs "
                f"{len(self._false_outs)} outputs; they must align")
        merged = []
        for t, f in zip(self._true_outs, self._false_outs):
            merged.append(
                layers.where(_broadcast_row_mask(self._cond, t), t, f))
        return merged[0] if len(merged) == 1 else merged


_PRINT_UID = [0]


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Print a tensor's value whenever it is computed (reference:
    layers/control_flow.py:135 + operators/print_op.cc). The op calls
    back into Python on the host each time it runs, so a step that holds
    it is never captured (core/lowering.py) and prints at every step.
    ``print_phase`` 'backward'/'both' also prints the incoming gradient
    (emitted as a second print op by the grad maker). ``print_tensor_lod``
    is accepted for API parity; the dense/padded design has no LoD."""
    helper = LayerHelper("print")
    _PRINT_UID[0] += 1
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        "print",
        inputs={"In": input},
        outputs={"Out": out},
        attrs={
            "first_n": first_n,
            "summarize": summarize,
            "message": message or "",
            "print_tensor_name": print_tensor_name,
            "print_tensor_type": print_tensor_type,
            "print_tensor_shape": print_tensor_shape,
            "print_phase": print_phase.upper(),
            "is_forward": True,
            "var_name": input.name,
            "print_uid": _PRINT_UID[0],
        },
    )
    return out
