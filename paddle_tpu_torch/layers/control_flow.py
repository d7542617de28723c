"""Control-flow layers: ``While``, ``while_loop``, ``increment``.

The graph-building front end of the ``while`` op (ops/control_flow_ops.py),
as in the JAX package: the body is a sub-block of the program, and the
values crossing its boundary become op inputs (``X`` for the carried
values, ``Captured`` for the values the body only reads), found from the
sub-block's read and write sets, so state analysis sees them without
annotation. A ``while`` has no gradient.

Not ported yet: ``While(max_trip_count=...)`` (the JAX package's
differentiable ``bounded_while``), ``cond``, ``StaticRNN``, ``Switch``,
``DynamicRNN`` and ``IfElse``.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.framework import Block, Variable, default_main_program

__all__ = ["While", "while_loop", "increment"]


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


def _captured_names(sub: Block, parent: Block,
                    exclude: Sequence[str]) -> List[str]:
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

    The body must refresh ``cond`` (``layers.less_than(..., cond=cond)``
    or ``layers.assign(new_cond, output=cond)``); the loop-carried values
    are exactly the enclosing-scope variables the body writes. The loop
    has a data-dependent trip count and no gradient. ``max_trip_count``
    (the JAX package's differentiable ``bounded_while``) is not ported
    and raises.
    """

    def __init__(self, cond: Variable, is_test: bool = False, name=None,
                 max_trip_count: Optional[int] = None):
        if max_trip_count is not None:
            raise NotImplementedError(
                "While(max_trip_count=...) lowers to bounded_while, the "
                "differentiable loop of training, which is not ported yet "
                "(ROADMAP.md, Queue 1 item 6: layers and ops beyond the "
                "trained paths)")
        self.cond_var = cond
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

        _, writes = _read_write_sets(sub)
        cond_name = self.cond_var.name
        if cond_name not in writes:
            raise ValueError(
                "While body never updates the condition variable "
                f"'{cond_name}' — the loop would not terminate. Refresh it "
                "with layers.less_than(..., cond=cond) or layers.assign.")
        # loop-carried: enclosing-scope names the body writes (minus cond)
        carry_names = [
            n for n in writes
            if n != cond_name and n not in sub.vars
            and parent._find_var_recursive(n) is not None
        ]
        captured = _captured_names(sub, parent,
                                   exclude=[cond_name] + carry_names)
        steps = parent.create_var(
            name=unique_name.generate("while_steps"), dtype="int32",
            shape=(), stop_gradient=True)
        self._steps_var = steps
        parent.append_op(
            "while",
            inputs={"Condition": [cond_name], "X": carry_names,
                    "Captured": captured},
            outputs={"Out": carry_names, "CondOut": [cond_name],
                     "Steps": [steps]},
            attrs={"sub_block": sub, "carry_names": carry_names,
                   "cond_name": cond_name, "captured_names": captured},
        )


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """Functional while: ``loop_vars = body_fn(*loop_vars)`` while
    ``cond_fn(*loop_vars)``. The loop vars keep their shapes and dtypes;
    returns them (updated in place by name)."""
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
                f"{len(loop_vars)} loop vars")
        for old, new in zip(loop_vars, new_vars):
            if new is not old:
                layers.assign(new, output=old)
        layers.assign(cond_fn(*loop_vars), output=cond0)
    return loop_vars


def increment(x, value=1.0, in_place=True):
    from paddle_tpu_torch import layers

    return layers.increment(x, value=value, in_place=in_place)
