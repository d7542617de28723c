"""Graph-time autodiff: append_backward.

The JAX package's contract (reference: python/paddle/fluid/backward.py:
394): walk the op list backwards from the loss, append ``<type>_grad``
ops into the program, combine repeated gradients with ``sum`` ops
(reference: backward.py:135 ``_addup_repetitive_outputs_``) and prune ops
that do not reach the loss (reference: backward.py:579
``_find_op_path_``). Grad op descs follow core/autodiff.py; ops without a
registered grad get one derived from their forward compute.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from paddle_tpu_torch.core.autodiff import GRAD_SLOT_PREFIX
from paddle_tpu_torch.core.interp import resolve_op_def
from paddle_tpu_torch.core.registry import GRAD_OP_SUFFIX
from paddle_tpu_torch.framework import Block, Parameter, Variable, grad_var_name


def _is_float_var(block: Block, name: str) -> bool:
    v = block._find_var_recursive(name)
    if v is None or v.dtype is None:
        return True
    return v.dtype == "bfloat16" or np.issubdtype(np.dtype(v.dtype),
                                                 np.floating)


def _find_op_path(block: Block, loss: Variable) -> List[int]:
    """Indices of ops contributing to the loss, in forward order."""
    needed: Set[str] = {loss.name}
    marked: List[int] = []
    for idx in range(len(block.ops) - 1, -1, -1):
        op = block.ops[idx]
        if any(n in needed for n in op.output_arg_names):
            marked.append(idx)
            needed.update(n for n in op.input_arg_names if n)
    marked.reverse()
    return marked


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence[str]] = None,
    no_grad_set: Optional[Set[str]] = None,
    callbacks=None,
) -> List[Tuple[Parameter, Variable]]:
    """Append the grad ops of ``loss`` to its block; returns the
    (parameter, gradient var) pairs of the trainable parameters (or of
    ``parameter_list``) that the loss reaches."""
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())

    op_path = _find_op_path(block, loss)

    # gradient producers: target grad name -> list of written names
    producers: Dict[str, List[str]] = defaultdict(list)
    finalized: Set[str] = set()

    def provide(var_name: str) -> str:
        g = grad_var_name(var_name)
        k = len(producers[g])
        name = g if k == 0 else f"{g}@RENAME@{k}"
        producers[g].append(name)
        return name

    def lookup(var_name: str) -> Optional[str]:
        g = grad_var_name(var_name)
        lst = producers.get(g)
        if not lst:
            return None
        if len(lst) > 1 and g not in finalized:
            # a row-sparse marker among the partials cannot be summed
            # with dense ones (its array never exists); this catches the
            # order the sparse grad maker's own @RENAME check misses: the
            # sparse lookup claiming the clean name first
            for n in lst:
                v = block._find_var_recursive(n)
                if v is not None and getattr(v, "is_selected_rows", False):
                    raise ValueError(
                        f"parameter '{var_name}' has both a row-sparse "
                        f"gradient (is_sparse=True lookup) and other dense "
                        f"gradient contributions; they cannot be combined. "
                        f"Use is_sparse=False for this table.")
            # combine partial gradients (reference: backward.py:135)
            block.create_var(name=g, dtype=_var_dtype(var_name))
            block.append_op("sum", inputs={"X": list(lst)},
                            outputs={"Out": g})
            finalized.add(g)
        return g

    def _var_dtype(name: str):
        v = block._find_var_recursive(name)
        return v.dtype if v is not None else "float32"

    def should_skip(name: str, slot: str, opdef) -> bool:
        if not name or name in no_grad:
            return True
        v = block._find_var_recursive(name)
        if v is not None and v.stop_gradient:
            return True
        if opdef.diff_inputs is not None and slot not in opdef.diff_inputs:
            return True
        return not _is_float_var(block, name)

    # seed: d(loss)/d(loss) = 1
    loss_grad = grad_var_name(loss.name)
    block.create_var(name=loss_grad, shape=loss.shape, dtype=loss.dtype,
                     persistable=False)
    block.append_op("fill_any_like", inputs={"X": loss},
                    outputs={"Out": loss_grad}, attrs={"value": 1.0})
    producers[loss_grad].append(loss_grad)
    finalized.add(loss_grad)

    for idx in reversed(op_path):
        op = block.ops[idx]
        opdef = resolve_op_def(op.type)
        if opdef.no_grad:
            if op.type == "while" and any(
                    lookup(n) for n in op.output_arg_names if n):
                raise RuntimeError(
                    "Cannot backprop through a data-dependent `while` "
                    "loop: it has no gradient, so the loss's gradient "
                    "through it would be silently dropped. Either give "
                    "the loop an iteration bound (While(cond, "
                    "max_trip_count=N), the differentiable bounded_while: "
                    "a fixed-trip loop with dead iterations masked) or "
                    "write the recurrence with layers.StaticRNN / the "
                    "scan op.")
            continue

        out_grads: Dict[str, List[str]] = {}
        any_grad = False
        for slot, names in op.outputs.items():
            gs = []
            for n in names:
                g = lookup(n) if n else None
                gs.append(g or "")
                any_grad = any_grad or bool(g)
            out_grads[slot] = gs
        if not any_grad:
            continue

        if opdef.grad_maker is not None:
            descs = opdef.grad_maker(op, block, out_grads, provide,
                                     should_skip)
            if descs is not None:  # None = the derived grad op
                for d in descs:
                    block.append_op(**d)
                continue

        g_inputs = dict(op.inputs)
        for slot, names in op.outputs.items():
            g_inputs.setdefault(slot, names)
        for slot, gs in out_grads.items():
            g_inputs[GRAD_SLOT_PREFIX + slot] = gs

        g_outputs: Dict[str, List[str]] = {}
        emitted = False
        for slot, names in op.inputs.items():
            outs = []
            for n in names:
                if should_skip(n, slot, opdef):
                    outs.append("")
                else:
                    gname = provide(n)
                    src = block._find_var_recursive(n)
                    block.create_var(
                        name=gname,
                        shape=src.shape if src is not None else None,
                        dtype=src.dtype if src is not None else "float32",
                    )
                    outs.append(gname)
                    emitted = True
            g_outputs[GRAD_SLOT_PREFIX + slot] = outs
        if not emitted:
            continue

        attrs = dict(op.attrs)
        attrs["fwd_input_slots"] = list(op.inputs.keys())
        attrs["fwd_output_slots"] = list(op.outputs.keys())
        attrs["forward_op_idx"] = idx
        block.append_op(op.type + GRAD_OP_SUFFIX, inputs=g_inputs,
                        outputs=g_outputs, attrs=attrs)

    # finalize every gradient with several partial producers, whether or
    # not something downstream consumed it (calc_gradient reads them)
    suffix_len = len(grad_var_name(""))
    for gname, lst in list(producers.items()):
        if len(lst) > 1 and gname not in finalized:
            lookup(gname[:-suffix_len])

    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in program.all_parameters() if p.trainable]

    result = []
    for p in params:
        g = lookup(p.name)
        if g is None:
            continue
        result.append((p, block.var(g)))
        program._param_grad_map[p.name] = g
    return result


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of one target w.r.t. arbitrary inputs (reference:
    backward.py:619); None for an input the target does not reach."""
    if isinstance(targets, Variable):
        targets = [targets]
    if isinstance(inputs, Variable):
        inputs = [inputs]
    if len(targets) != 1:
        raise ValueError("calc_gradient supports one target")
    if target_gradients is not None:
        raise NotImplementedError("calc_gradient: target_gradients")
    block = targets[0].block
    append_backward(targets[0], no_grad_set=no_grad_set, parameter_list=[])
    outs = []
    for v in inputs:
        g = grad_var_name(v.name)
        outs.append(block.var(g) if block.has_var(g) else None)
    return outs


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    return calc_gradient(targets, inputs, target_gradients, no_grad_set)
