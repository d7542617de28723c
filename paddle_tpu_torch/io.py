"""Saving and loading a Scope's variables, and weights carried across
from the JAX package.

The file format is the JAX package's (``paddle_tpu/io.py``): one
``__params__.npz`` (or ``filename``) holding one array per variable,
keyed by the variable's name. ``save_vars`` / ``save_persistables`` /
``save_params`` write it, ``load_vars`` / ``load_persistables`` /
``load_params`` read it into the current Scope on the executor's device,
and refuse a file that lacks any requested variable rather than leave
part of the state at its initialization. Both packages name variables
alike under ``unique_name.guard()``, so a file saved by either loads into
the other. A bf16 tensor is written as the JAX package writes one (numpy
holds it as 2-byte void elements, the bf16 bits) and read back into a
bf16 tensor.

``scope_from_numpy`` builds a Scope from a JAX-package scope's arrays
(``{n: np.asarray(scope.find_var(n))}``); ``scope_from_params_file``
reads a saved file into a new Scope. Optimizer state moves by
(parameter, kind) where var names differ between builds:
``rekey_optimizer_state`` maps them through both optimizers'
``slot_descriptor()``.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.lowering import as_tensor
from paddle_tpu_torch.executor import Scope, global_scope
from paddle_tpu_torch.framework import default_main_program, resolve_device

# the JAX package's combined-parameters file (paddle_tpu/io.py)
PARAMS_FILE = "__params__.npz"
# how numpy holds a bf16 array it has no dtype for: 2-byte void elements
_BF16_VOID = np.dtype("V2")


def _to_numpy(value) -> np.ndarray:
    """A scope value on the host, bf16 as its bits in 2-byte voids."""
    if not isinstance(value, torch.Tensor):
        return np.asarray(value)
    t = value.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_VOID)
    return t.numpy()


def _to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A saved array as a tensor on ``device`` (2-byte voids as bf16)."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return as_tensor(arr, device)


def _is_persistable(var) -> bool:
    return bool(var.persistable)


def _is_parameter(var) -> bool:
    return bool(getattr(var, "is_parameter", False))


def _collect(program, predicate):
    return [v for v in program.list_vars() if predicate(v)]


def save_vars(executor, dirname: str, main_program=None,
              vars: Optional[Sequence] = None, predicate=None,
              filename: Optional[str] = None,
              scope: Optional[Scope] = None) -> None:
    """Write ``vars`` (or the program's vars that ``predicate`` selects,
    the persistable ones when None) from ``scope`` (the current one when
    None) to ``dirname/filename`` (``__params__.npz`` when None). The
    device is synchronized once, so every queued step has written its
    state, and each tensor is then copied to the host once."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = _collect(program, predicate or _is_persistable)
    os.makedirs(dirname, exist_ok=True)
    values, missing = {}, []
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            missing.append(v.name)
            continue
        values[v.name] = val
    if missing:
        raise RuntimeError(
            f"save_vars: {len(missing)} requested variables are not "
            f"initialized in the scope (e.g. {missing[:5]}); run the "
            f"startup program first")
    if executor.device.type == "cuda":
        torch.cuda.synchronize(executor.device)
    arrays = {n: _to_numpy(val) for n, val in values.items()}
    np.savez(os.path.join(dirname, filename or PARAMS_FILE), **arrays)


def load_vars(executor, dirname: str, main_program=None,
              vars: Optional[Sequence] = None, predicate=None,
              filename: Optional[str] = None,
              scope: Optional[Scope] = None) -> None:
    """Read ``vars`` (or the program's vars that ``predicate`` selects,
    the persistable ones when None) from ``dirname/filename`` into
    ``scope`` (the current one when None), as tensors on ``executor``'s
    device. Raises, and loads nothing, when the file lacks any of them."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = _collect(program, predicate or _is_persistable)
    vars = list(vars)
    path = os.path.join(dirname, filename or PARAMS_FILE)
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    with np.load(path) as data:
        names = set(data.files)
        missing = [v.name for v in vars if v.name not in names]
        if missing:
            raise RuntimeError(
                f"checkpoint '{path}' is missing {len(missing)} of "
                f"{len(vars)} requested variables (e.g. {missing[:5]}); "
                f"refusing to partially load")
        for v in vars:
            scope.set(v.name, _to_tensor(data[v.name], executor.device))


def save_persistables(executor, dirname, main_program=None, filename=None):
    """Every persistable var of the program: parameters and optimizer,
    learning-rate and loss-scaling state (reference: io.py:462)."""
    save_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    """(reference: io.py:698)"""
    load_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename)


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=_is_parameter,
              filename=filename)


def load_params(executor, dirname, main_program=None, filename=None):
    """The parameters of ``main_program`` (the default main program when
    None) from ``dirname/filename`` into the current scope."""
    load_vars(executor, dirname, main_program, predicate=_is_parameter,
              filename=filename)


def scope_from_numpy(params: Dict[str, np.ndarray], place=None) -> Scope:
    """A Scope holding ``params`` as tensors on ``place``'s device
    (``CUDAPlace(0)`` unless the caller passes ``CPUPlace()``)."""
    device = resolve_device(place)
    scope = Scope()
    for name, arr in params.items():
        scope.set(name, _to_tensor(arr, device))
    return scope


def scope_from_params_file(dirname: str, place=None) -> Scope:
    """Read every array of ``dirname/__params__.npz`` into a new Scope on
    ``place``'s device (the ServingEngine's weights)."""
    with np.load(os.path.join(dirname, PARAMS_FILE)) as data:
        return scope_from_numpy({n: data[n] for n in data.files}, place)


def rekey_optimizer_state(values: Mapping[str, np.ndarray],
                          saved_slots: Mapping[str, dict],
                          target_slots: Mapping[str, dict]
                          ) -> Dict[str, np.ndarray]:
    """Re-key optimizer slot state from the saving optimizer's var names
    (``saved_slots``: its ``slot_descriptor()``) onto the restoring
    optimizer's (``target_slots``), joined on (param, kind). Entries that
    are not slots (parameters) pass through by name; a saved slot with no
    target is dropped, and a target slot with no saved value is left to
    the restoring startup program. Returns a new dict."""
    by_key = {(d["param"], d["slot"]): name
              for name, d in saved_slots.items()}
    out = {n: v for n, v in values.items() if n not in saved_slots}
    for tname, d in target_slots.items():
        sname = by_key.get((d["param"], d["slot"]))
        if sname is not None and sname in values:
            out[tname] = values[sname]
    return out
