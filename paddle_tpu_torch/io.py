"""Weights carried across from the JAX package.

Both packages name parameters alike (models/transformer.py), so weights
move by name: ``scope_from_numpy`` takes the arrays of a JAX-package
scope (``{n: np.asarray(scope.find_var(n))}``), ``scope_from_params_file``
reads the ``__params__.npz`` that ``paddle_tpu.io`` saves into a new
Scope, and ``load_params`` loads a program's parameters from that file
into the current scope, as the JAX package's ``io.load_params`` does.
Optimizer state (Adam moments, beta powers, the learning rate) moves by
(parameter, kind) instead: its var names come from per-build counters,
so ``rekey_optimizer_state`` maps them through both optimizers'
``slot_descriptor()``.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np

from paddle_tpu_torch.core.lowering import as_tensor
from paddle_tpu_torch.executor import Scope, global_scope
from paddle_tpu_torch.framework import default_main_program, resolve_device

# the JAX package's combined-parameters file (paddle_tpu/io.py)
PARAMS_FILE = "__params__.npz"


def scope_from_numpy(params: Dict[str, np.ndarray], place=None) -> Scope:
    """A Scope holding ``params`` as tensors on ``place``'s device
    (``CUDAPlace(0)`` unless the caller passes ``CPUPlace()``)."""
    device = resolve_device(place)
    scope = Scope()
    for name, arr in params.items():
        scope.set(name, as_tensor(np.asarray(arr), device))
    return scope


def scope_from_params_file(dirname: str, place=None) -> Scope:
    """Read every array of ``dirname/__params__.npz`` into a new Scope on
    ``place``'s device (the ServingEngine's weights)."""
    with np.load(os.path.join(dirname, PARAMS_FILE)) as data:
        return scope_from_numpy({n: data[n] for n in data.files}, place)


def load_params(executor, dirname: str, main_program=None,
                filename: Optional[str] = None) -> None:
    """Load the parameters of ``main_program`` (the default main program
    when None) from ``dirname/filename`` (``__params__.npz`` when None)
    into the current scope, on ``executor``'s device. Raises when the file
    lacks any of them rather than leave part of the model at its random
    initialization."""
    program = main_program or default_main_program()
    params = [v for v in program.list_vars() if v.is_parameter]
    path = os.path.join(dirname, filename or PARAMS_FILE)
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    scope = global_scope()
    with np.load(path) as data:
        missing = [v.name for v in params if v.name not in data.files]
        if missing:
            raise RuntimeError(
                f"checkpoint '{path}' is missing {len(missing)} of "
                f"{len(params)} requested variables (e.g. {missing[:5]}); "
                f"refusing to partially load")
        for v in params:
            scope.set(v.name, as_tensor(np.asarray(data[v.name]),
                                        executor.device))


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
