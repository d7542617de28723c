"""Weights carried across from the JAX package.

Both packages name parameters alike (models/transformer.py), so weights
move by name: ``scope_from_numpy`` takes the arrays of a JAX-package
scope (``{n: np.asarray(scope.find_var(n))}``) and ``load_params`` reads
the ``__params__.npz`` that ``paddle_tpu.io`` saves. Optimizer state
(Adam moments, beta powers, the learning rate) moves by (parameter,
kind) instead: its var names come from per-build counters, so
``rekey_optimizer_state`` maps them through both optimizers'
``slot_descriptor()``.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np

from paddle_tpu_torch.executor import Scope, as_tensor
from paddle_tpu_torch.framework import resolve_device

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


def load_params(dirname: str, place=None) -> Scope:
    """Read ``dirname/__params__.npz`` into a Scope on ``place``'s device."""
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
