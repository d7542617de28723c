"""Weights carried across from the JAX package.

Both packages name parameters alike (models/transformer.py), so weights
move by name: ``scope_from_numpy`` takes the arrays of a JAX-package
scope (``{n: np.asarray(scope.find_var(n))}``) and ``load_params`` reads
the ``__params__.npz`` that ``paddle_tpu.io`` saves.
"""

from __future__ import annotations

import os
from typing import Dict

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
