"""Executor and Scope.

``Executor.run`` has the Fluid contract: feed a dict of arrays, fetch a
list of variables, read and commit persistable state through a Scope.
A block runs eagerly on the executor's ``torch.device`` (one PyTorch
call per op, core/lowering.py), under ``torch.inference_mode()``: no
program of this package holds gradient ops yet.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.framework import (
    CPUPlace,
    CUDAPlace,
    Variable,
    default_main_program,
    resolve_device,
)


class Scope:
    """name -> tensor container. Values committed by the executor are
    tensors on its device; numpy values (weights carried in from
    elsewhere, zeroed state) are accepted and moved to the device on
    first use."""

    def __init__(self):
        self._vars: Dict[str, Any] = {}

    def set(self, name: str, value):
        self._vars[name] = value

    def find_var(self, name: str):
        return self._vars.get(name)

    def var_names(self) -> List[str]:
        return list(self._vars)

    def clear(self):
        self._vars.clear()


_global_scope = Scope()


class _ScopeTLS(threading.local):
    def __init__(self):
        self.stack: List[Scope] = []


_scope_tls = _ScopeTLS()


def global_scope() -> Scope:
    stack = _scope_tls.stack
    return stack[-1] if stack else _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    """Swap the ambient scope. On a worker thread the guard is
    thread-local; the main thread swaps the process-global scope, which
    unguarded worker threads inherit."""
    if threading.current_thread() is threading.main_thread():
        global _global_scope
        old, _global_scope = _global_scope, scope
        try:
            yield
        finally:
            _global_scope = old
    else:
        _scope_tls.stack.append(scope)
        try:
            yield
        finally:
            _scope_tls.stack.pop()


def as_tensor(value, device: torch.device) -> torch.Tensor:
    """A feed or scope value as a tensor on ``device`` (numpy arrays are
    copied, so the caller may reuse its buffer)."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.from_numpy(np.array(value)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


class Executor:
    """Runs programs on one device: ``place`` defaults to ``CUDAPlace(0)``
    and raises when CUDA is absent; pass ``CPUPlace()`` for the CPU."""

    def __init__(self, place: Optional[Union[CPUPlace, CUDAPlace]] = None):
        self.device = resolve_device(place)
        self._cache: Dict[tuple, lowering.LoweredBlock] = {}
        self._generators: Dict[int, torch.Generator] = {}

    def run(
        self,
        program=None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
        scope: Optional[Scope] = None,
        async_fetch: bool = False,
    ):
        """Run block 0 of ``program``. Returns the fetches as numpy arrays,
        or as the device tensors themselves when ``async_fetch`` (the
        caller materializes them later, after it has queued more work).
        Random ops draw from the executor's generator for
        ``program.random_seed``."""
        program = program if program is not None else default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        feed_names = sorted(feed)
        key = (program._uid, program.version, tuple(feed_names),
               tuple(fetch_names))
        lowered = self._cache.get(key)
        if lowered is None:
            lowered = lowering.lower_block(program, 0, feed_names,
                                           fetch_names, self.device)
            self._cache[key] = lowered
        state = self._gather_state(scope, lowered)
        feeds = {k: as_tensor(feed[k], self.device) for k in feed_names}
        gen = self._generator_for(program) if lowered.needs_rng else None
        with torch.inference_mode():
            fetches, new_state = lowered.fn(state, feeds, gen)
        # Commit: the scope now holds the tensors the block produced. Ops
        # are functional, so the previous state tensors are released when
        # nothing else references them — the counterpart of the JAX
        # package's buffer donation.
        for n, v in new_state.items():
            scope.set(n, v)
        if async_fetch:
            return list(fetches)
        return [to_numpy(t) for t in fetches]

    def _gather_state(self, scope, lowered):
        state = {}
        for n in lowered.state_in_names:
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"variable '{n}' used by the program is not initialized "
                    f"in the scope — run the startup program first")
            if not (isinstance(v, torch.Tensor) and v.device == self.device):
                v = as_tensor(v, self.device)
                scope.set(n, v)  # resident on the device from now on
            state[n] = v
        return state

    def _generator_for(self, program) -> torch.Generator:
        seed = program.random_seed if program.random_seed is not None else 0
        gen = self._generators.get(seed)
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            self._generators[seed] = gen
        return gen

    def close(self):
        self._cache.clear()
