"""Executor and Scope.

``Executor.run`` has the Fluid contract: feed a dict of arrays, fetch a
list of variables, read and commit persistable state through a Scope;
``Executor.run_steps`` runs several training steps. A block runs eagerly
on the executor's ``torch.device`` (one PyTorch call per op,
core/lowering.py) under ``torch.no_grad()``: gradients are ops of the
program (backward.py), and autograd is enabled only inside a derived
grad op (core/autodiff.py). A program marked ``_amp`` (amp.py) runs its
matmul-heavy ops in bf16.
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
        # program seed -> the host-side stream each run's base seed is
        # drawn from
        self._generators: Dict[int, torch.Generator] = {}

    def run(
        self,
        program=None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,
        async_fetch: bool = False,
    ):
        """Run block 0 of ``program``. Returns the fetches as numpy arrays,
        or as the device tensors themselves when ``return_numpy`` is False
        or ``async_fetch`` (the caller materializes them later, after it
        has queued more work). ``use_program_cache=False`` lowers the
        program afresh and keeps nothing. The arguments come in the JAX
        package's order. A run of a program with random ops draws one
        base seed from the executor's stream for ``program.random_seed``;
        each random op derives its own seed from it (core/interp.py)."""
        program = program if program is not None else default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        feed_names = sorted(feed)
        amp = bool(program._amp)
        key = (program._uid, program.version, amp, tuple(feed_names),
               tuple(fetch_names))
        lowered = self._cache.get(key) if use_program_cache else None
        if lowered is None:
            lowered = lowering.lower_block(program, 0, feed_names,
                                           fetch_names, self.device, amp)
            if use_program_cache:
                self._cache[key] = lowered
        state = self._gather_state(scope, lowered)
        feeds = {k: as_tensor(feed[k], self.device) for k in feed_names}
        seed = self._next_seed(program) if lowered.needs_rng else None
        with torch.no_grad():
            fetches, new_state = lowered.fn(state, feeds, seed)
        # Commit: the scope now holds the tensors the block produced. Ops
        # are functional, so the previous state tensors are released when
        # nothing else references them — the counterpart of the JAX
        # package's buffer donation.
        for n, v in new_state.items():
            scope.set(n, v)
        if async_fetch or not return_numpy:
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

    def run_steps(
        self,
        program=None,
        feed_list: Optional[Sequence[Dict[str, Any]]] = None,
        steps: int = 1,
        fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        async_fetch: bool = False,
    ):
        """Run ``steps`` iterations of ``program``, rotating over
        ``feed_list`` (step i consumes feed ``i % len(feed_list)``), and
        return the LAST step's fetches, as ``run`` returns them. Each step
        is one ``run``, so the random streams equal those of ``steps``
        successive ``run`` calls."""
        if not feed_list:
            raise ValueError("run_steps needs a non-empty feed_list")
        if steps < 1:
            raise ValueError(f"run_steps: steps={steps}, expected >= 1")
        for i in range(steps - 1):
            self.run(program, feed_list[i % len(feed_list)], None, scope)
        return self.run(program, feed_list[(steps - 1) % len(feed_list)],
                        fetch_list, scope, return_numpy,
                        async_fetch=async_fetch)

    def _next_seed(self, program) -> int:
        """The next base seed of ``program.random_seed``'s stream (drawn
        on the host: no device sync)."""
        seed = program.random_seed if program.random_seed is not None else 0
        gen = self._generators.get(seed)
        if gen is None:
            gen = torch.Generator()
            gen.manual_seed(seed)
            self._generators[seed] = gen
        return int(torch.randint(0, 2**62, (), generator=gen))

    def close(self):
        self._cache.clear()
