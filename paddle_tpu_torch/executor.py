"""Executor and Scope.

``Executor.run`` has the Fluid contract: feed a dict of arrays, fetch a
list of variables, read and commit persistable state through a Scope;
``Executor.run_steps`` runs several training steps. A block runs on the
executor's ``torch.device`` under ``torch.no_grad()``: gradients are ops
of the program (backward.py), and autograd is enabled only inside a
derived grad op (core/autodiff.py). A program marked ``_amp`` (amp.py)
runs its matmul-heavy ops in bf16.

The compiled step (core/lowering.py ``StepRunner``). A block with a fixed
feed signature runs as a captured CUDA graph, the counterpart of the JAX
package's jitted step: the first call of a cache key (program, feeds and
their shapes, fetches, Scope) runs eagerly, which warms it up; the
second captures the step and replays it; every later call replays. All
the graphs of one executor share one memory pool, so a program run with
a second fetch list or feed shape adds a graph, not a second copy of
its activations (core/lowering.py says why that is safe). The
Scope's state tensors keep their identity: a replay writes each new
value into the existing tensor. A call with ``use_program_cache=False``
keeps nothing and runs eagerly, committing fresh tensors. A block that
holds a ``host_rng`` op (a startup program's ``gaussian_random`` /
``uniform_random``, which draw from host-seeded generators) is never
captured: that is read from the program's ops before it runs, and such a
block runs eagerly at every call. Anything else that cannot be captured
raises, naming the program and the op; nothing gives way to an eager run
on the card. ``close()`` frees the graphs and their memory pool.

Seeds, as in the JAX package: the executor keeps one step counter,
advanced by one a run and by ``steps`` a window, and a step's seed is a
pure function of ``program.random_seed`` and the step index
(``rng.step_seed``, the counterpart of ``fold_in(base_key, step)``); a
random op's seed is ``mix64(step seed, forward_op_idx or its index)``
(core/interp.py). The step seed reaches the ops in a device tensor, so an
eager run and a replay of the same step draw the same masks, and
``run_steps(k)`` equals ``k`` successive ``run`` calls.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.core.lowering import as_tensor
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


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


class LazyFetches:
    """Deferred fetch results (``run`` / ``run_steps`` with
    ``async_fetch=True`` and ``return_numpy``): list-like, one element per
    fetch, numpy by the time an element is read, as in the JAX package.

    Construction queues every device-to-host copy without blocking: each
    fetch on the card is copied into pinned host memory on the stream
    that computed it (the current one: a replay and its fetch copies run
    there), and one CUDA event is recorded after the copies. A fetch on
    the CPU is kept as it is. The numpy conversion happens on first
    element access or ``wait()``, which waits for that event alone, so
    step N's fetches arrive while step N+1 is queued."""

    __slots__ = ("_tensors", "_host", "_event", "_values")

    def __init__(self, tensors):
        self._tensors = list(tensors)
        self._values = None
        self._event = None
        self._host = []
        for t in self._tensors:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
                if self._event is None:
                    self._event = torch.cuda.Event()
            else:
                self._host.append(t)
        if self._event is not None:
            self._event.record(torch.cuda.current_stream(
                next(t.device for t in self._tensors if t.is_cuda)))

    @property
    def ready(self) -> bool:
        """Whether the fetches have already materialized to numpy."""
        return self._values is not None

    def wait(self) -> list:
        """Materialize every fetch to numpy (idempotent)."""
        if self._values is None:
            if self._event is not None:
                self._event.synchronize()
            self._values = [to_numpy(h) for h in self._host]
            # release the device and pinned buffers
            self._tensors = self._host = self._event = None
        return self._values

    def __len__(self):
        vals = self._values
        return len(vals if vals is not None else self._tensors)

    def __getitem__(self, i):
        return self.wait()[i]

    def __iter__(self):
        return iter(self.wait())

    def __repr__(self):
        state = "ready" if self.ready else "pending"
        return f"LazyFetches({len(self)} fetches, {state})"


class Executor:
    """Runs programs on one device: ``place`` defaults to ``CUDAPlace(0)``
    and raises when CUDA is absent; pass ``CPUPlace()`` for the CPU. See
    the module docstring for the captured step and the seeds."""

    def __init__(self, place: Optional[Union[CPUPlace, CUDAPlace]] = None):
        self.device = resolve_device(place)
        self._cache: Dict[tuple, lowering.LoweredBlock] = {}
        # Scope -> {(cache key, (feed signature, random_seed)): StepRunner}
        self._runners: "weakref.WeakKeyDictionary[Scope, Dict]" = (
            weakref.WeakKeyDictionary())
        # the step counter: one a run, ``steps`` a run_steps window
        self._step = 0
        # the seed buffer of uncached (eager) runs
        self._eager_seed: Optional[torch.Tensor] = None
        # the memory pool every captured graph of this executor shares
        self._pool = None

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
        """Run block 0 of ``program``. Returns the fetches as numpy arrays;
        with ``async_fetch`` as ``LazyFetches``, whose copies to the host
        are queued now and read later, after the caller has queued more
        work (a replay's fetches are copies out of the graph's pool, which
        the next replay leaves alone); as device tensors when
        ``return_numpy`` is False, whatever ``async_fetch`` says.
        ``use_program_cache=False`` lowers the program afresh, keeps
        nothing and runs eagerly. The arguments come in the JAX package's
        order."""
        program = program if program is not None else default_main_program()
        scope = scope or global_scope()
        fetches = self._run_step(program, feed or {}, self._fetch_names(
            fetch_list), scope, use_program_cache)
        return self._format(fetches, return_numpy, async_fetch)

    @staticmethod
    def _fetch_names(fetch_list):
        return [f.name if isinstance(f, Variable) else str(f)
                for f in (fetch_list or [])]

    @staticmethod
    def _format(fetches, return_numpy, async_fetch):
        if not return_numpy:
            return list(fetches)
        if async_fetch:
            return LazyFetches(fetches)
        return [to_numpy(t) for t in fetches]

    def _run_step(self, program, feed, fetch_names, scope,
                  use_program_cache=True):
        """One step of ``program`` at the executor's next step index."""
        feed_names = sorted(feed)
        amp = bool(program._amp)
        key = (program._uid, program.version, amp, tuple(feed_names),
               tuple(fetch_names))
        step = self._step
        self._step += 1
        lowered = self._cache.get(key) if use_program_cache else None
        if lowered is None:
            lowered = lowering.lower_block(program, 0, feed_names,
                                           fetch_names, self.device, amp)
            if use_program_cache:
                self._cache[key] = lowered
        if not use_program_cache:
            if self._eager_seed is None:
                self._eager_seed = torch.zeros((), dtype=torch.int64,
                                               device=self.device)
            return lowering.run_eager(
                lowered, scope, {k: as_tensor(feed[k], self.device)
                                 for k in feed_names}, self.device,
                self._eager_seed, program.random_seed, step)
        signature = (tuple((k, *_shape_dtype(feed[k])) for k in feed_names),
                     program.random_seed)
        runners = self._runners.setdefault(scope, {})
        runner = runners.get((key, signature))
        if runner is None:
            if self._pool is None and self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            runner = runners[(key, signature)] = lowering.StepRunner(
                lowered, self.device, program.random_seed,
                f"program {program._uid} (version {program.version})",
                self._pool)
        return runner.run(scope, {k: feed[k] for k in feed_names}, step)

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
        return the LAST step's fetches, as ``run`` returns them. The
        window's feeds are staged on the device once; then each step is
        one call of the program's step (a replay of its CUDA graph from
        the second call on), so the random streams equal those of
        ``steps`` successive ``run`` calls."""
        if not feed_list:
            raise ValueError("run_steps needs a non-empty feed_list")
        if steps < 1:
            raise ValueError(f"run_steps: steps={steps}, expected >= 1")
        program = program if program is not None else default_main_program()
        scope = scope or global_scope()
        fetch_names = self._fetch_names(fetch_list)
        staged = [{k: as_tensor(v, self.device) for k, v in f.items()}
                  for f in feed_list[:steps]]
        for i in range(steps):
            fetches = self._run_step(program, staged[i % len(staged)],
                                     fetch_names, scope)
        return self._format(fetches, return_numpy, async_fetch)

    def close(self):
        """Drop the lowered programs and free every captured graph and
        their memory pool (the Scopes keep their tensors)."""
        for runners in list(self._runners.values()):
            for runner in runners.values():
                runner.close()
        self._runners = weakref.WeakKeyDictionary()
        self._cache.clear()
        self._pool = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _shape_dtype(value):
    """(shape, torch dtype) of a feed value, an array or a tensor: a
    captured step is bound to both."""
    if isinstance(value, torch.Tensor):
        return tuple(value.shape), value.dtype
    a = np.asarray(value)
    return a.shape, torch.from_numpy(np.empty(0, a.dtype)).dtype
