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
block runs eagerly at every call. So does a block that holds a ``while``
op, whose loop runs on the host: its body is captured on its own
(core/lowering.py ``LoopRunner``), one runner by (program, op, shapes)
on the executor, in its graph pool. So does a block that holds a
``print`` or ``py_func`` op at any depth of sub-blocks (a host callback
at every step): ``lowering.uncaptured_steps`` counts its steps. Anything else that cannot be captured
raises, naming the program and the op; nothing gives way to an eager run
on the card. ``close()`` frees the graphs and their memory pool.

Telemetry, as in the JAX package (monitor.py, faults.py, numerics.py):
the ``pt_executor_*`` counters, the ``executor.step`` fault site before
dispatch and ``executor.fetch`` in ``LazyFetches.wait``, the memory
budget pre-flight before a fresh lowering, OOM forensics around dispatch
and fetch, the ``executor.run_step`` / ``executor.run_window`` spans and
one ``log_step`` record a call, sampled step phases and device-memory
samples, and an instrumented program's numerics bundle as one more fetch
of the same step (its captured graph on the card), decoded on sampled
steps. A phase-sampled step stages its feeds and synchronizes the step's
stream after dispatch (the ``device`` phase); every other step stays
asynchronous. With the ``telemetry`` flag off each hook costs one
boolean check and allocates nothing. The replay, the fetch copies and
the event ``LazyFetches`` waits on are all queued on the calling
thread's current stream (the device's default stream unless the caller
set another), so a step and its fetch share a stream whichever thread
drives the executor. Every call of an executor that reaches the card
(``run``, ``run_steps``, ``LazyFetches.wait``, ``close``) holds the
process-wide capture gate shared, and a capture holds it alone
(core/lowering.py ``GATE``), so executors on several threads (a serving
fleet's replicas) capture and replay side by side.

``close()`` frees the graphs and the pool and keeps the executor usable
(the next run lowers afresh); ``retire(reason)`` closes it for good: a
later run raises. A serving engine retires its executor when it closes,
so a loop thread that wakes after its engine was replaced cannot replay
a reset graph.

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
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch import faults as _faults
from paddle_tpu_torch import monitor as _monitor
from paddle_tpu_torch import numerics as _numerics
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.core.lowering import GATE as _GATE
from paddle_tpu_torch.core.lowering import as_tensor
from paddle_tpu_torch.framework import (
    CPUPlace,
    CUDAPlace,
    Variable,
    default_main_program,
    resolve_device,
)


# Telemetry instruments (no-ops while the 'telemetry' flag is off: one
# boolean check per call, zero allocations; see monitor.py). The names
# and docs are the JAX package's; the port's lowering cache is the
# compile cache (a miss lowers the program afresh).
_M_CACHE_HITS = _monitor.counter(
    "pt_executor_cache_hits_total", "compiled-step cache hits")
_M_CACHE_MISSES = _monitor.counter(
    "pt_executor_cache_misses_total",
    "compiled-step cache misses (fresh compiles)")
_M_CACHE_EVICTIONS = _monitor.counter(
    "pt_executor_cache_evictions_total",
    "compiled-step cache entries evicted at capacity")
_M_DONATED_DROPS = _monitor.counter(
    "pt_executor_donated_drops_total",
    "donated state buffers dropped after a failed step")
_M_STEPS = _monitor.counter(
    "pt_executor_steps_total",
    "executor steps run (run_steps windows count each inner step)")
_M_FEED_BYTES = _monitor.counter(
    "pt_executor_feed_bytes_total",
    "bytes across feed arrays per step (an upper bound on host->device "
    "transfer: device-resident or staging-cached feeds count too)")
_M_FETCH_BYTES = _monitor.counter(
    "pt_executor_fetch_bytes_total", "bytes across fetch arrays per step")
_M_NAN_FAILS = _monitor.counter(
    "pt_executor_nan_check_failures_total",
    "check_nan_inf scans that found non-finite values")

# chaos hooks (faults.py): armed plans can delay the step body (the sleep
# lands in the dispatch phase) or raise a synthetic RESOURCE_EXHAUSTED
# (the OOM-forensics drill)
_F_STEP = _faults.site("executor.step")
# deferred-fetch materialization (LazyFetches.wait): a raised
# RESOURCE_EXHAUSTED here drills the async-dispatch error path, the
# device failure that surfaces only when the fetch lands
_F_FETCH = _faults.site("executor.fetch")


def _sum_nbytes(vals) -> int:
    total = 0
    for v in vals:
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        else:
            n = getattr(v, "nbytes", None)
            if n is not None:
                total += int(n)
    return total


def _sync(device: torch.device):
    """Wait for the work queued on this thread's current stream of
    ``device`` (the step's stream); nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


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

    def drop(self, name: str):
        self._vars.pop(name, None)

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

    __slots__ = ("_tensors", "_host", "_event", "_values", "_on_error",
                 "_t0")

    def __init__(self, tensors, on_error=None):
        self._tensors = list(tensors)
        self._values = None
        self._event = None
        self._on_error = on_error
        self._t0 = time.perf_counter() if _monitor.enabled() else 0.0
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
            try:
                _F_FETCH.hit()
                # the event's wait and the release of the pinned buffers
                # are CUDA calls: under the capture gate (core/lowering.py)
                with (_GATE.shared() if self._event is not None
                      else contextlib.nullcontext()):
                    if self._event is not None:
                        self._event.synchronize()
                    self._values = [to_numpy(h) for h in self._host]
                    # release the device and pinned buffers
                    self._tensors = self._host = self._event = None
            except Exception as e:
                cb, self._on_error = self._on_error, None
                if cb is not None:
                    cb(e)
                raise
            self._on_error = None
            if self._t0:
                _monitor.fetch_overlap(time.perf_counter() - self._t0)
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
    the module docstring for the captured step, the telemetry hooks and
    the seeds."""

    def __init__(self, place: Optional[Union[CPUPlace, CUDAPlace]] = None):
        self.device = resolve_device(place)
        self._place = place
        self._cache: Dict[tuple, lowering.LoweredBlock] = {}
        # Scope -> {(cache key, (feed signature, random_seed)): StepRunner}
        self._runners: "weakref.WeakKeyDictionary[Scope, Dict]" = (
            weakref.WeakKeyDictionary())
        # the step counter: one a run, ``steps`` a run_steps window
        self._step = 0
        # the seed buffer of uncached (eager) runs
        self._eager_seed: Optional[torch.Tensor] = None
        # the while loops' body runners (core/lowering.py LoopRunner), by
        # (program, op, shapes)
        self._loop_runners: Dict[tuple, lowering.LoopRunner] = {}
        # the memory pool every captured graph of this executor shares
        self._pool = None
        # why the executor was retired (a run then raises), or None
        self._retired: Optional[str] = None

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
        tele = _monitor.enabled()
        # wall_ms covers the whole call, feed staging included
        t_run0 = time.perf_counter() if tele else 0.0
        program = program if program is not None else default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = self._fetch_names(fetch_list)
        if not tele:
            _F_STEP.hit()
            with _GATE.shared():
                fetches = self._run_step(program, feed, fetch_names, scope,
                                         use_program_cache)
                return self._format(fetches, return_numpy, async_fetch)
        with _GATE.shared():
            return self._run_observed(
                program, [feed], 1, fetch_names, scope, return_numpy,
                use_program_cache, async_fetch, t_run0, self._step)

    @staticmethod
    def _fetch_names(fetch_list):
        return [f.name if isinstance(f, Variable) else str(f)
                for f in (fetch_list or [])]

    @staticmethod
    def _format(fetches, return_numpy, async_fetch, on_error=None):
        if not return_numpy:
            return list(fetches)
        if async_fetch:
            return LazyFetches(fetches, on_error=on_error)
        return [to_numpy(t) for t in fetches]

    def _lowered(self, program, feed_names, fetch_names,
                 use_program_cache=True, feed=None):
        """The lowered block of ``program`` for these feeds and fetches,
        from the cache or lowered now; returns (lowered, cache key,
        outcome "hit" | "miss", lowering ms or None on a hit)."""
        if self._retired is not None:
            raise RuntimeError(
                f"run on a retired executor ({self._retired}); it "
                f"refuses to run once retired")
        amp = bool(program._amp)
        key = (program._uid, program.version, amp, tuple(feed_names),
               tuple(fetch_names))
        lowered = self._cache.get(key) if use_program_cache else None
        if lowered is not None:
            _M_CACHE_HITS.inc()
            return lowered, key, "hit", None
        _M_CACHE_MISSES.inc()
        if (feed is not None and _monitor.enabled()
                and _monitor.memory_budget_bytes() > 0):
            # pre-flight before lowering: a program whose static estimate
            # already exceeds the device budget warns now
            _monitor.check_memory_budget(
                program, {k: tuple(np.shape(v)) if not isinstance(
                    v, torch.Tensor) else tuple(v.shape)
                    for k, v in feed.items()})
        t0 = time.perf_counter()
        with _monitor.span("executor.compile"):
            lowered = lowering.lower_block(program, 0, feed_names,
                                           fetch_names, self.device, amp)
        t1 = time.perf_counter()
        if _monitor.enabled():
            _monitor.trace_event("executor.compile", "compile", t0, t1)
        if use_program_cache:
            self._cache[key] = lowered
        return lowered, key, "miss", (t1 - t0) * 1e3

    def _run_step(self, program, feed, fetch_names, scope,
                  use_program_cache=True, info=None):
        """One step of ``program`` at the executor's next step index.
        ``info``: a dict that receives the cache outcome and lowering ms."""
        feed_names = sorted(feed)
        lowered, key, outcome, compile_ms = self._lowered(
            program, feed_names, fetch_names, use_program_cache, feed)
        if info is not None:
            info["cache"], info["compile_ms"] = outcome, compile_ms
        step = self._step
        self._step += 1
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
        what = f"program {program._uid} (version {program.version})"
        if self._pool is None and self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
        if runner is None:
            runner = runners[(key, signature)] = lowering.StepRunner(
                lowered, self.device, program.random_seed, what, self._pool)
        ctx = lowering.LoopContext(self._loop_runners, self._pool, what)
        with lowering.loop_context(ctx):
            return runner.run(scope, {k: feed[k] for k in feed_names}, step)

    def _run_observed(self, program, feeds, steps, fetch_names, scope,
                      return_numpy, use_program_cache, async_fetch, t_run0,
                      start):
        """``run`` / ``run_steps`` with telemetry on: the step record,
        spans, phases, OOM forensics, device-memory samples and the
        numerics decode around the same steps the plain path runs."""
        # an instrumented program's stats bundle rides the same step as
        # one extra fetch (resolved before the cache key: attaching a
        # plan bumps the program version)
        nplan = _numerics.plan_for(program) if _numerics.active() else None
        run_fetch = (fetch_names if nplan is None
                     else fetch_names + [nplan.bundle_var])
        window = steps > 1 or len(feeds) > 1
        ph = _monitor.phases_active()
        sampled = ph and _monitor.phases_sampled(start, steps)
        t_f0 = t_f1 = t_c1 = t_b1 = t_x0 = t_x1 = 0.0
        if sampled:
            # stage the feeds on the device and wait for the copies, so
            # the feed phase measures the host->device transfer
            t_f0 = time.perf_counter()
            feeds = [{k: as_tensor(v, self.device) for k, v in f.items()}
                     for f in feeds]
            _sync(self.device)
            t_f1 = time.perf_counter()
        _M_STEPS.inc(int(steps))
        feed_bytes = sum(_sum_nbytes(feeds[i % len(feeds)].values())
                         for i in range(steps))
        _M_FEED_BYTES.inc(feed_bytes)
        info: Dict[str, Any] = {}
        rec = None
        if _monitor.step_records_active():
            rec = {"kind": "window" if window else "step", "step": start,
                   "compile_ms": None, "cache": "hit", "evictions": 0,
                   "feed_bytes": feed_bytes, "fetch_bytes": 0,
                   "nan_check": None, "strategy": None}
            if window:
                rec["steps"] = int(steps)
            if ph:
                rec["sampled"] = sampled
        bundle = None
        try:
            with _monitor.span("executor.run_window" if window
                               else "executor.run_step"):
                try:
                    _F_STEP.hit()
                    for i in range(steps):
                        fetches = self._run_step(
                            program, feeds[i % len(feeds)], run_fetch,
                            scope, use_program_cache, info)
                        if rec is not None and info["cache"] == "miss":
                            rec["cache"] = "miss"
                            rec["compile_ms"] = info["compile_ms"]
                except Exception as e:
                    _monitor.maybe_record_oom(e, program=program,
                                              phase="run")
                    raise
            if sampled:
                t_c1 = time.perf_counter()
                # device phase: wait for the step's stream; a deferred
                # device error surfaces here
                try:
                    _sync(self.device)
                except Exception as e:
                    _monitor.maybe_record_oom(e, program=program,
                                              phase="run")
                    raise
                t_b1 = time.perf_counter()
            if nplan is not None:
                bundle, fetches = fetches[-1], fetches[:-1]
            if sampled:
                t_x0 = time.perf_counter()
            try:
                out = self._format(
                    fetches, return_numpy, async_fetch,
                    on_error=self._fetch_error_cb(program)
                    if async_fetch else None)
            except Exception as e:
                _monitor.maybe_record_oom(e, program=program, phase="run")
                raise
            nbytes = _sum_nbytes(fetches)
            _M_FETCH_BYTES.inc(nbytes)
            if rec is not None:
                rec["fetch_bytes"] = nbytes
            if sampled:
                t_x1 = time.perf_counter()
            return out
        finally:
            # decoded even when the step raises; the record is logged
            # then too: the crashed step's record is the one an operator
            # needs for a post-mortem
            if bundle is not None and (
                    _numerics.should_sample_window(start, steps) if window
                    else _numerics.should_sample(start)):
                summary = _numerics.decode(program, nplan, bundle,
                                           start + steps - 1,
                                           kind="window" if window
                                           else "step")
                if rec is not None:
                    rec["numerics"] = summary
            _monitor.sample_device_memory(start, int(steps))
            if rec is not None:
                rec["wall_ms"] = (time.perf_counter() - t_run0) * 1e3
                if t_x1 > 0.0:
                    self._attribute_phases(
                        rec, start, t_run0, t_f0, t_f1, t_c1, t_b1, t_x0,
                        t_x1, steps, scored=rec["cache"] == "hit")
                elif ph:
                    _monitor.discard_input_wait()
                _monitor.log_step(rec)

    @staticmethod
    def _attribute_phases(rec, step_idx, t_run0, t_f0, t_f1, t_c1, t_b1,
                          t_x0, t_x1, steps=1, scored=True):
        """Fold a completed step's perf_counter marks into the phase
        breakdown (the JAX package's ``_attribute_phases``): feed = the
        staged host->device copies, dispatch = the host work around them
        and the step's launches (or graph replay), device = the wait for
        the step's stream, fetch = the device->host copies. A step that
        lowered (``scored=False``) stays out of the verdict window."""
        feed_s = t_f1 - t_f0
        disp_s = (t_f0 - t_run0) + (t_c1 - t_f1)
        dev_s = t_b1 - t_c1
        fetch_s = t_x1 - t_x0
        rec["phases"] = {"feed": feed_s * 1e3, "dispatch": disp_s * 1e3,
                         "device": dev_s * 1e3, "fetch": fetch_s * 1e3}
        verdict = _monitor.record_step_phases(feed_s, disp_s, dev_s,
                                              fetch_s, scored=scored)
        if verdict is not None:
            rec["bound"] = verdict
        if _monitor.trace_step_sampled(step_idx, steps):
            step = {"step": step_idx}
            _monitor.trace_event("dispatch", "phase", t_run0, t_f0,
                                 args=step)
            _monitor.trace_event("feed", "phase", t_f0, t_f1, args=step)
            _monitor.trace_event("dispatch", "phase", t_f1, t_c1,
                                 args=step)
            _monitor.trace_event("device", "phase", t_c1, t_b1, args=step)
            _monitor.trace_event("fetch", "phase", t_x0, t_x1, args=step)

    @staticmethod
    def _fetch_error_cb(program):
        """Deferred-fetch failure hook (LazyFetches): the OOM forensics
        the synchronous sites run, at materialization time."""
        def on_error(e):
            _monitor.maybe_record_oom(e, program=program, phase="fetch")
        return on_error

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
        tele = _monitor.enabled()
        t_run0 = time.perf_counter() if tele else 0.0
        program = program if program is not None else default_main_program()
        scope = scope or global_scope()
        fetch_names = self._fetch_names(fetch_list)
        with _GATE.shared():
            staged = [{k: as_tensor(v, self.device) for k, v in f.items()}
                      for f in feed_list[:steps]]
            if tele:
                return self._run_observed(
                    program, staged, int(steps), fetch_names, scope,
                    return_numpy, True, async_fetch, t_run0, self._step)
            _F_STEP.hit()
            for i in range(steps):
                fetches = self._run_step(program, staged[i % len(staged)],
                                         fetch_names, scope)
            return self._format(fetches, return_numpy, async_fetch)

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """Drive a Dataset (InMemory/Queue, dataset_api.py) through the
        program's step (reference: executor.py:846
        ``train_from_dataset``): a DeviceLoader stages the dataset's
        batches ``thread``-deep (the dataset's thread count when 0, at
        least 2) on the executor's device while the step runs. Returns
        the number of steps run."""
        if dataset is None:
            raise ValueError("train_from_dataset needs a dataset")
        from paddle_tpu_torch.reader.pipeline import DeviceLoader

        fetch_list = list(fetch_list or [])
        names = self._fetch_names(fetch_list)
        info = list(fetch_info or names)
        depth = int(thread or 0) or int(
            getattr(dataset, "_thread_num", 0) or 0)
        loader = DeviceLoader(
            dataset.batch_reader(),
            feed_names=list(getattr(dataset, "_use_var_names", []) or []),
            depth=max(2, depth), place=self._place,
        )
        steps = 0
        for feed in loader:
            fetches = self.run(program, feed=feed, fetch_list=fetch_list,
                               scope=scope)
            steps += 1
            if debug and fetch_list and steps % print_period == 0:
                msg = ", ".join(
                    f"{k}={np.asarray(v).ravel()[:4]}"
                    for k, v in zip(info, fetches))
                print(f"[train_from_dataset] step {steps}: {msg}")
        return steps

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """Inference twin of ``train_from_dataset`` (reference:
        executor.py ``infer_from_dataset``): the same drive loop over a
        program that holds no optimizer ops."""
        return self.train_from_dataset(program, dataset, scope, thread,
                                       debug, fetch_list, fetch_info,
                                       print_period)

    def release_scope(self, scope) -> int:
        """Free the captured steps bound to ``scope`` (their graphs,
        their share of the pool, their feed buffers) and keep the rest:
        the per-tenant half of ``close()`` for an executor shared by
        several engines. The lowered programs are not keyed by scope and
        stay cached. Returns the number of runners released."""
        with _GATE.shared():
            runners = self._runners.pop(scope, None) or {}
            for runner in runners.values():
                runner.close()
        return len(runners)

    def close(self):
        """Drop the lowered programs and free every captured graph and
        their memory pool (the Scopes keep their tensors). The executor
        stays usable: its next run lowers afresh."""
        with _GATE.shared():
            for runners in list(self._runners.values()):
                for runner in runners.values():
                    runner.close()
            self._runners = weakref.WeakKeyDictionary()
            for runner in self._loop_runners.values():
                runner.close()
            self._loop_runners = {}
            self._cache.clear()
            self._pool = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def retire(self, reason: str = "closed"):
        """``close()`` for good: every later ``run`` / ``run_steps``
        raises, naming ``reason``."""
        self._retired = str(reason)
        self.close()


def _shape_dtype(value):
    """(shape, torch dtype) of a feed value, an array or a tensor: a
    captured step is bound to both."""
    if isinstance(value, torch.Tensor):
        return tuple(value.shape), value.dtype
    a = np.asarray(value)
    return a.shape, torch.from_numpy(np.empty(0, a.dtype)).dtype
