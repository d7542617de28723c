"""Block -> callable, and the captured step.

The JAX package traces a block into one jitted XLA computation
(``lower_block``, ``jit_lowered``, ``jit_lowered_multi``). Here the same
analysis (which persistable vars the block reads and writes) feeds a
plain Python callable that runs the block's ops eagerly on one device
(``lower_block``), and a ``StepRunner`` that runs that callable as a
captured CUDA graph (``torch.cuda.CUDAGraph``), the counterpart of the
compiled step: one launch replays every kernel of the block with no
Python in between.

A ``StepRunner`` is one lowered block bound to one Scope and one feed
signature. It owns

- static feed buffers, which each call's feeds are copied into;
- the state buffers, which are the Scope's own tensors: the captured step
  copies each new state value into the existing tensor, in place, at its
  end, so the Scope entries keep their identity across replays. That is
  the counterpart of the JAX package's buffer donation (the old value's
  memory holds the new one). Before each replay the runner checks every
  state name: where the Scope holds another tensor (another program or an
  eager run committed a new one, or the caller set one), that tensor is
  copied into the buffer once and the Scope is bound to the buffer again,
  so programs that share state (serving's prefill, decode step and slot
  scrub) keep seeing each other's writes;
- the device step counter and the run's seed buffer: the captured step
  derives its step seed from the counter (``rng.mix64_tensor``) and
  advances the counter itself, so every replay draws new dropout masks;
- one ``torch.cuda.CUDAGraph``. Its memory (the step's intermediates, and
  its outputs between replays) comes from a pool that all the runners of
  one executor share (``torch.cuda.graph_pool_handle()``): a second fetch
  list or feed shape of a program captures a second graph, which reuses
  the first one's intermediates instead of holding a pool of its own.
  That is safe because the replays run one after another on one stream
  and no graph reads pool memory across replays: each one reads its
  feed, state and seed buffers, which lie outside the pool; its
  intermediates are dead when its replay ends; and its outputs, which
  may share memory with an earlier graph's intermediates, are copied out
  (the returned fetches, the state commit) before the next replay.

Its first call runs eagerly (the warm-up: kernel builds, cuBLAS handles,
autograd's first use); the second captures the step and replays it; every
later call replays. Each replay adds to the kernel wrappers' launch
counters what the capturing thread counted while the step was captured
(kernels.py ``recording``), so the counts keep meaning launches the
device ran. On the CPU the same runner calls the step function directly
instead of a graph, with the same buffers and seeds, and its first such
call takes the gate and records its launches as a capture does: the CPU
tests reach its bookkeeping that way. A capture or replay that fails
raises, naming the program and, where the failing op is known, the op;
nothing gives way to an eager run.

**Host loops** (``LoopRunner``). A ``while`` op's trip count depends on
the data, which a CUDA graph cannot hold, so a block that holds one is
not captured (``capturable``) and runs eagerly at every call; the op
then captures its own body, which it replays from a host loop that reads
the condition after each iteration (ops/control_flow_ops.py). The
executor keeps the loop runners by (program, op, shapes), hands the
running op their table and its graph pool through the thread's
``LoopContext`` during a cached call, and frees them in ``close()``.

**Host callbacks.** A block that holds a ``host_callback`` op
(``print``, ``py_func``), directly or in any of its ops' sub-blocks, is
not captured either: the callback must run on the host at every step, so
the block runs eagerly at every call. ``uncaptured_reason`` names the op
that keeps a block uncaptured, and ``uncaptured_steps`` counts the steps
that ran uncaptured for each reason (``StepRunner.run``).

**The capture gate** (``GATE``). A capture runs in CUDA's global
capture mode, which is what catches a stray call: any CUDA call another
thread makes while it runs (a launch on the legacy default stream, a
synchronize, an event query, a pinned or device allocation) invalidates
the capture. Several executors of one process (the replicas of a serving
fleet, each on its own loop thread) share the card, so the rule is
process-wide: a capture excludes every other CUDA call of the port's
executors. Every run, replay, eager step, deferred fetch and
synchronizing read of an executor holds the gate shared; a capture holds
it exclusively and synchronizes the device before it begins. A capture
waiting for the gate is served before new shared holders (so a busy
fleet cannot starve it), and the gate records which threads wait and
when each wait ended, which a serving engine's watchdog reads so that a
replica held back by another's capture is not declared wedged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core.interp import exec_ops, resolve_op_def
from paddle_tpu_torch.framework import Block, Program


class _GateHold(threading.local):
    def __init__(self):
        self.shared = 0      # this thread's nested shared holds
        self.exclusive = 0   # this thread's nested exclusive holds


class CaptureGate:
    """The process-wide capture gate (see the module docstring): a
    readers-writer lock whose writers are captures. Reentrant: a thread
    that holds it in either mode passes a nested ``shared()`` at once, and
    a thread that holds it shared and asks for ``exclusive()`` (an
    executor call whose runner captures) gives up its shared holds while
    it waits and takes them back after the capture."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0
        self._writer: Optional[int] = None
        self._writers_waiting = 0
        self._hold = _GateHold()
        # thread ident -> perf_counter when its current wait began / when
        # its last wait ended
        self._waiting: Dict[int, float] = {}
        self._wait_ended: Dict[int, float] = {}
        self.reset_stats()

    def reset_stats(self):
        """Zero the record ``stats`` reads."""
        with self._cond:
            self._stats = {"captures": 0, "capture_failures": 0,
                           "captures_waited": 0,
                           "longest_capture_wait_s": 0.0,
                           "held_back": 0, "longest_hold_back_s": 0.0}

    def stats(self) -> Dict[str, Any]:
        """The gate's record since the last ``reset_stats``: exclusive
        holds (captures), the captures that failed, the captures that had
        to wait and their longest wait, and the shared holds that a
        capture held back and their longest wait."""
        with self._cond:
            return dict(self._stats)

    def note_capture_failure(self):
        with self._cond:
            self._stats["capture_failures"] += 1

    def waiting(self, ident: Optional[int]) -> bool:
        """Whether the thread ``ident`` is waiting for the gate now."""
        return ident in self._waiting

    def wait_ended(self, ident: Optional[int]) -> float:
        """perf_counter time at which the thread ``ident``'s last wait for
        the gate ended (0.0 if it never waited)."""
        return self._wait_ended.get(ident, 0.0)

    def _wait_locked(self, blocked, kind):
        """Wait on the condition while ``blocked()``; record the wait."""
        if not blocked():
            return
        me = threading.get_ident()
        t0 = time.perf_counter()
        self._waiting[me] = t0
        try:
            while blocked():
                self._cond.wait()
        finally:
            del self._waiting[me]
            t1 = time.perf_counter()
            self._wait_ended[me] = t1
        if kind == "capture":
            self._stats["captures_waited"] += 1
            self._stats["longest_capture_wait_s"] = max(
                self._stats["longest_capture_wait_s"], t1 - t0)
        else:
            self._stats["held_back"] += 1
            self._stats["longest_hold_back_s"] = max(
                self._stats["longest_hold_back_s"], t1 - t0)

    def _acquire_shared(self):
        with self._cond:
            self._wait_locked(lambda: (self._writer is not None
                                       or self._writers_waiting > 0),
                              "shared")
            self._readers += 1

    def _release_shared(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    @contextlib.contextmanager
    def shared(self):
        """Hold the gate shared: a run, replay, eager step, fetch or
        synchronizing read of an executor."""
        hold = self._hold
        if hold.shared or hold.exclusive:
            hold.shared += 1
            try:
                yield
            finally:
                hold.shared -= 1
            return
        self._acquire_shared()
        hold.shared = 1
        try:
            yield
        finally:
            hold.shared = 0
            self._release_shared()

    @contextlib.contextmanager
    def exclusive(self, device: Optional[torch.device] = None):
        """Hold the gate alone (a capture): wait until no other thread
        holds it, then synchronize ``device`` (a CUDA device) before the
        caller begins."""
        hold = self._hold
        if hold.exclusive:
            hold.exclusive += 1
            try:
                yield
            finally:
                hold.exclusive -= 1
            return
        mine = hold.shared
        if mine:
            hold.shared = 0
            self._release_shared()
        me = threading.get_ident()
        with self._cond:
            self._writers_waiting += 1
            try:
                self._wait_locked(lambda: (self._writer is not None
                                           or self._readers > 0),
                                  "capture")
            finally:
                self._writers_waiting -= 1
            self._writer = me
            self._stats["captures"] += 1
        hold.exclusive = 1
        try:
            if device is not None and device.type == "cuda":
                torch.cuda.synchronize(device)
            yield
        finally:
            hold.exclusive = 0
            with self._cond:
                self._writer = None
                self._cond.notify_all()
            if mine:
                self._acquire_shared()
                hold.shared = mine


GATE = CaptureGate()


# reason (``uncaptured_reason``) -> steps a StepRunner ran uncaptured
uncaptured_steps: Counter = Counter()


def uncaptured_reason(ops, op_defs) -> Optional[str]:
    """Why a block of ``ops`` (their resolved ``op_defs``) cannot run as
    one CUDA graph, or None when it can: the first op that draws from a
    host-seeded generator, loops on the host or calls back into Python
    on the host, looked for in the ops' sub-blocks too."""
    for op, d in zip(ops, op_defs):
        for flag in ("host_rng", "host_loop", "host_callback"):
            if getattr(d, flag):
                return f"{flag} op '{op.type}'"
        for v in op.attrs.values():
            if isinstance(v, Block):
                sub = list(v.ops)
                why = uncaptured_reason(sub, [resolve_op_def(o.type)
                                              for o in sub])
                if why is not None:
                    return f"{why} in block {v.idx}"
    return None


@dataclasses.dataclass
class LoweredBlock:
    """A runnable block: ``fn(state, feeds, seed, host_seed=None) ->
    (fetches, new_state)``; ``seed`` is the run's seed buffer (a 0-d int64
    tensor holding the step seed, core/interp.py), or None when no op of
    the block is random; ``host_seed`` is the same step seed as an int,
    needed only by ``host_rng`` ops.

    ``state_in_names``: persistable vars read before being written —
    gathered from the Scope. ``state_out_names``: every state-in var plus
    every persistable var the block writes; the executor commits them
    back to the Scope. ``uncaptured`` says why the block cannot run as a
    CUDA graph (``uncaptured_reason``: an op draws from a host-seeded
    generator, loops on the host (``while``, whose body is captured on
    its own: ``LoopRunner``) or calls back into Python on the host, at
    any depth of sub-blocks), or is None when it can (``capturable``).
    """

    fn: Callable
    state_in_names: Tuple[str, ...]
    state_out_names: Tuple[str, ...]
    feed_names: Tuple[str, ...]
    fetch_names: Tuple[str, ...]
    needs_rng: bool
    uncaptured: Optional[str]

    @property
    def capturable(self) -> bool:
        return self.uncaptured is None


def analyze_state(
    block: Block, feed_names: Sequence[str]
) -> Tuple[List[str], List[str]]:
    """(state_in, state_out) persistable-var lists for the block."""
    feed = set(feed_names)
    written: set = set()
    state_in: List[str] = []
    seen_in: set = set()
    written_persistable: List[str] = []

    def is_persistable(name: str) -> bool:
        v = block._find_var_recursive(name)
        return v is not None and v.persistable

    for op in block.ops:
        for name in op.input_arg_names:
            if not name or name in feed or name in written or name in seen_in:
                continue
            if is_persistable(name):
                state_in.append(name)
                seen_in.add(name)
        for name in op.output_arg_names:
            if name and name not in written:
                written.add(name)
                if is_persistable(name):
                    written_persistable.append(name)
    state_out = list(state_in)
    out_seen = set(state_in)
    for name in written_persistable:
        if name not in out_seen:
            state_out.append(name)
            out_seen.add(name)
    return state_in, state_out


def lower_block(
    program: Program,
    block_idx: int,
    feed_names: Sequence[str],
    fetch_names: Sequence[str],
    device: torch.device,
    amp: bool = False,
) -> LoweredBlock:
    """``amp``: run the block's matmul-heavy ops in bf16 (core/interp.py
    AMP sets)."""
    block = program.blocks[block_idx]
    state_in, state_out = analyze_state(block, feed_names)
    state_out = tuple(state_out)
    fetch_names = tuple(fetch_names)
    # resolve every compute up front so unknown ops fail before running
    op_defs = [resolve_op_def(op.type) for op in block.ops]
    ops = list(block.ops)

    def run_block(state: Dict[str, Any], feeds: Dict[str, Any], seed,
                  host_seed: Optional[int] = None):
        env: Dict[str, Any] = {}
        env.update(state)
        env.update(feeds)
        exec_ops(ops, env, device=device, seed=seed, host_seed=host_seed,
                 amp=amp, op_defs=op_defs)
        fetches = [env[n] for n in fetch_names]
        return fetches, {n: env[n] for n in state_out}

    return LoweredBlock(
        fn=run_block,
        state_in_names=tuple(state_in),
        state_out_names=state_out,
        feed_names=tuple(feed_names),
        fetch_names=fetch_names,
        needs_rng=any(d.needs_rng or d.host_rng for d in op_defs),
        uncaptured=uncaptured_reason(ops, op_defs),
    )


def as_tensor(value, device: torch.device) -> torch.Tensor:
    """A feed or scope value as a tensor on ``device`` (numpy arrays are
    copied, so the caller may reuse its buffer)."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.from_numpy(np.array(value)).to(device)


def gather_state(scope, names, device: torch.device) -> Dict[str, Any]:
    """The state tensors ``names`` from ``scope``, each made resident on
    ``device`` (a numpy value is moved there once and the Scope rebound to
    the tensor)."""
    state = {}
    for n in names:
        v = scope.find_var(n)
        if v is None:
            raise RuntimeError(
                f"variable '{n}' used by the program is not initialized "
                f"in the scope — run the startup program first")
        if not (isinstance(v, torch.Tensor) and v.device == device):
            v = as_tensor(v, device)
            scope.set(n, v)  # resident on the device from now on
        state[n] = v
    return state


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def capture_graph(fn: Callable, pool, what: str, thing: str):
    """Capture ``fn()`` as a CUDA graph whose memory comes from ``pool``;
    returns (graph, what ``fn`` returned, the launches this thread's
    wrappers counted meanwhile: each replay adds them). A failure raises,
    naming ``what`` and the failing op where it is known; nothing runs
    eagerly in the ``thing``'s place."""
    graph = torch.cuda.CUDAGraph()
    failed = None
    with kernels.recording() as launched:
        try:
            with torch.cuda.graph(graph, pool=pool):
                try:
                    out = fn()
                except Exception as e:
                    failed = e
                    raise
        except Exception as e:
            GATE.note_capture_failure()
            cause = failed or e
            raise RuntimeError(
                f"{what}: capturing the {thing} as a CUDA graph failed "
                f"({_describe(cause)}); the {thing} does not run eagerly in "
                f"its place") from cause
    return graph, out, launched


def commit_in_place(bufs: Dict[str, torch.Tensor], new: Dict[str, Any],
                    names: Sequence[str], what: str, kind: str,
                    holder: str):
    """Copy each ``new[n]`` into ``bufs[n]`` in place, for ``n`` in
    ``names``. A new value must keep its buffer's shape and dtype; one
    that shares memory with another buffer is copied out first, so no
    commit reads a buffer already written."""
    owners = {_storage(b): n for n, b in bufs.items()}
    pairs = []
    for n in names:
        v, buf = new[n], bufs[n]
        if v is buf:
            continue
        if v.shape != buf.shape or v.dtype != buf.dtype:
            raise RuntimeError(
                f"{what}: {kind} '{n}' is {v.dtype} {tuple(v.shape)} after "
                f"the step, {buf.dtype} {tuple(buf.shape)} before it; "
                f"{holder} keeps each {kind} tensor's shape and dtype")
        if owners.get(_storage(v), n) != n:
            v = v.clone()
        pairs.append((buf, v))
    for buf, v in pairs:
        buf.copy_(v)


def _describe(e: BaseException) -> str:
    """An exception's type, message and notes (the failing op's)."""
    notes = "; ".join(getattr(e, "__notes__", ()))
    return f"{type(e).__name__}: {e}" + (f" [{notes}]" if notes else "")


def run_eager(lowered: LoweredBlock, scope, feeds: Dict[str, torch.Tensor],
              device: torch.device, seed: torch.Tensor,
              program_seed: Optional[int], step: int) -> List[torch.Tensor]:
    """Run the block eagerly at executor step ``step`` and commit its new
    state to ``scope`` as fresh tensors. ``seed``: the seed buffer the
    step seed is written to (``fill_``, a kernel argument: no copy)."""
    state = gather_state(scope, lowered.state_in_names, device)
    host_seed = None
    if lowered.needs_rng:
        host_seed = rng.step_seed(program_seed, step)
        seed.fill_(host_seed)
    with torch.no_grad():
        fetches, new_state = lowered.fn(state, feeds, seed, host_seed)
    for n, v in new_state.items():
        scope.set(n, v)
    return list(fetches)


class StepRunner:
    """One lowered block bound to one Scope and one feed signature, run as
    a captured CUDA graph from its second call (on the CPU: the same step
    function called directly). See the module docstring."""

    def __init__(self, lowered: LoweredBlock, device: torch.device,
                 program_seed: Optional[int], what: str, pool=None):
        self.lowered = lowered
        self.pool = pool  # the graph's memory pool, None: a private one
        self.device = device
        self.what = what
        self.calls = 0
        # the run's seed buffer and the device step counter it is derived
        # from inside the captured step; _counter_at: the step the counter
        # holds (another program's runs advance the executor's step)
        self.seed = torch.zeros((), dtype=torch.int64, device=device)
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        self._counter_at = -1
        self._program_seed = program_seed
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.feed_bufs: Dict[str, torch.Tensor] = {}
        self.state_bufs: Dict[str, torch.Tensor] = {}
        self.fetch_outs: Optional[List[torch.Tensor]] = None
        # the launches one step makes, counted on the capturing thread
        # while the step was captured (on the CPU: ran) under the gate
        self.launch_delta: Counter = Counter()
        self._bound = False

    # --- the captured step ---

    def _step_body(self) -> List[torch.Tensor]:
        """The step as captured: seed from the device counter, the block,
        the new state copied into the state buffers in place, the counter
        advanced."""
        lw = self.lowered
        if lw.needs_rng:
            self.seed.copy_(rng.mix64_tensor(self._program_seed_t,
                                             self.counter))
        with torch.no_grad():
            fetches, new_state = lw.fn(self.state_bufs, self.feed_bufs,
                                       self.seed)
            commit_in_place(self.state_bufs, new_state, lw.state_out_names,
                            self.what, "state", "a captured step")
            self.counter.add_(1)
        return list(fetches)

    def _bind(self, scope, feeds: Dict[str, torch.Tensor]):
        """Take the Scope's tensors as the state buffers, allocate the feed
        buffers and, on a CUDA device, capture the step."""
        lw = self.lowered
        names = list(dict.fromkeys(lw.state_in_names + lw.state_out_names))
        self.state_bufs = gather_state(scope, names, self.device)
        self.feed_bufs = {n: torch.empty_like(v, device=self.device)
                          for n, v in feeds.items()}
        self._program_seed_t = torch.full(
            (), rng.signed64((self._program_seed or 0) & rng.MASK64),
            dtype=torch.int64, device=self.device)
        if self.device.type != "cuda":
            self._bound = True
            return
        self.graph, self.fetch_outs, self.launch_delta = capture_graph(
            self._step_body, self.pool, self.what, "step")
        self._bound = True

    def _rebind(self, scope):
        """Copy into each state buffer a tensor the Scope holds in its
        place, once, and bind the Scope to the buffer again."""
        for n, buf in self.state_bufs.items():
            v = scope.find_var(n)
            if v is buf:
                continue
            if v is None:
                if n in self.lowered.state_in_names:
                    raise RuntimeError(
                        f"variable '{n}' used by the program is not "
                        f"initialized in the scope — run the startup "
                        f"program first")
            else:
                v = as_tensor(v, self.device)
                if v.shape != buf.shape or v.dtype != buf.dtype:
                    raise RuntimeError(
                        f"{self.what}: the scope's '{n}' is {v.dtype} "
                        f"{tuple(v.shape)}, the captured step's {buf.dtype} "
                        f"{tuple(buf.shape)}")
                buf.copy_(v)
            scope.set(n, buf)

    def _load_feeds(self, feeds):
        for n, buf in self.feed_bufs.items():
            v = feeds[n]
            if isinstance(v, torch.Tensor):
                buf.copy_(v, non_blocking=True)
                continue
            host = torch.from_numpy(np.array(v))
            if self.device.type == "cuda":
                # from pinned memory: the copy waits for nothing on the host
                buf.copy_(host.pin_memory(), non_blocking=True)
            else:
                buf.copy_(host)

    def run_captured(self, scope, feeds, step: int) -> List[torch.Tensor]:
        """One step at executor step ``step`` through the captured graph;
        returns copies of the fetches, which the next replay leaves
        alone. The first such call binds the buffers and captures the
        step (on the CPU: runs it, recording its launches as a capture
        does) holding the capture gate alone."""
        if self._bound:
            return self._replay(scope, feeds, step)
        with GATE.exclusive(self.device):
            self._bind(scope, {n: as_tensor(v, self.device)
                               for n, v in feeds.items()})
            if self.graph is not None:
                return self._replay(scope, feeds, step)
            with kernels.recording() as launched:
                out = self._replay(scope, feeds, step)
            self.launch_delta = launched
            kernels.add_counts(launched)  # the CPU ran them
            return out

    def _replay(self, scope, feeds, step: int) -> List[torch.Tensor]:
        self._rebind(scope)
        self._load_feeds(feeds)
        if self.lowered.needs_rng and self._counter_at != step:
            self.counter.fill_(step)
        if self.graph is None:
            fetches = self._step_body()
        else:
            try:
                self.graph.replay()
            except Exception as e:
                raise RuntimeError(f"{self.what}: replaying the captured "
                                   f"step failed ({_describe(e)})") from e
            kernels.add_counts(self.launch_delta)
            fetches = self.fetch_outs
        self._counter_at = step + 1
        return [t.clone() for t in fetches]

    def run(self, scope, feeds, step: int) -> List[torch.Tensor]:
        """The runner's call: eager first (the warm-up) and for a block
        that cannot be captured, captured from the second call on."""
        self.calls += 1
        if not self.lowered.capturable:
            uncaptured_steps[self.lowered.uncaptured] += 1
        if self.calls == 1 or not self.lowered.capturable:
            return run_eager(self.lowered, scope,
                             {n: as_tensor(v, self.device)
                              for n, v in feeds.items()},
                             self.device, self.seed, self._program_seed, step)
        return self.run_captured(scope, feeds, step)

    def close(self):
        """Free the graph, its share of the pool and the buffers (the Scope
        keeps its tensors)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.fetch_outs = None
        self.feed_bufs = {}
        self.state_bufs = {}
        self._bound = False


# --- host loops: a ``while`` body as a captured graph -------------------


@dataclasses.dataclass
class LoopContext:
    """What a ``while`` op (a ``host_loop`` op) takes from the cached
    executor call it runs in: the executor's loop runners (by program, op
    and shapes), its graph pool and the program's name for errors."""

    runners: Dict[tuple, "LoopRunner"]
    pool: Any
    what: str


class _LoopTLS(threading.local):
    def __init__(self):
        self.stack: List[LoopContext] = []


_loop_tls = _LoopTLS()


@contextlib.contextmanager
def loop_context(ctx: LoopContext):
    """Make ``ctx`` the calling thread's loop context for the duration of
    the block (outside one, a ``while`` op runs its loop eagerly)."""
    _loop_tls.stack.append(ctx)
    try:
        yield
    finally:
        _loop_tls.stack.pop()


def current_loop_context() -> Optional[LoopContext]:
    stack = _loop_tls.stack
    return stack[-1] if stack else None


def host_bool(t: torch.Tensor, pinned: Optional[torch.Tensor] = None) -> bool:
    """A one-element bool tensor's value on the host: the loop's one
    synchronization an iteration. On the card it is read through the
    pinned 0-d ``pinned`` where one is given."""
    if t.device.type == "cuda" and pinned is not None:
        pinned.copy_(t.reshape(()), non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return bool(pinned)
    return bool(t.reshape(()))


class LoopRunner:
    """A ``while`` op's body bound to static buffers, run as a captured
    CUDA graph replayed from a host loop (on the CPU: the body function
    called directly, with the same buffers and bookkeeping).

    Buffers: one for each carried value, the condition (a 0-d bool), each
    captured value (copied in once when a loop starts), the iteration
    counter and the loop's op seed. The body reads them and commits the
    new carries and condition into them in place at its end, as the
    compiled step commits a Scope's state (``commit_in_place``); it
    derives each iteration's seed on the device from the op seed and the
    counter (``rng.mix64_tensor``), the counterpart of the JAX package's
    ``fold_in(rng, i)``, and advances the counter. The runner's first
    iteration runs eagerly (the warm-up), its second captures the body
    holding the capture gate alone, and every later iteration, of this
    loop and of later ones, replays it; after each iteration the host
    reads the condition through a pinned copy. Each replay adds the
    capture's launch counts, as a step replay does. A capture or replay
    that fails raises, naming the program and the op."""

    def __init__(self, ops, op_defs, carry_names: Sequence[str],
                 cond_name: str, cap_names: Sequence[str],
                 device: torch.device, amp: bool, what: str, pool=None):
        self.ops, self.op_defs = list(ops), list(op_defs)
        self.carry_names = list(carry_names)
        self.cond_name = cond_name
        self.cap_names = list(cap_names)
        self.device, self.amp, self.what, self.pool = device, amp, what, pool
        self.needs_rng = any(d.needs_rng for d in op_defs)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.bufs: Dict[str, torch.Tensor] = {}
        self.cap_bufs: List[torch.Tensor] = []
        self.launch_delta: Counter = Counter()
        self.warm = False      # an iteration has run (the warm-up)
        self.captured = False  # the body is captured (on the CPU: the
        #                        iteration that stands for the capture ran)
        self.loops = 0
        self.iterations = 0

    def _alloc(self, carries, caps):
        dev = self.device
        self.bufs = {n: torch.empty_like(v, device=dev)
                     for n, v in zip(self.carry_names, carries)}
        self.bufs[self.cond_name] = torch.empty((), dtype=torch.bool,
                                                device=dev)
        self.cap_bufs = [torch.empty_like(v, device=dev) for v in caps]
        self.counter = torch.zeros((), dtype=torch.int64, device=dev)
        self.op_seed = torch.zeros((), dtype=torch.int64, device=dev)
        self.seed = torch.zeros((), dtype=torch.int64, device=dev)
        self.pinned = (torch.empty((), dtype=torch.bool, pin_memory=True)
                       if dev.type == "cuda" else None)

    def _body(self):
        """One iteration on the buffers, its commit included."""
        if self.needs_rng:
            self.seed.copy_(rng.mix64_tensor(self.op_seed, self.counter))
        env: Dict[str, Any] = dict(zip(self.cap_names, self.cap_bufs))
        env.update(self.bufs)
        with torch.no_grad():
            exec_ops(self.ops, env, device=self.device, seed=self.seed,
                     amp=self.amp, op_defs=self.op_defs)
            env[self.cond_name] = env[self.cond_name].reshape(()).to(
                torch.bool)
            commit_in_place(self.bufs, env, list(self.bufs), self.what,
                            "loop-carried value", "a while loop")
            self.counter.add_(1)

    def _capture(self):
        """Capture the body (on the CPU: run it, recording its launches
        as a capture does) holding the gate alone."""
        with GATE.exclusive(self.device):
            if self.device.type != "cuda":
                with kernels.recording() as launched:
                    self._body()
                self.launch_delta = launched
                kernels.add_counts(launched)  # the CPU ran them
                self.captured = True
                return
            self.graph, _, self.launch_delta = capture_graph(
                self._body, self.pool, self.what, "loop body")
            self.captured = True
        self._replay()

    def _replay(self):
        if self.graph is None:
            self._body()
            return
        try:
            self.graph.replay()
        except Exception as e:
            raise RuntimeError(f"{self.what}: replaying the captured loop "
                               f"body failed ({_describe(e)})") from e
        kernels.add_counts(self.launch_delta)

    def run(self, cond0: torch.Tensor, carries: Sequence[torch.Tensor],
            caps: Sequence[torch.Tensor], op_seed: Optional[torch.Tensor]):
        """Run the loop from ``cond0`` and the initial carries; returns
        (final carries, final condition, iterations as an int32 0-d
        tensor), each a tensor of its own. The runner's buffers have the
        shapes and dtypes of its first call's values, as the executor's
        key for it says."""
        if not self.bufs:
            self._alloc(carries, caps)
        self.bufs[self.cond_name].copy_(cond0.reshape(()))
        for n, v in zip(self.carry_names, carries):
            self.bufs[n].copy_(v)
        for buf, v in zip(self.cap_bufs, caps):
            buf.copy_(v)
        self.counter.zero_()
        if op_seed is not None:
            self.op_seed.copy_(op_seed)
        self.loops += 1
        cond = self.bufs[self.cond_name]
        while host_bool(cond, self.pinned):
            if self.captured:
                self._replay()
            elif self.warm:
                self._capture()
            else:
                self._body()
                self.warm = True
            self.iterations += 1
        return ([self.bufs[n].clone() for n in self.carry_names],
                cond.clone(), self.counter.to(torch.int32))

    def close(self):
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.bufs, self.cap_bufs = {}, []
        self.warm = self.captured = False
