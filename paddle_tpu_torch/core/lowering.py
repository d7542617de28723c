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
counters what they counted while the step was captured (kernels.py), so
the counts keep meaning launches the device ran. On the CPU the same
runner calls the step function directly instead of a graph, with the same
buffers and seeds: the CPU tests reach its bookkeeping that way. A
capture or replay that fails raises, naming the program and, where the
failing op is known, the op; nothing gives way to an eager run.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core.interp import exec_ops, resolve_op_def
from paddle_tpu_torch.framework import Block, Program


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
    back to the Scope. ``capturable``: no op draws from a host-seeded
    generator, so the block may run as a CUDA graph.
    """

    fn: Callable
    state_in_names: Tuple[str, ...]
    state_out_names: Tuple[str, ...]
    feed_names: Tuple[str, ...]
    fetch_names: Tuple[str, ...]
    needs_rng: bool
    capturable: bool


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
        capturable=not any(d.host_rng for d in op_defs),
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
        # what the launch counters added while the step was captured
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
            # a new value that shares memory with another state buffer is
            # copied out first, so no commit reads a buffer already written
            owners = {_storage(b): n for n, b in self.state_bufs.items()}
            pairs = []
            for n in lw.state_out_names:
                v, buf = new_state[n], self.state_bufs[n]
                if v is buf:
                    continue
                if v.shape != buf.shape or v.dtype != buf.dtype:
                    raise RuntimeError(
                        f"{self.what}: state '{n}' is {v.dtype} "
                        f"{tuple(v.shape)} after the step, {buf.dtype} "
                        f"{tuple(buf.shape)} before it; a captured step "
                        f"keeps each state tensor's shape and dtype")
                if owners.get(_storage(v), n) != n:
                    v = v.clone()
                pairs.append((buf, v))
            for buf, v in pairs:
                buf.copy_(v)
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
        before = Counter(kernels.launch_counts)
        graph = torch.cuda.CUDAGraph()
        failed = None
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                try:
                    self.fetch_outs = self._step_body()
                except Exception as e:
                    failed = e
                    raise
        except Exception as e:
            cause = failed or e
            raise RuntimeError(
                f"{self.what}: capturing the step as a CUDA graph failed "
                f"({_describe(cause)}); the step does not run eagerly in "
                f"its place") from cause
        finally:
            # the capture launched nothing: take back what it counted, and
            # add it again at every replay
            self.launch_delta = kernels.launch_counts - before
            kernels.launch_counts.subtract(self.launch_delta)
        self.graph = graph
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
        """One step at executor step ``step`` through the captured graph
        (capturing it first when this is the first such call); returns
        copies of the fetches, which the next replay leaves alone."""
        if not self._bound:
            self._bind(scope, {n: as_tensor(v, self.device)
                               for n, v in feeds.items()})
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
            kernels.launch_counts.update(self.launch_delta)
            fetches = self.fetch_outs
        self._counter_at = step + 1
        return [t.clone() for t in fetches]

    def run(self, scope, feeds, step: int) -> List[torch.Tensor]:
        """The runner's call: eager first (the warm-up) and for a block
        that cannot be captured, captured from the second call on."""
        self.calls += 1
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
