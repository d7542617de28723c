"""Inference serving: continuous batching over an on-device KV cache.

The port of the JAX package's ``serving.ServingEngine``:

- **Continuous batch assembly**: a bounded request queue feeds a fixed
  set of batch *slots*. Requests are admitted and evicted at token
  boundaries; one decode program serves every mix of in-flight requests.
- **Prefill/decode split** (models/transformer.py ``build_prefill`` /
  ``build_decode_step``): admission runs the encoder once and writes the
  request's cross-attention K/V into slot-indexed device-resident cache
  tensors; each decode step appends one self-attention K/V row per slot
  and emits one greedy token per slot.
- **Deferred fetch**: a decode step's fetches come back as
  ``executor.LazyFetches`` (``Executor.run(async_fetch=True)``): their
  copies to the host are queued with the step, and the host reads step
  N's tokens at the start of the next scheduler tick.
- **Backpressure and deadlines**: ``submit`` raises ``QueueFull`` past
  ``queue_depth``; a request past its deadline is evicted at the next
  token boundary (outcome ``expired``), and deadline-aware admission
  control refuses a request whose first token provably cannot land in
  time (``DeadlineUnmeetable``).
- **Poisoned-slot containment**: a slot whose logits go non-finite is
  evicted (outcome ``error``) and its device rows are scrubbed
  (``build_slot_scrub``) while healthy slots keep decoding. Any other
  decode failure fails the engine (``EngineFailed``).

The supervised restart, brownout, and the faults, monitor, numerics and
request-trace planes of the JAX package are not part of this port yet.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch import io as _io
from paddle_tpu_torch.executor import Executor, Scope, scope_guard


class QueueFull(RuntimeError):
    """submit() backpressure: the request queue is at ``queue_depth``."""


class EngineClosed(RuntimeError):
    """submit()/step() on a closed or draining engine."""


class EngineFailed(RuntimeError):
    """The engine hit a decode/fetch failure it cannot attribute to a
    slot: device state can no longer be trusted. ``submit()``/``step()``
    raise this until close()."""


class DeadlineUnmeetable(RuntimeError):
    """Deadline-aware admission control refused the request at submit:
    measured per-token latency x estimated queue position says even the
    first token cannot land before the deadline. The handle is finished
    with outcome ``rejected_early`` and never queued."""

    def __init__(self, message: str, request=None,
                 estimate_s: Optional[float] = None):
        super().__init__(message)
        self.request = request
        self.estimate_s = estimate_s


class ServeRequest:
    """One generation request (handle returned by submit). ``outcome``
    is None while in flight, then one of completed, length, expired,
    rejected, rejected_early, drained or error."""

    # itertools.count: atomic under CPython — submit() is meant for
    # concurrent callers and ids must stay unique across threads
    _uid = itertools.count(1)

    def __init__(self, src_ids, src_pad, max_new_tokens, deadline_s):
        self.id = next(ServeRequest._uid)
        self.src_ids = src_ids
        self.src_pad = src_pad
        self.max_new_tokens = max_new_tokens
        self.submit_ts = time.perf_counter()
        self.deadline_ts = (self.submit_ts + deadline_s
                            if deadline_s else None)
        self.tokens: List[int] = []  # emitted tokens, EOS excluded
        self.outcome: Optional[str] = None

    def _finish(self, outcome: str):
        self.outcome = outcome


def _load_weights_into(scope: Scope, weights, exe: Executor) -> bool:
    """Install model weights into the engine's Scope from a Scope (its
    tensors shared, not copied: no op writes a weight), a Predictor (its
    Scope), or a saved inference-model directory (the fp32 export or the
    int8 artifact, read as tensors on ``exe``'s device). Returns True
    when the int8 artifact was loaded."""
    from paddle_tpu_torch import inference as _inference
    from paddle_tpu_torch.slim import calibration

    if isinstance(weights, _inference.Predictor):
        weights = weights.scope
    if isinstance(weights, Scope):
        for name in weights.var_names():
            scope.set(name, weights.find_var(name))
        return False
    if isinstance(weights, str):
        if os.path.exists(os.path.join(weights,
                                       calibration.INT8_PARAMS_FILE)):
            calibration.load_int8_inference_model(weights, exe, scope=scope)
            return True
        with np.load(os.path.join(weights, _io.PARAMS_FILE)) as data:
            for name in data.files:
                scope.set(name, _io._to_tensor(data[name], exe.device))
        return False
    raise TypeError(
        f"weights must be a Scope, Predictor or model dir, got "
        f"{type(weights).__name__}")


class _Slot:
    """Host-side view of one batch slot."""

    __slots__ = ("request",)

    def __init__(self):
        self.request: Optional[ServeRequest] = None


class ServingEngine:
    """Continuous-batching serving engine over the transformer.

    One engine = one model + one batch geometry: ``slots`` concurrent
    requests, sources padded to ``src_len``, at most ``max_len - 1``
    generated tokens per request. ``submit()`` enqueues; the caller
    drives ``step()`` — or ``run_until_idle()`` — to make progress;
    ``drain()`` stops admissions and finishes the in-flight set;
    ``close()`` drains and releases the device state. ``weights`` is a
    Scope (``io.scope_from_numpy`` / ``io.scope_from_params_file`` carry
    the JAX package's weights into one; its tensors are shared, not
    copied, as no op updates a weight in place), a ``Predictor`` (its
    Scope), or a directory that either package's
    ``save_inference_model`` (fp32) or ``save_int8_inference_model``
    (int8: the weights dequantized on the host, ``engine.int8`` True)
    wrote. ``place`` defaults to
    ``CUDAPlace(0)`` (raising without CUDA); pass ``CPUPlace()`` for the
    CPU. ``queue_depth``, ``deadline_ms`` and ``admission_control``
    default to the JAX package's ``serve_queue_depth`` (64),
    ``serve_deadline_ms`` (0 = none) and ``serve_admission_control``
    (True) flags.
    """

    _eid = itertools.count(1)

    def __init__(self, cfg, weights, *, slots: int = 4, src_len: int = 32,
                 max_len: int = 32, bos_id: int = 0, end_id: int = 1,
                 place=None, queue_depth: int = 64, deadline_ms: float = 0,
                 admission_control: bool = True):
        from paddle_tpu_torch.models import transformer as _T

        if slots < 1:
            raise ValueError("need at least one batch slot")
        self.cfg = cfg
        self.slots = int(slots)
        self.src_len, self.max_len = int(src_len), int(max_len)
        self.bos_id, self.end_id = int(bos_id), int(end_id)
        self.queue_depth = int(queue_depth)
        self.deadline_s = float(deadline_ms) / 1e3 if deadline_ms else 0.0
        self.admission_control = bool(admission_control)
        self._exe = Executor(place)
        self._progs = _T.build_serving(cfg, self.slots, self.src_len,
                                       self.max_len, bos_id=self.bos_id,
                                       end_id=self.end_id)
        self.scope = Scope()
        self.int8 = _load_weights_into(self.scope, weights, self._exe)
        # device-resident serving state, zero-initialized (live=False
        # everywhere: every slot starts free)
        for name, (shape, dtype) in self._progs["state_specs"].items():
            self.scope.set(name, np.zeros(shape, dtype=np.dtype(dtype)))
        self._queue: "collections.deque[ServeRequest]" = collections.deque()
        self._slots = [_Slot() for _ in range(self.slots)]
        # (device fetches, per-slot request snapshot, dispatch time)
        self._pending = None
        self._lock = threading.Lock()
        self._draining = False
        self._closed = False
        self._failed = False
        self.last_error: Optional[str] = None
        # measured per-token latency (EWMA of decode-step wall time) for
        # admission control; the first step is excluded
        self._token_ewma_s: Optional[float] = None
        self._ewma_skipped_first = False
        self._step_walls: "collections.deque[float]" = collections.deque(
            maxlen=256)
        self.decode_steps = 0
        self.tokens_emitted = 0
        self.completed = 0
        self.engine_id = next(ServingEngine._eid)

    # --- request intake ---

    def submit(self, src_ids: Sequence[int],
               src_pad: Optional[Sequence[float]] = None,
               max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> ServeRequest:
        """Enqueue a generation request. ``src_ids`` shorter than the
        engine's ``src_len`` is padded (mask derived); longer raises.
        Raises QueueFull beyond ``queue_depth`` and DeadlineUnmeetable
        (outcome ``rejected_early``) for a deadline the measured
        per-token latency says cannot be met."""
        ids = np.asarray(src_ids, np.int64).reshape(-1)
        if ids.shape[0] > self.src_len:
            raise ValueError(
                f"source length {ids.shape[0]} exceeds the engine's "
                f"src_len {self.src_len}")
        if src_pad is None:
            pad = (np.arange(self.src_len) < ids.shape[0]).astype(
                np.float32)
        else:
            mask = np.asarray(src_pad, np.float32).reshape(-1)
            if mask.shape[0] == self.src_len:
                pad = mask
            elif mask.shape[0] == ids.shape[0]:
                pad = np.zeros(self.src_len, np.float32)
                pad[:ids.shape[0]] = mask
            else:
                raise ValueError(
                    f"src_pad length {mask.shape[0]} matches neither "
                    f"the source length {ids.shape[0]} nor the "
                    f"engine's src_len {self.src_len}")
        full = np.zeros(self.src_len, np.int64)
        full[:ids.shape[0]] = ids
        cap = self.max_len - 1
        if max_new_tokens is not None and int(max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        want = cap if max_new_tokens is None else min(int(max_new_tokens),
                                                     cap)
        deadline_s = (self.deadline_s if deadline_ms is None
                      else float(deadline_ms) / 1e3)
        req = ServeRequest(full, pad, want, deadline_s)
        with self._lock:
            if self._closed:
                raise EngineClosed("submit() on a closed engine")
            if self._failed:
                raise EngineFailed(
                    f"submit() on a failed engine ({self.last_error})")
            if self._draining:
                raise EngineClosed("submit() on a draining engine")
            if len(self._queue) >= self.queue_depth:
                req._finish("rejected")
                raise QueueFull(
                    f"serving queue at capacity ({self.queue_depth})")
            if (req.deadline_ts is not None
                    and self._token_ewma_s is not None
                    and self.admission_control):
                eta_s = self._estimate_first_token_s()
                if req.submit_ts + eta_s > req.deadline_ts:
                    req._finish("rejected_early")
                    raise DeadlineUnmeetable(
                        f"deadline unmeetable: first token estimated "
                        f"in {eta_s * 1e3:.1f} ms (measured "
                        f"{self._token_ewma_s * 1e3:.2f} ms/token x "
                        f"queue position) vs a "
                        f"{(req.deadline_ts - req.submit_ts) * 1e3:.1f}"
                        f" ms deadline", request=req, estimate_s=eta_s)
            self._queue.append(req)
        return req

    def _estimate_first_token_s(self) -> float:
        """Delay until a request submitted now sees its first token:
        tokens owed ahead of it (queue + in-flight), drained ``slots`` at
        a time, at the measured per-token EWMA. Caller holds the lock."""
        backlog = sum(r.max_new_tokens for r in self._queue)
        for s in self._slots:
            r = s.request
            if r is not None and r.outcome is None:
                backlog += max(0, r.max_new_tokens - len(r.tokens))
        return self._token_ewma_s * (backlog / float(self.slots) + 1.0)

    # --- the scheduler tick ---

    def step(self) -> int:
        """One scheduler tick: resolve the previously dispatched decode
        step (handing tokens to their requests and freeing finished
        slots), admit queued requests into free slots (prefill), and
        dispatch the next single-token decode step. Returns the number
        of tokens handed out this tick."""
        if self._closed:
            raise EngineClosed("step() on a closed engine")
        if self._failed:
            raise EngineFailed(
                f"step() on a failed engine ({self.last_error})")
        emitted = self._process_ready()
        self._admit()
        self._dispatch()
        return emitted

    def run_until_idle(self, max_steps: int = 100_000) -> int:
        """Drive step() until no request is queued or in flight; returns
        total tokens emitted. ``max_steps`` bounds a runaway loop."""
        total = 0
        for _ in range(max_steps):
            total += self.step()
            if not self.busy():
                break
        total += self._process_ready()
        return total

    def busy(self) -> bool:
        with self._lock:
            queued = bool(self._queue)
        return (queued or self._pending is not None
                or any(s.request is not None for s in self._slots))

    def request_drain(self) -> bool:
        """Stop admissions and finish every queued-but-unadmitted request
        with outcome 'drained'; the in-flight set keeps decoding. Returns
        False when the engine is already closed."""
        with self._lock:
            if self._closed:
                return False
            self._draining = True
            while self._queue:
                self._queue.popleft()._finish("drained")
        return True

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful drain: stop admissions, finish the in-flight set.
        Returns True when everything settled inside ``timeout_s``."""
        if not self.request_drain():
            return True
        if self._failed:
            return not self.busy()
        t0 = time.perf_counter()
        while self.busy():
            try:
                self.step()
            except (EngineClosed, EngineFailed):
                return False
            if time.perf_counter() - t0 > timeout_s:
                return False
        return True

    def close(self, drain_timeout_s: float = 30.0):
        """Drain, then release the device-resident state. Every handle
        still in flight is finished ('drained', or 'error' when the engine
        failed), so no handle is left without an outcome."""
        if self._closed:
            return
        if not self._failed:
            self.drain(drain_timeout_s)
        with self._lock:
            self._closed = True
            self._pending = None
            leftovers = []
            for s in self._slots:
                req, s.request = s.request, None
                if req is not None and req.outcome is None:
                    leftovers.append(req)
            while self._queue:
                r = self._queue.popleft()
                if r.outcome is None:
                    leftovers.append(r)
        outcome = "error" if self._failed else "drained"
        for req in leftovers:
            req._finish(outcome)
        self._exe.close()
        self.scope.clear()

    # --- internals ---

    def _active_mask(self) -> np.ndarray:
        return np.asarray(
            [s.request is not None and s.request.outcome is None
             for s in self._slots], bool)

    def _admit(self):
        """Admissions at the token boundary: free slot x queued request
        -> prefill. The prefill runs after the already dispatched decode
        step, so the newcomer joins at the next one."""
        while True:
            free = next((i for i, s in enumerate(self._slots)
                         if s.request is None), None)
            if free is None:
                return
            with self._lock:
                if self._failed or not self._queue:
                    return
                req = self._queue.popleft()
            now = time.perf_counter()
            if req.deadline_ts is not None and now > req.deadline_ts:
                req._finish("expired")
                continue
            pre = self._progs["prefill"]
            try:
                with scope_guard(self.scope):
                    self._exe.run(
                        self._progs["prefill_program"],
                        feed={
                            pre["feeds"][0].name: req.src_ids[None, :],
                            pre["feeds"][1].name: req.src_pad[None, :],
                            pre["feeds"][2].name:
                                np.asarray([free], np.int64),
                        },
                        fetch_list=[])
            except Exception:
                # the request is off the queue and owns no slot: finish
                # the handle before propagating
                req._finish("error")
                raise
            self._slots[free].request = req

    def _dispatch(self):
        """Queue one single-token decode step for the active set (a no-op
        tick when every slot is free)."""
        if self._pending is not None:
            return
        mask = self._active_mask()
        if not mask.any():
            return
        dec = self._progs["decode"]
        t0 = time.perf_counter()
        try:
            with scope_guard(self.scope):
                fetches = self._exe.run(
                    self._progs["decode_program"],
                    feed={dec["feeds"][0].name: mask},
                    fetch_list=[dec["emit"], dec["live"], dec["pos"],
                                dec["maxabs"]],
                    async_fetch=True)
        except Exception as e:
            self._fail(e)
            raise
        snapshot = [s.request if m else None
                    for s, m in zip(self._slots, mask)]
        self._pending = (fetches, snapshot, t0)
        self.decode_steps += 1

    def _fail(self, exc):
        if self._failed:
            return
        self._failed = True
        self.last_error = f"{type(exc).__name__}: {exc}"[:500]

    def _scrub_slot_state(self, i: int):
        """Zero slot ``i``'s row in every device-resident serving tensor:
        a poisoned occupant's non-finite K/V rows would re-poison the next
        occupant through the softmax (0 * NaN = NaN)."""
        scr = self._progs["scrub"]
        with scope_guard(self.scope):
            self._exe.run(
                self._progs["scrub_program"],
                feed={scr["feeds"][0].name: np.asarray([i], np.int64)},
                fetch_list=[])

    def _process_ready(self) -> int:
        """Read the pending decode step's fetches and hand each slot's
        token to its request; finish EOS / length / expired / poisoned
        requests (their slots free for the next admission round)."""
        with self._lock:
            if self._failed or self._closed or self._pending is None:
                self._pending = None
                return 0
            fetches, snapshot, t0 = self._pending
            self._pending = None
        try:
            emit, live, pos, maxabs = [np.asarray(a) for a in fetches]
        except Exception as e:
            self._fail(e)
            raise
        to_scrub = []
        with self._lock:
            now = time.perf_counter()
            step_s = now - t0
            if not self._ewma_skipped_first:
                self._ewma_skipped_first = True
            else:
                self._step_walls.append(step_s)
                self._token_ewma_s = (step_s if self._token_ewma_s is None
                                      else 0.8 * self._token_ewma_s
                                      + 0.2 * step_s)
            emitted = 0
            for i, req in enumerate(snapshot):
                if req is None or req.outcome is not None:
                    continue
                if not np.isfinite(maxabs[i]):
                    # poisoned slot: evict it, scrub its rows (below),
                    # healthy slots keep decoding
                    self._finish_slot(i, req, "error")
                    to_scrub.append(i)
                    continue
                tok = int(emit[i])
                alive = bool(live[i])
                if not alive and tok == self.end_id:
                    self._finish_slot(i, req, "completed")
                    continue
                req.tokens.append(tok)
                emitted += 1
                self.tokens_emitted += 1
                if not alive or len(req.tokens) >= req.max_new_tokens:
                    self._finish_slot(i, req, "length")
                elif (req.deadline_ts is not None
                        and now > req.deadline_ts):
                    self._finish_slot(i, req, "expired")
        for i in to_scrub:
            try:
                self._scrub_slot_state(i)
            except Exception as e:
                self._fail(e)
                raise
        return emitted

    def _finish_slot(self, i: int, req: ServeRequest, outcome: str):
        req._finish(outcome)
        self.completed += 1
        self._slots[i].request = None

    @property
    def state(self) -> str:
        return ("closed" if self._closed
                else "failed" if self._failed
                else "draining" if self._draining else "serving")

    def stats(self) -> Dict:
        """One JSON-able row describing the engine."""
        with self._lock:
            queued = len(self._queue)
        return {
            "engine_id": self.engine_id,
            "state": self.state,
            "device": str(self._exe.device),
            "slots": self.slots,
            "slots_active": int(self._active_mask().sum()),
            "queue_depth": queued,
            "queue_capacity": self.queue_depth,
            "src_len": self.src_len,
            "max_len": self.max_len,
            "decode_steps": self.decode_steps,
            "tokens_emitted": self.tokens_emitted,
            "requests_completed": self.completed,
            "draining": self._draining,
            "last_error": self.last_error,
            "token_ewma_ms": (None if self._token_ewma_s is None
                              else round(self._token_ewma_s * 1e3, 3)),
            "step_wall_ms_p99": (
                None if not self._step_walls
                else round(float(np.percentile(
                    list(self._step_walls), 99)) * 1e3, 3)),
            "int8": self.int8,
        }
