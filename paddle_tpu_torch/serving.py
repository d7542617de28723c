"""Inference serving plane: continuous batching over an on-device KV
cache, with fault containment and supervised self-healing.

The port of the JAX package's ``serving`` module, on the card:

- **Continuous batch assembly**: a bounded request queue feeds a fixed
  set of batch *slots*. Requests are admitted and evicted at token
  boundaries; one decode program (one captured CUDA graph) serves every
  mix of in-flight requests.
- **Prefill/decode split** (models/transformer.py ``build_prefill`` /
  ``build_decode_step``): admission runs the encoder once and writes the
  request's cross-attention K/V into slot-indexed device-resident cache
  tensors; each decode step appends one self-attention K/V row per slot
  and emits one greedy token per slot.
- **Deferred fetch**: a decode step's fetches come back as
  ``executor.LazyFetches`` (``Executor.run(async_fetch=True)``): their
  copies to the host are queued with the step, and the host reads step
  N's tokens at the start of the next scheduler tick.
- **SLO plane**: ``pt_serve_*`` metrics (queue depth, tokens/s, TTFT and
  per-token latency histograms) ride the monitor registry; the live
  endpoint serves an engine summary at ``/serve``; fault plans can arm
  the ``serve.enqueue`` / ``serve.prefill`` / ``serve.decode`` /
  ``serve.fetch`` sites.
- **Request-scoped tracing** (serving_trace.py): every request carries a
  trace id and measured per-phase latencies (queue wait / prefill /
  decode / fetch), its whole life lands on one Chrome-trace track, the
  terminal breakdown is served at ``/requests``, and the ``pt_slo_*``
  counters score it against the ``serve_slo_*`` flag targets.

Resilience:

- **Decode fault containment**: a decode/fetch failure that names its
  poisoned slot(s) (``slot=N`` in the error text: the fault plan's
  ``raise(slot=N)`` protocol) evicts only those slots (outcome
  ``evicted``, partial output kept), the slots' device rows are
  scrubbed, and every healthy slot keeps decoding byte-identically.
  Non-finite logits are caught per slot by the decode program's
  max-|logit| probe and contained the same way (outcome ``error``,
  reported through ``numerics.note_nonfinite``). An unattributable
  failure (no slot hint, or a device OOM, which also runs OOM forensics
  with ``phase="serve"``) fails the engine.
- **Supervised warm restart**: ``EngineSupervisor`` owns the engine, a
  decode-loop thread and a watchdog riding the engine's heartbeat. A
  crashed or wedged engine is torn down and rebuilt under a retry.py
  budget, and every queued and in-flight request is re-prefilled on the
  new engine; greedy decode is deterministic, so the replays return
  byte-identical tokens.
- **Overload protection**: deadline-aware admission control refuses a
  request at submit (outcome ``rejected_early``) when the measured
  per-token latency says even its first token cannot land in time, and
  brownout (``serve_brownout_*`` flags) caps admissions'
  ``max_new_tokens`` under sustained queue saturation.

Where the card differs from the TPU (each held by a test):

- **The capture step is not a wedge.** The port lowers a program on its
  first call and captures its CUDA graph on the second; the watchdog
  arms only after the decode program's graph has been captured, and
  never during a call that lowers or captures (the JAX watchdog arms
  after the first decode step, which carries XLA's compile).
- **A capture excludes every other CUDA call of the process.** A capture
  runs in CUDA's global capture mode, where a CUDA call from another
  thread invalidates it, and several engines (a fleet's replicas) share
  the card: every executor call holds the process-wide capture gate
  (core/lowering.py ``GATE``) shared and a capture holds it alone.
  ``submit``, the watchdog and the monitor routes read host state only
  (``device_memory`` reads the allocator's host-side statistics). An
  engine whose loop thread waits for the gate is not wedge-armed, and
  its heartbeat counts from the end of the wait: a replica held back by
  another's capture is never declared wedged.
- **A woken wedged thread does no harm.** Every executor call of an
  engine runs under its dispatch lock and re-checks ``_closed`` there,
  after the fault site; a closed engine retires its executor, which
  then refuses to run. A thread a fault plan parked wakes after the
  restart, finds its engine closed, and returns without a CUDA call.
- **A sticky CUDA error** (an illegal address) poisons the process's
  CUDA context: the rebuild in the same process then fails under the
  retry budget and the pending requests finish ``error``, as the JAX
  supervisor does when its rebuild fails.

Deployable artifacts: an engine loads weights from a live Scope, a
Predictor, or a saved inference-model directory, including the int8
artifact (``slim/calibration.py``), whose weights deploy dequantized.
"""

from __future__ import annotations

import collections
import itertools
import os
import re
import threading
import time
import warnings
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch import faults as _faults
from paddle_tpu_torch import flags as _flags
from paddle_tpu_torch import io as _io
from paddle_tpu_torch import monitor as _monitor
from paddle_tpu_torch import numerics as _numerics
from paddle_tpu_torch import retry as _retry
from paddle_tpu_torch import serving_trace as _strace
from paddle_tpu_torch.core.lowering import GATE as _GATE
from paddle_tpu_torch.executor import Executor, Scope, scope_guard

# --- telemetry (no-ops while the 'telemetry' flag is off) ---

_M_REQUESTS = _monitor.counter(
    "pt_serve_requests_total",
    "serving requests by terminal outcome (completed / length / "
    "expired / rejected / rejected_early / drained / error / evicted)")
_M_QUEUE_DEPTH = _monitor.gauge(
    "pt_serve_queue_depth", "requests waiting for a batch slot")
_M_SLOTS_ACTIVE = _monitor.gauge(
    "pt_serve_slots_active", "batch slots holding an in-flight request")
_M_PREFILLS = _monitor.counter(
    "pt_serve_prefill_total", "admissions (prefill program runs)")
_M_DECODE_STEPS = _monitor.counter(
    "pt_serve_decode_steps_total",
    "single-token decode steps (each serves every active slot)")
_M_TOKENS = _monitor.counter(
    "pt_serve_tokens_total", "tokens emitted across all requests")
_M_TOKEN_SECONDS = _monitor.histogram(
    "pt_serve_token_seconds",
    "per-token latency (decode-step dispatch -> token on host)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5))
_M_TTFT_SECONDS = _monitor.histogram(
    "pt_serve_ttft_seconds",
    "time to first token (request submit -> first token on host)",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             30.0))
_M_ENGINE_STATE = _monitor.gauge(
    "pt_serve_engine_state",
    "per-engine lifecycle state by engine id: 0=serving, 1=draining, "
    "2=closed, 3=failed — a replica being rotated out (or killed by a "
    "decode fault) is observable BEFORE its queue is torn down; closed "
    "rows age out after ENGINE_STATE_TTL_S")
_M_SLOT_EVICTIONS = _monitor.counter(
    "pt_serve_slot_evictions_total",
    "poisoned batch slots evicted by decode fault containment, by "
    "cause (fault = slot-hinted decode/fetch error, nonfinite = "
    "non-finite logits caught by the per-slot probe); the request "
    "keeps its partial output and every healthy slot keeps decoding")
_M_RESTARTS = _monitor.counter(
    "pt_serve_engine_restarts_total",
    "supervised warm engine restarts (crashed or wedged decode loop "
    "torn down and rebuilt through the persistent compile cache)")
_M_REPLAYED = _monitor.counter(
    "pt_serve_requests_replayed_total",
    "queued + in-flight requests re-prefilled onto the restarted "
    "engine after a supervised restart (greedy decode is "
    "deterministic: a replay returns byte-identical tokens)")
_M_BROWNOUT = _monitor.gauge(
    "pt_serve_brownout_engines",
    "engines currently in brownout (sustained queue saturation: "
    "admissions' max_new_tokens capped by "
    "serve_brownout_max_new_tokens)")
_M_BROWNOUT_CAPPED = _monitor.counter(
    "pt_serve_brownout_capped_total",
    "admissions whose max_new_tokens was cut by an engaged brownout")

ENGINE_STATES = ("serving", "draining", "closed", "failed")
# Terminal 'closed' rows age out of the /healthz payload and the gauge
# after this many seconds (a rotated replica's state is liveness
# information for a while, not forever). Tests may override.
ENGINE_STATE_TTL_S = 300.0
# engine id -> (lifecycle state, transition ts), bounded (closed engines
# age out so the /healthz payload and the gauge's label set stay small).
# Mutated by engine threads and iterated by the monitor server's handler
# threads: every access holds _ENGINE_STATE_LOCK.
_ENGINE_STATE_CAP = 32
_ENGINE_STATE_LOCK = threading.Lock()
_ENGINE_STATES: "collections.OrderedDict[int, tuple]" = \
    collections.OrderedDict()


def _sweep_engine_states_locked():
    """Drop terminal 'closed' rows older than ENGINE_STATE_TTL_S.
    Caller holds _ENGINE_STATE_LOCK; returns True when rows dropped."""
    now = time.monotonic()
    stale = [k for k, (state, ts) in _ENGINE_STATES.items()
             if state == "closed" and now - ts > ENGINE_STATE_TTL_S]
    for k in stale:
        del _ENGINE_STATES[k]
    return bool(stale)


def _publish_engine_states(snapshot):
    # the gauge mirrors the bounded map wholesale (Gauge.replace, its
    # own atomic swap): engines aged/evicted out of the map drop their
    # cells too, so a process churning many short-lived engines never
    # accretes stale labels
    _M_ENGINE_STATE.replace(
        [({"engine": str(k)}, float(ENGINE_STATES.index(state)))
         for k, (state, _ts) in snapshot])


def _note_engine_state(engine_id: int, state: str):
    with _ENGINE_STATE_LOCK:
        _ENGINE_STATES[engine_id] = (state, time.monotonic())
        _ENGINE_STATES.move_to_end(engine_id)
        _sweep_engine_states_locked()
        while len(_ENGINE_STATES) > _ENGINE_STATE_CAP:
            _ENGINE_STATES.popitem(last=False)
        # publish INSIDE the lock: a concurrent publisher holding a
        # stale snapshot could otherwise overwrite a newer transition
        # (lock order is always state lock -> monitor registry lock)
        _publish_engine_states(list(_ENGINE_STATES.items()))


def engine_states() -> Dict[str, str]:
    """{engine id -> "serving" | "draining" | "closed" | "failed"} for
    the /healthz monitor route: a serving replica's lifecycle is
    liveness information — a load balancer must stop routing to a
    draining (or failed) engine before its queue disappears. Closed
    rows age out after ENGINE_STATE_TTL_S so a rotated replica's
    terminal state is not served forever."""
    with _ENGINE_STATE_LOCK:
        swept = _sweep_engine_states_locked()
        snapshot = list(_ENGINE_STATES.items())
        if swept:
            _publish_engine_states(snapshot)
    return {str(k): state for k, (state, _ts) in snapshot}

# chaos hooks (faults.py): serve.enqueue drills queue-path failures;
# serve.prefill tears the admission seam; serve.decode drills the
# decode loop (delay = wedge, raise(slot=N) = contained poisoned slot,
# unhinted raise = engine-fatal); serve.fetch tears the async
# materialization seam the same way.
_F_ENQUEUE = _faults.site("serve.enqueue")
_F_PREFILL = _faults.site("serve.prefill")
_F_DECODE = _faults.site("serve.decode")
_F_FETCH = _faults.site("serve.fetch")

REQUEST_OUTCOMES = ("completed", "length", "expired", "rejected",
                    "rejected_early", "drained", "error", "evicted")

# poisoned-slot attribution in a decode/fetch error's text: the chaos
# plan's raise(slot=N[,M]) protocol, and the shape a real per-slot
# device error report takes. No match = unattributable = engine-fatal.
_SLOT_HINT_RE = re.compile(r"slots?\s*[=:]\s*(\d+(?:\s*,\s*\d+)*)")


def _slot_hints(exc) -> Optional[List[int]]:
    m = _SLOT_HINT_RE.search(str(exc))
    if m is None:
        return None
    return sorted({int(p) for p in m.group(1).split(",")})


class QueueFull(RuntimeError):
    """submit() backpressure: the request queue is at serve_queue_depth."""


class EngineClosed(RuntimeError):
    """submit()/step() on a closed engine."""


class EngineFailed(RuntimeError):
    """The engine hit an unattributable decode/fetch failure: device
    state can no longer be trusted, only a (supervised) rebuild can
    serve again. ``submit()``/``step()`` raise this until close()."""


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
    """One in-flight generation request (handle returned by submit)."""

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
        self.tokens: List[int] = []
        self.outcome: Optional[str] = None
        self.ttft_s: Optional[float] = None
        self.replays = 0  # supervised-restart replays of this request
        self.capped = False  # max_new_tokens cut by brownout
        # request-scoped observability (serving_trace.py): measured
        # per-phase latencies, the deadline attribution, the censored
        # flag (terminal before first token), and the request's pinned
        # Chrome-trace track. Plain attributes set by the engine's
        # scheduler tick — reading a clock and storing a float keeps
        # the telemetry-off hot path allocation-free in the new plane.
        self.engine_id: Optional[int] = None
        self.admit_ts: Optional[float] = None
        self.finish_ts: Optional[float] = None
        self.queue_wait_s: Optional[float] = None
        self.prefill_s: Optional[float] = None
        self.decode_s = 0.0
        self.fetch_s = 0.0
        self.censored = False
        self.deadline_attr: Optional[Dict] = None
        self.trace_tid: Optional[int] = None
        self._replay_intake_ts: Optional[float] = None
        # set by the supervisor's replay intake; the RESET (token wipe)
        # is deferred to the rebuilt engine's admission so a replay
        # that never reaches prefill keeps its partial output
        self._replay_pending = False
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def trace_id(self) -> str:
        """Stable id tying the handle to its timeline track, /requests
        rows and log lines — survives supervised-restart replays."""
        return f"r{self.id}"

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request reaches a terminal outcome; returns
        the emitted tokens (EOS excluded)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.id} not finished within {timeout}s")
        return list(self.tokens)

    def _finish(self, outcome: str):
        self.outcome = outcome
        _M_REQUESTS.inc(labels={"outcome": outcome})
        # the one funnel every terminal path flows through: censored
        # TTFT metering, SLO scoring, deadline attribution, and the
        # /requests ring record happen here, BEFORE waiters wake
        _strace.note_terminal(self)
        self._done.set()

    def _reset_for_replay(self):
        """Applied at the rebuilt engine's ADMISSION (not at harvest —
        a replay that is drained/errored before prefill must keep its
        partial output): decode restarts from scratch (greedy is
        deterministic — the final stream is byte-identical); TTFT
        re-measures from the original submit."""
        self._replay_pending = False
        self.tokens = []
        self.ttft_s = None
        # the phase decomposition restarts with the replay; queue wait
        # re-derives from the ORIGINAL submit at the rebuilt engine's
        # admission, so the restart gap lands in the queue phase and
        # the phase sum still covers the request's wall time
        self.queue_wait_s = None
        self.prefill_s = None
        self.decode_s = 0.0
        self.fetch_s = 0.0
        self.replays += 1
        _M_REPLAYED.inc()
        _strace.note_restart(self)


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
    """Continuous-batching serving engine over the transformer zoo.

    One engine = one model + one batch geometry: ``slots`` concurrent
    requests, sources padded/bucketed to ``src_len``, at most
    ``max_len - 1`` generated tokens per request. ``submit()`` enqueues
    (with queue-depth backpressure, optional per-request deadlines, and
    deadline-aware admission control); the caller drives ``step()`` —
    or ``run_until_idle()`` — to make progress; ``drain()`` stops
    admissions and finishes the in-flight set; ``close()`` drains and
    releases the compiled entries. The lifecycle (serving -> draining
    -> closed, or -> failed on an unattributable decode fault) is
    observable: ``state`` here, ``pt_serve_engine_state`` on /metrics,
    and per-engine rows on the /healthz route (``engine_states``). For
    a self-healing engine, wrap it in ``EngineSupervisor`` (or
    ``serve(..., supervised=True)``).
    """

    _eid = itertools.count(1)

    def __init__(self, cfg, weights, *, slots: int = 4, src_len: int = 32,
                 max_len: int = 32, bos_id: int = 0, end_id: int = 1,
                 place=None, queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 pipeline_depth: int = 1,
                 admission_control: Optional[bool] = None):
        from paddle_tpu_torch.models import transformer as _T

        if slots < 1:
            raise ValueError("need at least one batch slot")
        self.cfg = cfg
        self.slots = int(slots)
        self.src_len, self.max_len = int(src_len), int(max_len)
        self.bos_id, self.end_id = int(bos_id), int(end_id)
        self.queue_depth = (int(_flags.get_flag("serve_queue_depth"))
                            if queue_depth is None else int(queue_depth))
        default_deadline = (float(_flags.get_flag("serve_deadline_ms"))
                            if deadline_ms is None else float(deadline_ms))
        self.deadline_s = default_deadline / 1e3 if default_deadline else 0.0
        # 1 = double-buffered decode (step N's fetch materializes under
        # step N+1's dispatch); 0 = fully synchronous steps
        self.pipeline_depth = 1 if pipeline_depth else 0
        # None: the serve_admission_control flag, read at each submit
        self.admission_control = admission_control
        self._progs = _T.build_serving(cfg, self.slots, self.src_len,
                                       self.max_len, bos_id=self.bos_id,
                                       end_id=self.end_id)
        self.scope = Scope()
        self._exe = Executor(place)
        with _GATE.shared():  # a model directory's tensors go to the card
            self.int8 = _load_weights_into(self.scope, weights, self._exe)
        # device-resident serving state, zero-initialized (live=False
        # everywhere: every slot starts free)
        for name, (shape, dtype) in self._progs["state_specs"].items():
            self.scope.set(name, np.zeros(shape, dtype=np.dtype(dtype)))
        self._queue: "collections.deque[ServeRequest]" = collections.deque()
        self._slots = [_Slot() for _ in range(self.slots)]
        # (LazyFetches, per-slot request snapshot, t0, retried, step)
        self._pending = None
        self._lock = threading.Lock()
        # every executor call of the engine holds this lock and re-checks
        # _closed under it (see _run); close() takes it to retire the
        # executor
        self._dispatch_lock = threading.Lock()
        # completed executor calls by program uid, and the calls in
        # progress that lower or capture (a program's first two): the
        # watchdog's wedge detection waits for both (see _wedge_armed)
        self._runs: Dict[int, int] = collections.Counter()
        self._cold_calls = 0
        # the thread that makes the engine's executor calls (the
        # supervisor's loop thread): the watchdog asks the capture gate
        # whether it is waiting
        self._loop_ident: Optional[int] = None
        # the request _admit has popped and not yet placed (harvest and
        # close take it from here)
        self._in_hand: Optional[ServeRequest] = None
        self._draining = False
        self._closed = False
        self._failed = False
        self.last_error: Optional[str] = None
        # decode-loop heartbeat (EngineSupervisor wedge detection) and
        # the measured per-token latency estimator (admission control;
        # EWMA of decode-step wall time, independent of telemetry)
        self._beat = time.perf_counter()
        self._token_ewma_s: Optional[float] = None
        # recent decode-step walls (dispatch -> tokens on host), for
        # the stats() latency row + overload drills; the first
        # (compile-carrying) step is excluded like the EWMA
        self._step_walls: "collections.deque[float]" = collections.deque(
            maxlen=256)
        # per-dispatch stall_guard deadline override; 0 = the global
        # stall_timeout_ms flag (default 0 = disarmed, a shared
        # nullcontext — the hot path stays Timer-free)
        self.stall_deadline_ms = 0.0
        # brownout (overload shedding) state
        self.brownout = False
        self._saturated_ticks = 0
        self.decode_steps = 0
        self.tokens_emitted = 0
        self.completed = 0
        self.engine_id = next(ServingEngine._eid)
        _ENGINES.add(self)
        _note_engine_state(self.engine_id, "serving")

    # --- request intake ---

    def submit(self, src_ids: Sequence[int],
               src_pad: Optional[Sequence[float]] = None,
               max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> ServeRequest:
        """Enqueue a generation request. ``src_ids`` shorter than the
        engine's ``src_len`` is padded (mask derived); longer raises.
        Backpressure: raises QueueFull beyond ``serve_queue_depth``;
        a deadline the measured per-token latency says is unmeetable
        raises DeadlineUnmeetable (outcome ``rejected_early``) without
        queueing — see the ``serve_admission_control`` flag."""
        _F_ENQUEUE.hit()
        ids = np.asarray(src_ids, np.int64).reshape(-1)
        if ids.shape[0] > self.src_len:
            raise ValueError(
                f"source length {ids.shape[0]} exceeds the engine's "
                f"src_len {self.src_len}")
        if src_pad is None:
            pad = (np.arange(self.src_len) < ids.shape[0]).astype(
                np.float32)
        else:
            # accepted at either the request's own length or the
            # engine's full src_len (the training graph's mask shape)
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
        req.engine_id = self.engine_id
        with self._lock:
            # closed/draining re-checked under the SAME lock drain()
            # clears the queue with: a submit racing a drain must either
            # land before the sweep or raise, never enqueue onto an
            # engine nobody will step again
            if self._closed:
                raise EngineClosed("submit() on a closed engine")
            if self._failed:
                raise EngineFailed(
                    f"submit() on a failed engine ({self.last_error}); "
                    f"an EngineSupervisor would have restarted it")
            if self._draining:
                raise EngineClosed("submit() on a draining engine")
            if len(self._queue) >= self.queue_depth:
                req._finish("rejected")
                _publish_gauges()
                raise QueueFull(
                    f"serving queue at capacity ({self.queue_depth})")
            if (req.deadline_ts is not None
                    and self._token_ewma_s is not None
                    and (_flags.get_flag("serve_admission_control")
                         if self.admission_control is None
                         else self.admission_control)):
                eta_s = self._estimate_first_token_s()
                if req.submit_ts + eta_s > req.deadline_ts:
                    # refused AT SUBMIT, never queued: queueing work
                    # that provably cannot emit one token before its
                    # deadline only inflates every neighbor's latency.
                    # The ESTIMATED queue wait is the refusal's whole
                    # story — recorded so the deadline attribution can
                    # name the phase that ate the budget.
                    req.queue_wait_s = eta_s
                    req._finish("rejected_early")
                    _publish_gauges()
                    raise DeadlineUnmeetable(
                        f"deadline unmeetable: first token estimated "
                        f"in {eta_s * 1e3:.1f} ms (measured "
                        f"{self._token_ewma_s * 1e3:.2f} ms/token x "
                        f"queue position) vs a "
                        f"{(req.deadline_ts - req.submit_ts) * 1e3:.1f}"
                        f" ms deadline", request=req, estimate_s=eta_s)
            # the heartbeat also resets at WORK ARRIVAL — but only when
            # the engine is truly IDLE: after an idle gap longer than
            # the wedge timeout, the first submit flips busy() before
            # the loop's next step() can beat (the watchdog would read
            # the idle age as a wedge). An engine with work in flight
            # gets no reset: steady submit traffic onto a genuinely
            # wedged decode loop must not defer its detection.
            idle = (not self._queue and self._pending is None
                    and all(s.request is None for s in self._slots))
            if idle:
                self._beat = time.perf_counter()
            self._queue.append(req)
            _publish_gauges()
        _strace.note_submit(req)
        return req

    def _estimate_first_token_s(self) -> float:
        """Estimated delay until a request submitted NOW sees its first
        token: tokens still owed ahead of it (queue + in-flight),
        drained ``slots`` at a time, at the measured per-token EWMA.
        Caller holds the lock."""
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
        self._beat = time.perf_counter()
        self._brownout_tick()
        emitted = self._process_ready()
        self._admit()
        self._dispatch()
        if self.pipeline_depth == 0:
            emitted += self._process_ready()
        self._beat = time.perf_counter()
        return emitted

    def run_until_idle(self, max_steps: int = 100_000) -> int:
        """Drive step() until no request is queued or in flight; returns
        total tokens emitted. ``max_steps`` bounds a runaway loop."""
        total = 0
        for _ in range(max_steps):
            total += self.step()
            if not self.busy():
                break
        # resolve a still-pending final step
        total += self._process_ready()
        return total

    def busy(self) -> bool:
        with self._lock:
            queued = bool(self._queue)
        return (queued or self._pending is not None
                or any(s.request is not None for s in self._slots))

    def heartbeat_age_s(self) -> float:
        """Seconds since the decode loop last made progress (step entry
        or completion, the end of a call that lowered or captured, or
        the end of a wait for the capture gate) — the EngineSupervisor's
        wedge signal."""
        return time.perf_counter() - max(self._beat,
                                         _GATE.wait_ended(self._loop_ident))

    def _wedge_armed(self) -> bool:
        """Whether a stale heartbeat may read as a wedge: only once the
        decode program's graph has been captured (its second call
        returned), while no call lowers or captures a program, and while
        the loop thread does not wait for the capture gate (another
        engine captures). A capture on the card takes far longer than a
        replayed step and must not cause a restart, here or in a replica
        it holds back; the JAX watchdog arms after the first decode
        step, which carries XLA's compile."""
        return (self._runs[self._progs["decode_program"]._uid] >= 2
                and self._cold_calls == 0
                and not _GATE.waiting(self._loop_ident))

    def _run(self, program, feed, fetch_list, async_fetch=False):
        """Every executor call of the engine: under the dispatch lock,
        re-checking ``_closed`` there (after any fault site the caller
        passed), so a loop thread that wakes after its engine was closed
        returns None instead of touching the card."""
        uid = program._uid
        with self._dispatch_lock:
            if self._closed:
                return None
            self._loop_ident = threading.get_ident()
            cold = self._runs[uid] < 2
            if cold:
                self._cold_calls += 1
            try:
                with scope_guard(self.scope):
                    out = self._exe.run(program, feed=feed,
                                        fetch_list=fetch_list,
                                        async_fetch=async_fetch)
            finally:
                if cold:
                    # the heartbeat restarts where the capture ends
                    self._beat = time.perf_counter()
                    self._cold_calls -= 1
            self._runs[uid] += 1
        return out

    def request_drain(self) -> bool:
        """The non-stepping front half of drain(): stop admissions and
        finish every queued-but-unadmitted request with outcome
        'drained'. The in-flight set keeps decoding (whoever drives
        step() — the caller or a supervisor loop — finishes it).
        Returns False when the engine is already closed."""
        with self._lock:
            if self._closed:
                return False
            # flag + queue sweep under one lock: a racing submit either
            # landed (and is drained here) or raises EngineClosed
            self._draining = True
            while self._queue:
                self._queue.popleft()._finish("drained")
            _publish_gauges()
            _note_engine_state(self.engine_id, "draining")
        return True

    def handoff_queued(self) -> List[ServeRequest]:
        """Fleet-rollout front half of a drain: stop admissions, but
        TAKE the queued-but-unadmitted requests instead of finishing
        them 'drained' — the router re-homes them on another replica,
        so a rolling weight rollout rejects nothing. The in-flight set
        keeps decoding (whoever drives step() finishes it). Returns []
        on a closed engine."""
        out: List[ServeRequest] = []
        with self._lock:
            if self._closed:
                return out
            self._draining = True
            while self._queue:
                r = self._queue.popleft()
                if r.outcome is None:
                    out.append(r)
            _publish_gauges()
            _note_engine_state(self.engine_id, "draining")
        return out

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful drain: stop admissions, finish the in-flight set.
        Queued-but-unadmitted requests finish with outcome 'drained'.
        Returns True when everything settled inside ``timeout_s``."""
        with self._lock:
            if self._closed:
                # nothing left to drain — and the published lifecycle
                # must not regress closed -> draining for an idempotent
                # caller (checked under the SAME lock close() flips
                # _closed with, so a drain racing a close cannot pass
                # the check and then publish 'draining' afterwards)
                return True
        if not self.request_drain():
            return True
        if self._failed:
            # a failed engine cannot step: the queue is swept, the
            # in-flight set is close()'s (or the supervisor's) problem
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
        """Drain, then release the engine's compiled entries + staged
        feeds and its device-resident state. A drain that times out
        (stalled decode loop) or a failed engine must not strand
        callers: every still in-flight handle is finished — outcome
        'drained' (partial output kept), or 'error' when the engine
        failed — so ``result()`` never blocks forever on a closed
        engine."""
        if self._closed:
            return
        if not self._failed:
            self.drain(drain_timeout_s)
        with self._lock:
            # under the same lock drain() checks: once this flips, a
            # concurrent drain can no longer publish 'draining' over
            # the terminal 'closed' state below
            self._closed = True
            dropped, self._pending = self._pending, None
            leftovers = []
            if self._in_hand is not None:
                if self._in_hand.outcome is None:
                    leftovers.append(self._in_hand)
                self._in_hand = None
            for s in self._slots:
                req, s.request = s.request, None
                if req is not None and req.outcome is None:
                    leftovers.append(req)
            while self._queue:
                r = self._queue.popleft()
                if r.outcome is None:
                    leftovers.append(r)
        with _GATE.shared():
            # the dispatched step's fetches no one will read: freeing
            # their pinned buffers records CUDA events, and this may not
            # be the loop thread
            del dropped
        outcome = "error" if self._failed else "drained"
        for req in leftovers:
            req._finish(outcome)
        # retire the executor (its graphs and pool freed, later runs
        # refused) once no executor call is in progress; a call that does
        # not return within the timeout (a hung device call) keeps its
        # graphs, and the executor still refuses every later run
        if self._dispatch_lock.acquire(timeout=_CLOSE_DISPATCH_WAIT_S):
            try:
                self._exe.retire(f"serving engine {self.engine_id} closed")
            finally:
                self._dispatch_lock.release()
        else:
            self._exe._retired = f"serving engine {self.engine_id} closed"
        self.scope.clear()
        _ENGINES.discard(self)
        _note_engine_state(self.engine_id, "closed")
        _publish_gauges()

    # --- internals ---

    def _active_mask(self) -> np.ndarray:
        return np.asarray(
            [s.request is not None and s.request.outcome is None
             for s in self._slots], bool)

    def _brownout_tick(self):
        """Overload shedding: once the queue has held >= factor x
        capacity entries for `serve_brownout_window` consecutive ticks,
        cap admissions' max_new_tokens — degrade tokens-per-request
        instead of letting queue latency collapse. Disengages as soon
        as a tick sees the queue below the threshold."""
        factor = float(_flags.get_flag("serve_brownout_queue_factor"))
        if factor <= 0.0:
            if self.brownout:
                self.brownout = False
                _publish_gauges()
            self._saturated_ticks = 0
            return
        threshold = max(1, int(round(factor * self.queue_depth)))
        with self._lock:
            qlen = len(self._queue)
        if qlen >= threshold:
            self._saturated_ticks += 1
            if (not self.brownout and self._saturated_ticks
                    >= int(_flags.get_flag("serve_brownout_window"))):
                self.brownout = True
                warnings.warn(
                    f"serving engine {self.engine_id}: brownout engaged "
                    f"(queue held >= {threshold}/{self.queue_depth} for "
                    f"{self._saturated_ticks} ticks); admissions capped "
                    f"at {_flags.get_flag('serve_brownout_max_new_tokens')}"
                    f" new tokens", RuntimeWarning)
                _publish_gauges()
        else:
            self._saturated_ticks = 0
            if self.brownout:
                self.brownout = False
                _publish_gauges()

    def _admit(self):
        """Admissions at the token boundary: free slot x queued request
        -> prefill. The prefill program executes after the already
        dispatched decode step, so the newcomer joins at the next one."""
        while True:
            free = next((i for i, s in enumerate(self._slots)
                         if s.request is None), None)
            if free is None:
                return
            with self._lock:
                if self._failed or self._closed or not self._queue:
                    return
                req = self._queue.popleft()
                self._in_hand = req
                _publish_gauges()
            now = time.perf_counter()
            if req.deadline_ts is not None and now > req.deadline_ts:
                # the deadline elapsed while QUEUED: the measured queue
                # wait is what ate the budget — record it before the
                # terminal accounting attributes the expiry
                req.queue_wait_s = now - req.submit_ts
                if self._release_in_hand(req):
                    req._finish("expired")
                continue
            was_replay = req._replay_pending
            if was_replay:
                # the token wipe happens HERE, where the replay really
                # re-enters decode — not at harvest time
                req._reset_for_replay()
            if self.brownout and not was_replay:
                # replays are exempt: capping one would break the
                # byte-identical-replay invariant (and could return
                # fewer tokens than its pre-restart partial output)
                cap = int(_flags.get_flag("serve_brownout_max_new_tokens"))
                if cap >= 1 and req.max_new_tokens > cap:
                    req.max_new_tokens = cap
                    req.capped = True
                    _M_BROWNOUT_CAPPED.inc()
            # phase decomposition: the queue span closes at the pop
            # (replays re-measure from the ORIGINAL submit — the
            # restart gap is queue time from the request's view)
            req.admit_ts = time.perf_counter()
            req.queue_wait_s = req.admit_ts - req.submit_ts
            pre = self._progs["prefill"]
            try:
                _F_PREFILL.hit()
                with _monitor.span("serve.prefill"):
                    ran = self._run(
                        self._progs["prefill_program"],
                        feed={
                            pre["feeds"][0].name: req.src_ids[None, :],
                            pre["feeds"][1].name: req.src_pad[None, :],
                            pre["feeds"][2].name:
                                np.asarray([free], np.int64),
                        },
                        fetch_list=[])
                req.prefill_s = time.perf_counter() - req.admit_ts
            except Exception as e:
                # the request is already off the queue and owns no slot:
                # finish the handle before propagating — result() must
                # never block forever on a failed admission
                if self._release_in_hand(req):
                    req._finish("error")
                _monitor.maybe_record_oom(
                    e, program=self._progs["prefill_program"],
                    phase="serve")
                raise
            with self._lock:
                # closed or harvested while the prefill ran (or a fault
                # plan held the thread): close() finished the request or
                # a supervisor is replaying it; either way it is not ours
                if ran is None or self._in_hand is not req:
                    return
                self._in_hand = None
                self._slots[free].request = req
            _M_PREFILLS.inc()
            _strace.note_admit(req)
            _publish_gauges()

    def _release_in_hand(self, req) -> bool:
        """Drop the popped request ``req`` from ``_in_hand``; False when a
        harvest or close() took it meanwhile (it is no longer ours to
        finish)."""
        with self._lock:
            mine = self._in_hand is req
            self._in_hand = None
        return mine

    def _dispatch(self):
        """Launch one single-token decode step for the active set (a
        no-op tick when every slot is free)."""
        if self._pending is not None:
            # a contained fetch fault re-pended the step's fetches for
            # retry: dispatching over them would clobber the healthy
            # slots' already-computed tokens and fork their streams
            return
        mask = self._active_mask()
        if not mask.any():
            return
        dec = self._progs["decode"]
        t0 = time.perf_counter()
        try:
            with _monitor.span("serve.decode"), \
                    _monitor.stall_guard("serve.decode",
                                         self.stall_deadline_ms or None):
                _F_DECODE.hit()
                fetches = self._run(
                    self._progs["decode_program"],
                    feed={dec["feeds"][0].name: mask},
                    fetch_list=[dec["emit"], dec["live"], dec["pos"],
                                dec["maxabs"], dec["score"]],
                    async_fetch=True)
        except Exception as e:
            self._contain_decode_error(e)
            return
        if fetches is None:
            # closed while a fault plan held this thread: the engine was
            # replaced, and this tick must not touch the card
            return
        snapshot = [s.request if m else None
                    for s, m in zip(self._slots, mask)]
        self._pending = (fetches, snapshot, t0, False, self.decode_steps)
        self.decode_steps += 1
        _M_DECODE_STEPS.inc()

    def _attribute_or_fail(self, exc) -> List[int]:
        """Shared decode/fetch failure classification: RESOURCE_EXHAUSTED
        runs the OOM forensics hook (phase="serve"; the executor already
        ran donated-buffer hygiene) and fails the engine; an error with
        no slot hint is unattributable and fails the engine; otherwise
        the candidate slot list is returned for the caller's eviction
        body. One policy, two call sites — they must not diverge."""
        if _monitor.is_oom_error(exc):
            _monitor.maybe_record_oom(
                exc, program=self._progs["decode_program"], phase="serve")
            self._fail(exc)
            raise exc
        hints = _slot_hints(exc)
        if hints is None:
            self._fail(exc)
            raise exc
        return hints

    def _contain_decode_error(self, exc):
        """Dispatch-path failure policy: a slot-hinted error evicts only
        the poisoned slots (the fault fired before/at dispatch — device
        state for the healthy slots is consistent, no token was lost);
        anything unattributable fails the engine."""
        hints = self._attribute_or_fail(exc)
        evicted = []
        with self._lock:
            for i in hints:
                if 0 <= i < self.slots:
                    req = self._slots[i].request
                    if req is not None and req.outcome is None:
                        _strace.note_evicted(req, "fault", i)
                        self._finish_slot(i, req, "evicted")
                        _M_SLOT_EVICTIONS.inc(labels={"cause": "fault"})
                        evicted.append((i, req))
            _publish_gauges()
        if not evicted:
            # the hint named no active slot (out of range, or already
            # finished): nothing was contained — swallowing it would
            # livelock a persistently failing decode step
            self._fail(exc)
            raise exc
        self._scrub_evicted(evicted)

    def _contain_fetch_error(self, exc, fetches, snapshot, t0,
                             retried, step) -> List:
        """Materialization-path failure policy (caller holds the lock):
        a slot-hinted error evicts the poisoned slots and re-pends the
        step's fetches for ONE retry (the healthy slots' tokens are
        still in the buffers — dropping them would fork their streams);
        a second failure or an unattributable one fails the engine.
        Returns the evicted (slot, request) pairs for the caller to
        scrub OUTSIDE the lock (the scrub is a blocking device call)."""
        hints = self._attribute_or_fail(exc)
        if retried:
            self._fail(exc)
            raise exc
        evicted = []
        for i in hints:
            if 0 <= i < self.slots:
                req = self._slots[i].request
                if (req is not None and req.outcome is None
                        and snapshot[i] is req):
                    _strace.note_evicted(req, "fault", i)
                    self._finish_slot(i, req, "evicted")
                    _M_SLOT_EVICTIONS.inc(labels={"cause": "fault"})
                    snapshot[i] = None
                    evicted.append((i, req))
        if not evicted:
            # hint matched no active slot: nothing was contained (see
            # _contain_decode_error — a swallow here would livelock)
            self._fail(exc)
            raise exc
        self._pending = (fetches, snapshot, t0, True, step)
        _publish_gauges()
        return evicted

    def _scrub_evicted(self, slots: List):
        """Run the per-slot device scrub AFTER the engine lock is
        released — a blocking device call under the lock would wedge
        submit()/busy()/the supervisor watchdog (the exact hang the
        watchdog exists to recover from). Safe lock-free: only the one
        driver thread admits, so a freed slot cannot be re-occupied
        before its scrub runs. A FAILING scrub fails the engine: an
        unscrubbed slot would re-poison its next occupant. ``slots``
        carries (slot, victim request) pairs so the scrub lands on the
        victim's timeline track."""
        for i, req in slots:
            try:
                self._scrub_slot_state(i)
            except Exception as e:
                self._fail(e)
                raise
            _strace.note_scrub(req, i)

    def _fail(self, exc):
        """Mark the engine failed (unattributable decode/fetch fault:
        device state untrusted). Pending handles stay pending — an
        EngineSupervisor harvests and replays them; an unsupervised
        caller's close() finishes them with outcome 'error'."""
        if self._failed:
            return
        self._failed = True
        self.last_error = f"{type(exc).__name__}: {exc}"[:500]
        _note_engine_state(self.engine_id, "failed")
        _publish_gauges()

    def _scrub_slot_state(self, i: int):
        """Zero slot ``i``'s row in every device-resident serving
        tensor. A poisoned occupant's non-finite K/V rows would
        re-poison the NEXT occupant straight through the softmax mask
        (a masked weight underflows to exactly 0.0, and 0 * NaN = NaN),
        so eviction must scrub, not just free, the slot. Runs the
        compiled slot-scrub program (transformer.build_slot_scrub) so
        the caches stay on device — a host round-trip of the full KV
        rings to zero one row would stall every healthy slot."""
        scr = self._progs["scrub"]
        self._run(self._progs["scrub_program"],
                  feed={scr["feeds"][0].name: np.asarray([i], np.int64)},
                  fetch_list=[])

    def _process_ready(self) -> int:
        """Materialize the pending decode step's fetches and hand each
        slot's token to its request; evict finished/expired/poisoned
        requests (their slots free for the next admission round).

        The blocking device wait runs OUTSIDE the engine lock: a hung
        fetch must not wedge submit()/busy()/the supervisor watchdog
        behind it (the lock is taken only to swap the pending step out
        and to apply its results)."""
        with self._lock:
            if self._failed or self._closed:
                self._pending = None
                return 0
            if self._pending is None:
                return 0
            fetches, snapshot, t0, retried, step = self._pending
            self._pending = None
        try:
            # decode/fetch phase split: device work runs dispatch->t_f0,
            # the host materialization t_f0->t_f1 (with async_fetch the
            # device wait resolves inside np.asarray)
            t_f0 = time.perf_counter()
            _F_FETCH.hit()
            emit, live, pos, maxabs, score = [np.asarray(a)
                                              for a in fetches]
            t_f1 = time.perf_counter()
        except Exception as e:
            with self._lock:
                if self._failed or self._closed:
                    return 0
                to_scrub = self._contain_fetch_error(
                    e, fetches, snapshot, t0, retried, step)
            self._scrub_evicted(to_scrub)  # device call: outside lock
            return 0
        with self._lock:
            if self._failed or self._closed:
                # harvested/closed while we were waiting: the snapshot's
                # requests may already be replaying elsewhere — discard
                return 0
            now = time.perf_counter()
            step_s = now - t0
            # measured per-token latency (admission-control estimator).
            # The decode program's first call lowers it and its second
            # captures its graph, each far slower than a replayed step,
            # so neither seeds the EWMA (the JAX engine skips its first
            # step, XLA's compile): a warm-up-poisoned estimate would
            # misjudge deadlines for dozens of steps.
            if self._runs[self._progs["decode_program"]._uid] > 2:
                self._step_walls.append(step_s)
                if self._token_ewma_s is None:
                    self._token_ewma_s = step_s
                else:
                    self._token_ewma_s = (0.8 * self._token_ewma_s
                                          + 0.2 * step_s)
            emitted = 0
            to_scrub = []
            # per-request phase accumulation: the step's device wall is
            # decode time, the host materialization fetch time — every
            # request served by this step pays the same split
            decode_d = t_f0 - t0
            fetch_d = t_f1 - t_f0
            traced = _monitor.trace_step_sampled(step)
            for i, req in enumerate(snapshot):
                if req is None or req.outcome is not None:
                    continue
                if not np.isfinite(maxabs[i]):
                    # poisoned slot: non-finite logits. Contained — the
                    # request keeps its partial output, the slot is
                    # scrubbed (below, outside the lock) + freed,
                    # healthy slots keep decoding. Reported through the
                    # numerics plane (counter + provenance record).
                    _numerics.note_nonfinite(
                        "decode_step", f"slot{i}:logits",
                        program_uid=self._progs["decode_program"]._uid,
                        step=self.decode_steps, kind="serve",
                        maxabs=float(maxabs[i]))
                    _strace.note_evicted(req, "nonfinite", i)
                    self._finish_slot(i, req, "error")
                    to_scrub.append((i, req))
                    _M_SLOT_EVICTIONS.inc(labels={"cause": "nonfinite"})
                    continue
                req.decode_s += decode_d
                req.fetch_s += fetch_d
                tok = int(emit[i])
                alive = bool(live[i])
                if traced:
                    _strace.note_decode_step(
                        req, step, t0, t_f0, t_f1, tok, int(pos[i]),
                        float(score[i]))
                if not alive and tok == self.end_id:
                    # EOS (or a dead-slot freeze): terminal, token dropped
                    self._finish_slot(i, req, "completed")
                    continue
                req.tokens.append(tok)
                emitted += 1
                self.tokens_emitted += 1
                _M_TOKENS.inc()
                _M_TOKEN_SECONDS.observe(step_s)
                if req.ttft_s is None:
                    req.ttft_s = now - req.submit_ts
                    _M_TTFT_SECONDS.observe(req.ttft_s)
                if not alive or len(req.tokens) >= req.max_new_tokens:
                    # device length cap (max_len positions) or the
                    # request's own token budget: terminal without EOS
                    self._finish_slot(i, req, "length")
                elif (req.deadline_ts is not None
                        and now > req.deadline_ts):
                    # deadline eviction AT the token boundary: the slot
                    # is freed now; the partial output stays on the
                    # handle (also the path a deadline expiring while
                    # the async fetch was in flight resolves through)
                    self._finish_slot(i, req, "expired")
            _publish_gauges()
        # the scrubs run with the lock RELEASED and the whole token loop
        # already applied: a scrub failure cannot drop a healthy slot's
        # materialized token, and a hung scrub stays watchdog-visible
        self._scrub_evicted(to_scrub)
        return emitted

    def _finish_slot(self, i: int, req: ServeRequest, outcome: str):
        req._finish(outcome)
        self.completed += 1
        self._slots[i].request = None

    def _harvest_for_replay(self) -> List[ServeRequest]:
        """Supervisor-only: atomically mark the engine failed and take
        every pending (outcome-less) request — in-flight first (their
        admission order), then the queue — so close() cannot finish
        them and the restarted engine can replay them."""
        with self._lock:
            self._failed = True
            if self.last_error is None:
                self.last_error = "harvested for supervised restart"
            out = []
            if self._in_hand is not None:
                # popped by the loop thread and not yet placed: it goes
                # first, as it was admitted before the queue behind it
                if self._in_hand.outcome is None:
                    out.append(self._in_hand)
                self._in_hand = None
            for s in self._slots:
                req, s.request = s.request, None
                if req is not None and req.outcome is None:
                    out.append(req)
            while self._queue:
                r = self._queue.popleft()
                if r.outcome is None:
                    out.append(r)
            dropped, self._pending = self._pending, None
            _publish_gauges()
        with _GATE.shared():  # see close()
            del dropped
        _note_engine_state(self.engine_id, "failed")
        return out

    def _enqueue_replay(self, req: ServeRequest):
        """Supervisor replay intake: bypasses backpressure + admission
        control (the requests were already admitted once — refusing a
        replay would turn one engine fault into request failures). The
        partial output survives until the replay actually re-prefills;
        a dead intake finishes the handle 'error' with it intact."""
        req._replay_intake_ts = time.perf_counter()
        req.engine_id = self.engine_id
        with self._lock:
            if self._closed or self._failed:
                req._finish("error")
                return
            req._replay_pending = True
            if (not self._queue and self._pending is None
                    and all(s.request is None for s in self._slots)):
                self._beat = time.perf_counter()  # idle-only, as submit
            self._queue.append(req)
            _publish_gauges()

    @property
    def state(self) -> str:
        return ("closed" if self._closed
                else "failed" if self._failed
                else "draining" if self._draining else "serving")

    def stats(self) -> Dict:
        """One JSON-able row for the /serve route."""
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
            "brownout": self.brownout,
            "last_error": self.last_error,
            "token_ewma_ms": (None if self._token_ewma_s is None
                              else round(self._token_ewma_s * 1e3, 3)),
            "step_wall_ms_p99": (
                None if not self._step_walls
                else round(float(np.percentile(
                    list(self._step_walls), 99)) * 1e3, 3)),
            "int8": self.int8,
            "pipeline_depth": self.pipeline_depth,
        }


class EngineSupervisor:
    """Self-healing serving process: owns a ServingEngine, the thread
    that drives its decode loop, and a watchdog that warm-restarts it.

    Failure handling:

    - **crashed**: an engine-fatal error (unattributable decode/fetch
      fault, device OOM) escapes ``step()`` on the loop thread;
    - **wedged**: the engine is busy but its decode heartbeat is older
      than ``serve_wedge_timeout_ms`` (e.g. a hung device call) — the
      watchdog declares it dead without waiting for it to return, and
      emits the stall record a ``monitor.stall_guard`` would have
      produced (site ``serve.decode``; a per-dispatch guard would cost
      one Timer thread per decode step). Wedge detection arms only
      after the engine's decode program has been captured as a CUDA
      graph (its second call), and never during a call that lowers or
      captures a program (``ServingEngine._wedge_armed``): a capture
      legitimately holds the heartbeat far longer than a replayed step
      and must not read as a wedge. This differs from the JAX
      supervisor, which arms after the first decode step (its compile).

    Either way the old engine is harvested (every queued + in-flight
    handle taken before close() can finish it), torn down (its executor
    retired: graphs and pool freed), and a new engine is built, with
    its own executor and graph pool, under a retry.py policy; the new
    engine lowers and captures its programs again (the port has no
    persistent compile cache yet). A sticky CUDA error (an illegal
    address) poisons the process's CUDA context: the rebuild then fails
    under the retry budget and the pending requests finish ``error``.
    Otherwise the harvested requests are re-prefilled in their
    original order and decode from scratch (greedy is deterministic:
    byte-identical tokens). The restart budget (``serve_max_restarts``)
    bounds a permanently failing engine: past it, pending handles
    finish with outcome 'error' and the supervisor closes.

    Metered: ``pt_serve_engine_restarts_total``,
    ``pt_serve_requests_replayed_total``.
    """

    def __init__(self, cfg, weights, *,
                 wedge_timeout_ms: Optional[float] = None,
                 max_restarts: Optional[int] = None,
                 restart_policy: Optional["_retry.RetryPolicy"] = None,
                 restart_deadline_s: float = 60.0,
                 poll_s: float = 0.02,
                 on_handoff=None, **engine_kwargs):
        self._cfg = cfg
        self._weights = weights
        # fleet seam: called with the pending request list when this
        # supervisor fails TERMINALLY (restart budget exhausted or
        # rebuild failed). A truthy return means the callee took
        # ownership (the fleet router replays them on survivors);
        # otherwise they finish 'error' as before. Called under
        # self._lock — the callee must only hand the list off (no
        # synchronous replay, no supervisor calls).
        self._on_handoff = on_handoff
        self._engine_kwargs = dict(engine_kwargs)
        self.wedge_timeout_s = (
            float(_flags.get_flag("serve_wedge_timeout_ms"))
            if wedge_timeout_ms is None else float(wedge_timeout_ms)) / 1e3
        self.max_restarts = (int(_flags.get_flag("serve_max_restarts"))
                             if max_restarts is None else int(max_restarts))
        self._restart_policy = restart_policy or _retry.RetryPolicy(
            base_delay=0.05, max_delay=2.0, max_attempts=3,
            retry_on=(Exception,))
        self._restart_deadline_s = float(restart_deadline_s)
        self._poll_s = float(poll_s)
        self.restarts = 0
        self.replayed = 0
        self._lock = threading.RLock()
        self._closed = False
        self._gen = 0
        self._work = threading.Event()
        self._engine = self._build()
        self._loop_thread = self._start_loop(self._gen, self._engine)
        self._watch_thread = threading.Thread(
            target=self._watch, name="pt-serve-watchdog", daemon=True)
        self._watch_thread.start()

    def _build(self) -> ServingEngine:
        # NOTE: the supervisor does NOT arm a per-dispatch stall_guard —
        # a threading.Timer per few-ms decode step is real thread churn
        # on the hot path. The watchdog emits the equivalent stall
        # record itself when it declares a wedge (same site, same
        # deadline); engines still honor the global stall_timeout_ms
        # flag like every other guarded plane.
        return ServingEngine(self._cfg, self._weights,
                             **self._engine_kwargs)

    def _start_loop(self, gen: int, eng: ServingEngine):
        t = threading.Thread(target=self._serve_loop, args=(gen, eng),
                             name=f"pt-serve-loop-{eng.engine_id}",
                             daemon=True)
        t.start()
        return t

    # --- public surface ---

    @property
    def engine(self) -> ServingEngine:
        with self._lock:
            return self._engine

    @property
    def state(self) -> str:
        with self._lock:
            return "closed" if self._closed else self._engine.state

    def submit(self, *args, **kwargs) -> ServeRequest:
        """Enqueue onto the CURRENT engine; a submit racing a restart
        retries onto the rebuilt one. QueueFull / DeadlineUnmeetable
        propagate (overload is the caller's signal, not the
        supervisor's problem)."""
        deadline = time.monotonic() + max(10.0, self._restart_deadline_s)
        while True:
            with self._lock:
                if self._closed:
                    raise EngineClosed("submit() on a closed supervisor")
                eng = self._engine
            try:
                req = eng.submit(*args, **kwargs)
            except (EngineFailed, EngineClosed):
                with self._lock:
                    if self._closed:
                        raise
                    current = self._engine
                if current is eng and not eng._failed:
                    # the engine is draining/closed by an EXPLICIT
                    # drain, not mid-replacement: fail fast instead of
                    # spinning the retry window
                    raise
                if time.monotonic() > deadline:
                    raise
                time.sleep(self._poll_s)
                continue
            self._work.set()
            return req

    def busy(self) -> bool:
        return self.engine.busy()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admissions and wait for the loop thread to finish the
        in-flight set (re-applied to the rebuilt engine if a restart
        lands mid-drain)."""
        t0 = time.perf_counter()
        while True:
            eng = self.engine
            eng.request_drain()
            self._work.set()
            if not eng.busy() and eng is self.engine:
                return True
            if time.perf_counter() - t0 > timeout_s:
                return False
            time.sleep(self._poll_s)

    def enqueue_replay(self, req: ServeRequest) -> bool:
        """Fleet failover intake: accept an already-admitted request
        harvested from ANOTHER replica. Bypasses backpressure and
        admission control exactly like the supervised-restart replay
        path — the request was admitted once; greedy decode keeps the
        replayed stream byte-identical. Returns False (handle
        untouched) when this supervisor cannot take it, so the router
        can try the next survivor."""
        with self._lock:
            if self._closed:
                return False
            eng = self._engine
            if eng._closed or eng._failed:
                # mid-replacement: let the router retry rather than
                # racing the rebuilt engine's installation
                return False
            self.replayed += 1
        eng._enqueue_replay(req)
        self._work.set()
        # a fault racing the intake can still finish the handle
        # 'error'; outcome-less means the engine owns it now
        return req.outcome is None or req.done

    def harvest(self) -> List[ServeRequest]:
        """Fleet failover: terminally stop this supervisor and TAKE
        every pending (outcome-less) request instead of finishing it —
        in-flight first (their admission order), then the queue — so
        the router can replay the set on surviving replicas (partial
        outputs intact until each replay re-prefills). Idempotent: a
        second call returns []."""
        with self._lock:
            if self._closed:
                return []
            self._closed = True
            self._gen += 1  # stops the loop thread at its next check
            eng = self._engine
        self._work.set()
        for t in (self._loop_thread, self._watch_thread):
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        pending = eng._harvest_for_replay()
        try:
            eng.close(drain_timeout_s=0.0)
        except Exception:
            pass
        return pending

    def handoff(self, timeout_s: float = 30.0) -> List[ServeRequest]:
        """Rolling-rollout drain: stop admissions, immediately take the
        queued-but-unadmitted requests (the router re-homes them on
        another replica instead of finishing them 'drained'), give the
        loop thread up to ``timeout_s`` to finish the in-flight set,
        then harvest whatever remains. Terminal for this supervisor;
        returns every request the caller must re-home (possibly [])."""
        t0 = time.perf_counter()
        moved: List[ServeRequest] = []
        swept = set()
        while True:
            with self._lock:
                if self._closed:
                    break
                eng = self._engine
            if id(eng) not in swept:
                # re-applied to the rebuilt engine when a supervised
                # restart lands mid-handoff (its replay intake holds
                # the old engine's queue)
                swept.add(id(eng))
                moved.extend(eng.handoff_queued())
                self._work.set()
            if not eng.busy() and eng is self.engine:
                break
            if time.perf_counter() - t0 > timeout_s:
                break
            time.sleep(self._poll_s)
        moved.extend(self.harvest())
        return moved

    def close(self, drain_timeout_s: float = 30.0):
        """Drain, stop the loop + watchdog threads, close the engine.
        Every still-pending handle is finished — result() never hangs
        on a closed supervisor."""
        with self._lock:
            if self._closed:
                return
        self.drain(drain_timeout_s)
        with self._lock:
            self._closed = True
            self._gen += 1  # stops the loop thread at its next check
            eng = self._engine
        self._work.set()
        for t in (self._loop_thread, self._watch_thread):
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        eng.close(drain_timeout_s=0.0)

    def stats(self) -> Dict:
        eng = self.engine
        return {
            "supervised": True,
            "state": self.state,
            "restarts": self.restarts,
            "max_restarts": self.max_restarts,
            # intakes, not admissions: pt_serve_requests_replayed_total
            # is the re-prefill count and can lag this by replays that
            # died (drained/errored) before reaching prefill
            "replays_enqueued": self.replayed,
            "wedge_timeout_ms": self.wedge_timeout_s * 1e3,
            "engine": eng.stats(),
        }

    # --- the supervised loop + watchdog ---

    def _serve_loop(self, gen: int, eng: ServingEngine):
        while True:
            with self._lock:
                if self._closed or gen != self._gen:
                    return
            try:
                if eng.busy():
                    eng.step()
                else:
                    self._work.wait(self._poll_s)
                    self._work.clear()
            except EngineClosed:
                return
            except Exception as e:
                if eng._failed:
                    self._on_engine_failure(gen, eng, e)
                    return
                # non-fatal (e.g. a torn admission already surfaced on
                # its handle): the engine is healthy, keep serving
                warnings.warn(
                    f"supervised engine {eng.engine_id}: non-fatal "
                    f"serving error: {type(e).__name__}: {e}",
                    RuntimeWarning)

    def _watch(self):
        while True:
            time.sleep(self._poll_s)
            with self._lock:
                if self._closed:
                    return
                eng, gen = self._engine, self._gen
            # wedge detection only once the decode graph is captured and
            # no call lowers or captures (see _wedge_armed); host state
            # only: this thread makes no CUDA call while the loop thread
            # may be capturing
            if (not eng._failed and not eng._closed
                    and eng._wedge_armed() and eng.busy()
                    and eng.heartbeat_age_s() > self.wedge_timeout_s):
                if _monitor.enabled():
                    # the stall record a per-dispatch stall_guard would
                    # have produced, emitted once at declaration (the
                    # monitor helper is same-package and never raises)
                    _monitor._record_stall(
                        "serve.decode", self.wedge_timeout_s * 1e3,
                        self._loop_thread.name, ())
                with self._lock:
                    if self._closed or gen != self._gen:
                        continue
                    self._restart_locked(
                        eng, reason=f"wedged (heartbeat "
                        f"{eng.heartbeat_age_s() * 1e3:.0f} ms old)")

    def _on_engine_failure(self, gen: int, eng: ServingEngine, exc):
        with self._lock:
            if self._closed or gen != self._gen:
                return
            self._restart_locked(
                eng, reason=f"{type(exc).__name__}: {exc}")

    def _fail_pending_locked(self, pending: List[ServeRequest]):
        """Terminal-failure epilogue: offer the pending set to the
        fleet (``on_handoff``) before failing it — a router with
        surviving replicas turns a dead supervisor into failovers
        instead of request errors. Caller holds self._lock."""
        if pending and self._on_handoff is not None:
            try:
                if self._on_handoff(list(pending)):
                    return
            except Exception as e:  # the fleet must not kill teardown
                warnings.warn(
                    f"serving supervisor: on_handoff failed "
                    f"({type(e).__name__}: {e}); failing "
                    f"{len(pending)} pending request(s)",
                    RuntimeWarning)
        for r in pending:
            r._finish("error")

    def _restart_locked(self, old: ServingEngine, reason: str):
        """Tear down + rebuild + replay. Caller holds self._lock."""
        pending = old._harvest_for_replay()
        if self.restarts >= self.max_restarts:
            warnings.warn(
                f"serving supervisor: restart budget "
                f"({self.max_restarts}) exhausted ({reason}); failing "
                f"{len(pending)} pending request(s)", RuntimeWarning)
            self._fail_pending_locked(pending)
            self._closed = True
            self._gen += 1
            try:
                old.close(drain_timeout_s=0.0)
            except Exception:
                pass
            return
        self.restarts += 1
        _M_RESTARTS.inc()
        warnings.warn(
            f"serving supervisor: restarting engine {old.engine_id} "
            f"({reason}); replaying {len(pending)} request(s)",
            RuntimeWarning)
        try:
            old.close(drain_timeout_s=0.0)
        except Exception:
            pass
        try:
            # rebuild under the retry budget (the new engine lowers and
            # captures its programs on its first calls)
            new = _retry.call(self._build, site="serve.restart",
                              policy=self._restart_policy,
                              retry_on=(Exception,),
                              deadline_s=self._restart_deadline_s)
        except Exception as e:
            warnings.warn(
                f"serving supervisor: engine rebuild failed after "
                f"retries ({type(e).__name__}: {e}); failing "
                f"{len(pending)} pending request(s)", RuntimeWarning)
            self._fail_pending_locked(pending)
            self._closed = True
            self._gen += 1
            return
        self._gen += 1
        self._engine = new
        for r in pending:
            # self.replayed counts replay INTAKES; the token wipe and
            # the pt_serve_requests_replayed_total tick happen at the
            # new engine's ADMISSION (_reset_for_replay), so a replay
            # that never reaches prefill keeps its partial output and
            # the metric counts only true re-prefills
            self.replayed += 1
            new._enqueue_replay(r)
        self._work.set()
        self._loop_thread = self._start_loop(self._gen, new)


# how long close() waits for an executor call in progress before it
# retires the executor without freeing its graphs
_CLOSE_DISPATCH_WAIT_S = 5.0

_ENGINES: "weakref.WeakSet[ServingEngine]" = weakref.WeakSet()


def _publish_gauges():
    """Refresh the process-wide queue/slot/brownout gauges as SUMS
    across live engines — per-engine .set() calls would let an idle
    engine zero out a saturated neighbor's reading (the per-engine
    split lives in /serve's stats rows)."""
    engines = list(_ENGINES)
    _M_QUEUE_DEPTH.set(sum(len(e._queue) for e in engines))
    _M_SLOTS_ACTIVE.set(sum(
        1 for e in engines for s in e._slots
        if s.request is not None and s.request.outcome is None))
    _M_BROWNOUT.set(sum(1 for e in engines if e.brownout))


def serve(cfg, weights, *, supervised: bool = False, **kwargs):
    """Predictor-style front end: build a ServingEngine over ``weights``
    (a Scope, a Predictor, or a saved inference-model directory — the
    int8 PTQ artifact deploys dequantized). ``supervised=True`` wraps
    it in an EngineSupervisor (self-driving decode loop + watchdog +
    warm restart). See ServingEngine for the geometry/SLO knobs."""
    if supervised:
        return EngineSupervisor(cfg, weights, **kwargs)
    return ServingEngine(cfg, weights, **kwargs)


def summary() -> Dict:
    """The /serve route payload: one stats row per live engine."""
    engines = [e.stats() for e in list(_ENGINES)]
    return {
        "engines": engines,
        "engine_count": len(engines),
        "tokens_total": int(_M_TOKENS.value()),
        "decode_steps_total": int(_M_DECODE_STEPS.value()),
        "engine_restarts_total": int(_M_RESTARTS.value()),
        "requests_replayed_total": int(_M_REPLAYED.value()),
        "token_latency_s": {
            label: _M_TOKEN_SECONDS.quantile(q)
            for label, q in _monitor.QUANTILE_LABELS
        },
        "ttft_s": {
            label: _M_TTFT_SECONDS.quantile(q)
            for label, q in _monitor.QUANTILE_LABELS
        },
    }
