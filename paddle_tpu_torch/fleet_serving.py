"""Fleet front door: routed multi-replica serving behind one address.

The port of the JAX package's ``fleet_serving`` module. A
``ServingFleet`` router/scheduler owns N ``EngineSupervisor`` replicas
behind a single ``submit()``, so a replica dying, wedging, being
upgraded, or being added under load is invisible to every in-flight
request. Its replicas run on ``CUDAPlace(0)``, all on one card, unless
the caller passes ``place=CPUPlace()``.

- **Load/deadline-aware routing**: each submit scores the serving
  replicas with the signals the replica plane already measures — the
  admission per-token EWMA times the remaining-token backlog (the same
  arithmetic as the engine's own ``_estimate_first_token_s``), plus an
  EWMA of the replica's recently MEASURED queue waits (the
  ``queue_wait`` deadline-attribution phase, read off terminal
  requests) — and picks the lowest estimated time-to-first-token. A
  replica that refuses (QueueFull / DeadlineUnmeetable / racing a
  restart) just moves the request to the next candidate; the fleet
  sheds only when EVERY replica refuses
  (``pt_fleet_serve_shed_total``).
- **Failover replay**: the router journals every admitted request
  (the handle itself carries the prompt, sampling params, and tokens
  already streamed). When a replica crashes, wedges past its
  supervisor's watchdog budget, or exhausts ``serve_max_restarts``
  (the supervisor's ``on_handoff`` seam), its pending requests are
  harvested and re-enqueued on survivors through the same replay
  intake a supervised restart uses. Greedy decode is deterministic, so
  the replay re-derives the byte-identical stream; the fleet handle
  (``FleetRequest``) snapshots the already-streamed tokens before the
  wipe-at-re-prefill and serves a MONOTONE view — the client-visible
  stream continues without duplication or gap, on one trace tid
  (the ServeRequest handle, and with it the pinned track, survives).
- **Autoscaling** (``serve_fleet_autoscale``): sustained aggregate
  queue saturation over a window of pump ticks spins up a replica, and
  sustained idleness drains-then-retires one. The port has no compile
  cache (the JAX fleet's spin-up is warm through it): a new replica
  lowers its programs on their first calls and captures each one's CUDA
  graph on the second (prefill and decode: two lowerings, two captures,
  and a third pair for the slot scrub if a slot is ever evicted). Each
  capture holds the process-wide capture gate alone
  (core/lowering.py ``GATE``), so the serving replicas pause for it and
  are not declared wedged meanwhile; a spin-up costs the new replica's
  eager first calls and its captures, and its peers' pauses. A custom
  ``replica_factory`` is the seam for replicas elsewhere; the default
  factory builds local supervisors.
- **Zero-downtime rolling rollout**: ``rollout(new_weights)`` bumps
  the fleet generation and rotates replicas ONE at a time —
  replacement first (it lowers and captures as a spin-up does), then
  the old replica drains: it admits nothing new, finishes its
  in-flight set within ``serve_fleet_handoff_timeout_ms``, and hands
  queued + leftover requests to survivors instead of rejecting them.
  Every response carries the generation tag of the replica that served
  it (``FleetRequest.generation``), so mixed-fleet serving is
  detectable request by request.

Chaos plan sites (faults.py): ``router.route`` (submit-path failure),
``router.replica_crash`` (hard-kill the N-th replica —
``raise(replica=N)`` — at a deterministic pump tick),
``router.handoff`` (tear a rolling-rollout drain mid-handoff).

The router's pump survives any error of a tick as a warning, as the JAX
pump does; the port also counts each one (``stats()["pump_errors"]``),
so a failure the warning reports cannot go unseen by a caller.

Observability: ``pt_fleet_serve_*`` metrics ride the monitor registry
and the ``/fleet`` route grows a ``serving_fleet`` section (per-replica
state, queue depth, generation, last-heartbeat age) via
``fleet_view()``.
"""

from __future__ import annotations

import collections
import itertools
import re
import threading
import time
import warnings
import weakref
from typing import Dict, List, Optional, Sequence

from paddle_tpu_torch import faults as _faults
from paddle_tpu_torch import flags as _flags
from paddle_tpu_torch import monitor as _monitor
from paddle_tpu_torch import serving as _serving

# --- telemetry (no-ops while the 'telemetry' flag is off) ---

_M_REPLICAS = _monitor.gauge(
    "pt_fleet_serve_replicas",
    "serving-fleet replicas by lifecycle state (serving / draining)")
_M_ROUTED = _monitor.counter(
    "pt_fleet_serve_routed_total",
    "requests admitted through the fleet router (per-replica split in "
    "the /fleet serving_fleet section)")
_M_SHED = _monitor.counter(
    "pt_fleet_serve_shed_total",
    "fleet submits refused by EVERY replica, by kind (queue_full / "
    "deadline / no_replica)")
_M_FAILOVERS = _monitor.counter(
    "pt_fleet_serve_failovers_total",
    "replicas removed from the fleet with requests re-homed, by cause "
    "(crash = chaos kill or wedge past the supervisor, giveup = "
    "restart budget exhausted, handoff = rollout/retire drain)")
_M_REPLAYED = _monitor.counter(
    "pt_fleet_serve_replayed_total",
    "requests re-homed onto a surviving replica's replay intake after "
    "a failover or drain handoff (greedy decode keeps the client-"
    "visible stream byte-identical)")
_M_SCALE = _monitor.counter(
    "pt_fleet_serve_scale_total",
    "autoscaler actions by direction (up = warm replica spin-up under "
    "sustained queue saturation, down = drain-then-retire under "
    "sustained idleness)")
_M_ROLLOUTS = _monitor.counter(
    "pt_fleet_serve_rollouts_total",
    "completed rolling weight rollouts (every replica rotated to the "
    "new generation with zero rejected-for-rollout requests)")
_M_GENERATION = _monitor.gauge(
    "pt_fleet_serve_generation",
    "current fleet weight generation (responses tag the generation "
    "that served them, so a mixed fleet mid-rollout is detectable)")

# chaos hooks — see BUILTIN_SITES in faults.py for the drill semantics
_F_ROUTE = _faults.site("router.route")
_F_CRASH = _faults.site("router.replica_crash")
_F_HANDOFF = _faults.site("router.handoff")

# the chaos plan's raise(replica=N) attribution (mirrors the serving
# plane's slot-hint protocol)
_REPLICA_HINT_RE = re.compile(r"replica\s*[=:]\s*(\d+)")

_FLEETS: "weakref.WeakSet[ServingFleet]" = weakref.WeakSet()


class FleetClosed(RuntimeError):
    pass


class NoReplicaAvailable(RuntimeError):
    """Raised by submit() when the fleet has no serving replica at all
    (every replica draining/retired and autoscaling off)."""


class FleetRequest:
    """Fleet-level request handle: wraps the ONE ServeRequest that
    survives failover (the handle — and with it the trace tid, the
    original submit timestamp, and the partial output — is re-homed
    across replicas, never recreated).

    ``tokens`` is the client-visible stream: a monotone view over the
    underlying handle. The router snapshots the already-streamed
    tokens before a replay's wipe-at-re-prefill; because greedy decode
    re-derives the identical prefix, the view never shrinks and never
    duplicates — the stream continues exactly where the dead replica
    left it."""

    __slots__ = ("_sr", "replica_id", "generation", "failovers",
                 "_streamed")

    def __init__(self, sr: "_serving.ServeRequest", replica_id: int,
                 generation: int):
        self._sr = sr
        self.replica_id = replica_id    # replica currently serving it
        self.generation = generation    # weight generation tag
        self.failovers = 0              # fleet-level re-homes
        self._streamed: List[int] = []

    def _note_streamed(self):
        """Snapshot the tokens the client has already seen — called by
        the router BEFORE a replay can wipe them at re-prefill."""
        cur = list(self._sr.tokens)
        if len(cur) > len(self._streamed):
            self._streamed = cur

    @property
    def tokens(self) -> List[int]:
        cur = list(self._sr.tokens)
        streamed = self._streamed
        return cur if len(cur) >= len(streamed) else list(streamed)

    @property
    def done(self) -> bool:
        return self._sr.done

    @property
    def outcome(self) -> Optional[str]:
        return self._sr.outcome

    @property
    def trace_id(self) -> str:
        return self._sr.trace_id

    @property
    def trace_tid(self) -> Optional[int]:
        return self._sr.trace_tid

    @property
    def replays(self) -> int:
        return self._sr.replays

    @property
    def ttft_s(self) -> Optional[float]:
        return self._sr.ttft_s

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until terminal; returns the monotone token view."""
        self._sr.result(timeout)
        return self.tokens


class _Replica:
    """Router-side view of one EngineSupervisor replica."""

    __slots__ = ("id", "sup", "generation", "state", "routed",
                 "qwait_ewma_s", "created_ts")

    def __init__(self, rid: int, sup: "_serving.EngineSupervisor",
                 generation: int):
        self.id = rid
        self.sup = sup
        self.generation = generation
        self.state = "serving"          # serving | draining
        self.routed = 0
        # EWMA of MEASURED queue waits off this replica's terminal
        # requests — the deadline-attribution phase feeding back
        # into routing
        self.qwait_ewma_s = 0.0
        self.created_ts = time.perf_counter()


class ServingFleet:
    """N supervised serving replicas behind one submit() address.

    ``replica_factory`` (optional) builds one replica's supervisor:
    ``factory(cfg, weights, on_handoff=..., **engine_kwargs) ->
    EngineSupervisor``-shaped object. The default builds a local
    EngineSupervisor on ``engine_kwargs["place"]`` (the card when not
    given). A spin-up or rollout replacement lowers and captures its
    programs afresh (see the module docstring)."""

    def __init__(self, cfg, weights, *, replicas: int = 2,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 autoscale: Optional[bool] = None,
                 handoff_timeout_s: Optional[float] = None,
                 poll_s: float = 0.02,
                 replica_factory=None, **engine_kwargs):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self._cfg = cfg
        self._weights = weights
        self._engine_kwargs = dict(engine_kwargs)
        self._factory = replica_factory
        self._poll_s = float(poll_s)
        self.min_replicas = (
            int(_flags.get_flag("serve_fleet_min_replicas"))
            if min_replicas is None else int(min_replicas))
        self.max_replicas = (
            int(_flags.get_flag("serve_fleet_max_replicas"))
            if max_replicas is None else int(max_replicas))
        self._autoscale = autoscale
        self.handoff_timeout_s = (
            float(_flags.get_flag("serve_fleet_handoff_timeout_ms"))
            / 1e3 if handoff_timeout_s is None
            else float(handoff_timeout_s))
        self.generation = 0
        self.failovers = 0
        self.replayed = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.rollouts = 0
        self._shed = 0
        # errors of a pump tick, each swallowed as a warning
        self.pump_errors = 0
        self.last_pump_error: Optional[str] = None
        self._rid = itertools.count(1)
        self._lock = threading.RLock()
        self._replicas: "collections.OrderedDict[int, _Replica]" = \
            collections.OrderedDict()
        self._closed = False
        # journal of live admitted requests: sr.id -> FleetRequest.
        # Guarded by its OWN lock — the supervisor on_handoff callback
        # runs under the supervisor's lock and must never wait on the
        # fleet lock (lock order there is supervisor -> journal only).
        self._journal_lock = threading.Lock()
        self._journal: Dict[int, FleetRequest] = {}
        # requests handed off by a terminally-failing supervisor
        # (deque appends are atomic; drained by the pump thread)
        self._orphans: "collections.deque" = collections.deque()
        self._saturated_ticks = 0
        self._idle_ticks = 0
        for _ in range(replicas):
            self._spawn_replica()
        _FLEETS.add(self)
        self._pump_thread = threading.Thread(
            target=self._pump, name="pt-fleet-router", daemon=True)
        self._pump_thread.start()

    # --- replica lifecycle ---

    def _build_supervisor(self):
        factory = self._factory
        if factory is None:
            factory = _serving.EngineSupervisor
        return factory(self._cfg, self._weights,
                       on_handoff=self._accept_orphans,
                       **self._engine_kwargs)

    def _spawn_replica(self) -> _Replica:
        rep = _Replica(next(self._rid), self._build_supervisor(),
                       self.generation)
        with self._lock:
            self._replicas[rep.id] = rep
            self._publish_replicas_locked()
        return rep

    def _publish_replicas_locked(self):
        counts = {"serving": 0, "draining": 0}
        for rep in self._replicas.values():
            counts[rep.state] = counts.get(rep.state, 0) + 1
        _M_REPLICAS.replace(
            [({"state": state}, float(n))
             for state, n in sorted(counts.items())])

    def _remove_replica(self, rep: _Replica, cause: str):
        """Hard failover: harvest the replica's pending set and re-home
        it on survivors. The supervisor may already be closed (giveup
        path — its pending arrived through on_handoff)."""
        with self._lock:
            self._replicas.pop(rep.id, None)
            self._publish_replicas_locked()
        pending = rep.sup.harvest()
        self.failovers += 1
        _M_FAILOVERS.inc(labels={"cause": cause})
        warnings.warn(
            f"serving fleet: replica {rep.id} removed ({cause}); "
            f"re-homing {len(pending)} in-flight request(s)",
            RuntimeWarning)
        self._requeue(pending)

    # --- routing ---

    def _serving_replicas(self) -> List[_Replica]:
        with self._lock:
            return [r for r in self._replicas.values()
                    if r.state == "serving"]

    def _score(self, rep: _Replica) -> float:
        """Estimated time-to-first-token on this replica: the
        admission EWMA times the remaining-token backlog (queue +
        in-flight), plus the replica's measured queue-wait EWMA.
        Racy unlocked reads — this is a routing hint, the replica's
        own admission control is the authority."""
        try:
            eng = rep.sup.engine
        except Exception:
            return float("inf")
        ewma = eng._token_ewma_s or 0.0
        outstanding = 0
        with eng._lock:
            backlog = 0
            for r in eng._queue:
                backlog += r.max_new_tokens
                outstanding += 1
            for s in eng._slots:
                r = s.request
                if r is not None and r.outcome is None:
                    backlog += max(0, r.max_new_tokens - len(r.tokens))
                    outstanding += 1
        eta = ewma * (backlog / float(eng.slots) + 1.0)
        # the epsilon term spreads a COLD fleet (no EWMA yet — every
        # eta is 0) by outstanding request count instead of letting a
        # stable sort pile everything on the first replica
        return eta + rep.qwait_ewma_s + 1e-6 * outstanding

    def submit(self, src_ids: Sequence[int],
               src_pad=None, max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> FleetRequest:
        """Route one request onto the best serving replica. Tries
        replicas in ascending estimated-TTFT order; a refusal
        (QueueFull / DeadlineUnmeetable / racing a restart) moves on
        to the next. Raises the LAST refusal only when every serving
        replica refused (the fleet-level shed)."""
        if self._closed:
            raise FleetClosed("submit() on a closed fleet")
        _F_ROUTE.hit()
        candidates = sorted(self._serving_replicas(), key=self._score)
        if not candidates:
            _M_SHED.inc(labels={"kind": "no_replica"})
            self._shed += 1
            raise NoReplicaAvailable(
                "no serving replica (all draining or retired)")
        last: Optional[BaseException] = None
        for rep in candidates:
            try:
                sr = rep.sup.submit(
                    src_ids, src_pad=src_pad,
                    max_new_tokens=max_new_tokens,
                    deadline_ms=deadline_ms)
            except (_serving.QueueFull, _serving.DeadlineUnmeetable,
                    _serving.EngineClosed,
                    _serving.EngineFailed) as e:
                last = e
                continue
            rep.routed += 1
            fr = FleetRequest(sr, rep.id, rep.generation)
            with self._journal_lock:
                self._journal[sr.id] = fr
            _M_ROUTED.inc()
            return fr
        self._shed += 1
        _M_SHED.inc(labels={
            "kind": ("queue_full"
                     if isinstance(last, _serving.QueueFull)
                     else "deadline"
                     if isinstance(last, _serving.DeadlineUnmeetable)
                     else "no_replica")})
        raise last

    # --- failover replay ---

    def _accept_orphans(self, requests) -> bool:
        """EngineSupervisor on_handoff seam: a terminally-failing
        supervisor offers its pending set. Runs UNDER the supervisor's
        lock — only snapshot + enqueue here; the pump thread does the
        actual re-homing."""
        if self._closed:
            return False
        with self._journal_lock:
            for sr in requests:
                fr = self._journal.get(sr.id)
                if fr is not None:
                    fr._note_streamed()
        self._orphans.extend(requests)
        return True

    def _requeue(self, pending) -> int:
        """Re-home harvested requests on surviving replicas through the
        supervised-replay intake. Requests that cannot land anywhere
        finish 'error' (result() must never hang on a dead fleet)."""
        moved = 0
        for sr in pending:
            if sr.outcome is not None:
                continue
            with self._journal_lock:
                fr = self._journal.get(sr.id)
            if fr is not None:
                fr._note_streamed()
            placed = False
            for rep in sorted(self._serving_replicas(),
                              key=self._score):
                if rep.sup.enqueue_replay(sr):
                    placed = True
                    moved += 1
                    self.replayed += 1
                    _M_REPLAYED.inc()
                    if fr is not None:
                        fr.failovers += 1
                        fr.replica_id = rep.id
                        fr.generation = rep.generation
                    break
            if not placed and sr.outcome is None:
                sr._finish("error")
        return moved

    # --- the router pump ---

    def _pump(self):
        while not self._closed:
            try:
                self._pump_tick()
            except Exception as e:  # the pump must survive anything
                self.pump_errors += 1
                self.last_pump_error = f"{type(e).__name__}: {e}"[:500]
                warnings.warn(
                    f"serving fleet: pump error "
                    f"{type(e).__name__}: {e}", RuntimeWarning)
            time.sleep(self._poll_s)

    def _pump_tick(self):
        # 1. the kill-one-replica chaos drill
        try:
            _F_CRASH.hit()
        except _faults.InjectedFault as e:
            self._chaos_kill(e)
        # 2. dead-supervisor detection: a supervisor that went
        # terminal on its own (budget exhausted, rebuild failed) — its
        # pending set already arrived via on_handoff; drop the corpse
        for rep in list(self._serving_replicas()):
            if rep.sup.state == "closed":
                with self._lock:
                    self._replicas.pop(rep.id, None)
                    self._publish_replicas_locked()
                self.failovers += 1
                _M_FAILOVERS.inc(labels={"cause": "giveup"})
        # 3. re-home orphans handed off by terminal supervisors
        orphans = []
        while True:
            try:
                orphans.append(self._orphans.popleft())
            except IndexError:
                break
        if orphans:
            self._requeue(orphans)
        # 4. prune the journal + feed measured queue waits back into
        # the routing score
        self._prune_journal()
        # 5. autoscale
        auto = (self._autoscale if self._autoscale is not None
                else bool(_flags.get_flag("serve_fleet_autoscale")))
        if auto:
            self.autoscale_tick()

    def _chaos_kill(self, exc):
        live = self._serving_replicas()
        if not live:
            return
        m = _REPLICA_HINT_RE.search(str(exc))
        idx = int(m.group(1)) if m else 0
        live.sort(key=lambda r: r.id)
        if idx >= len(live):
            warnings.warn(
                f"serving fleet: chaos kill hint replica={idx} out of "
                f"range ({len(live)} live); killing replica 0",
                RuntimeWarning)
            idx = 0
        self._remove_replica(live[idx], cause="crash")

    def _prune_journal(self):
        with self._journal_lock:
            done = [(rid, fr) for rid, fr in self._journal.items()
                    if fr.done]
            for rid, _fr in done:
                del self._journal[rid]
        if not done:
            return
        with self._lock:
            reps = dict(self._replicas)
        for _rid, fr in done:
            rep = reps.get(fr.replica_id)
            qw = fr._sr.queue_wait_s
            if rep is not None and qw is not None:
                rep.qwait_ewma_s += 0.2 * (qw - rep.qwait_ewma_s)

    # --- autoscaling ---

    def autoscale_tick(self) -> Optional[str]:
        """One deterministic autoscaler evaluation (the pump calls
        this when ``serve_fleet_autoscale`` is on; tests call it
        directly). Returns 'up' / 'down' when it acted."""
        serving = self._serving_replicas()
        if not serving:
            return None
        queued = capacity = 0
        busy = False
        for rep in serving:
            try:
                eng = rep.sup.engine
            except Exception:
                continue
            with eng._lock:
                queued += len(eng._queue)
            capacity += eng.queue_depth
            busy = busy or rep.sup.busy()
        factor = float(
            _flags.get_flag("serve_fleet_scale_up_queue_factor"))
        window = int(_flags.get_flag("serve_fleet_autoscale_window"))
        idle_after = int(
            _flags.get_flag("serve_fleet_scale_down_idle_ticks"))
        if capacity and queued >= factor * capacity:
            self._saturated_ticks += 1
            self._idle_ticks = 0
            if (self._saturated_ticks >= window
                    and len(serving) < self.max_replicas):
                self._saturated_ticks = 0
                self._spawn_replica()
                self.scale_ups += 1
                _M_SCALE.inc(labels={"direction": "up"})
                return "up"
            return None
        self._saturated_ticks = 0
        if busy or queued:
            self._idle_ticks = 0
            return None
        self._idle_ticks += 1
        if (self._idle_ticks >= idle_after
                and len(serving) > self.min_replicas):
            self._idle_ticks = 0
            # retire the newest replica (oldest keep their warm EWMAs)
            victim = max(serving, key=lambda r: r.id)
            self._retire_replica(victim, cause="handoff")
            self.scale_downs += 1
            _M_SCALE.inc(labels={"direction": "down"})
            return "down"
        return None

    # --- drain handoff + rolling rollout ---

    def _retire_replica(self, rep: _Replica, cause: str):
        """Drain-then-retire: the replica admits nothing new (router
        skips it), finishes its in-flight set within the handoff
        budget, and hands queued + leftover requests to survivors. A
        torn handoff (router.handoff raise) degrades to the hard
        failover path — the requests still re-home."""
        with self._lock:
            if rep.id not in self._replicas:
                return
            rep.state = "draining"
            self._publish_replicas_locked()
        try:
            _F_HANDOFF.hit()
            moved = rep.sup.handoff(timeout_s=self.handoff_timeout_s)
        except _faults.InjectedFault as e:
            warnings.warn(
                f"serving fleet: drain handoff of replica {rep.id} "
                f"torn by chaos plan ({e}); hard-harvesting",
                RuntimeWarning)
            moved = rep.sup.harvest()
        with self._lock:
            self._replicas.pop(rep.id, None)
            self._publish_replicas_locked()
        if moved:
            self.failovers += 1
            _M_FAILOVERS.inc(labels={"cause": cause})
        self._requeue(moved)

    def rollout(self, new_weights, *,
                drain_timeout_s: Optional[float] = None) -> Dict:
        """Zero-downtime rolling weight rollout: bump the fleet
        generation, then rotate replicas one at a time — spawn the
        replacement FIRST (so capacity never dips below N; it lowers and
        captures its programs under the capture gate while its peers
        serve), then drain the old replica and re-home
        whatever it could not finish. No request is rejected for the
        rollout's sake; responses carry the generation that served
        them, so the mixed fleet mid-rollout is observable."""
        if self._closed:
            raise FleetClosed("rollout() on a closed fleet")
        if drain_timeout_s is not None:
            budget = float(drain_timeout_s)
        else:
            budget = self.handoff_timeout_s
        with self._lock:
            self.generation += 1
            gen = self.generation
            self._weights = new_weights
            old = [r for r in self._replicas.values()
                   if r.generation < gen]
        _M_GENERATION.set(float(gen))
        rotated = 0
        for rep in old:
            with self._lock:
                if self._closed or rep.id not in self._replicas:
                    continue
            self._spawn_replica()  # joins at the NEW generation
            self._retire_replica(rep, cause="handoff")
            rotated += 1
        self.rollouts += 1
        _M_ROLLOUTS.inc()
        return {"generation": gen, "replicas_rotated": rotated,
                "replicas": len(self._replicas)}

    # --- lifecycle + observability ---

    def busy(self) -> bool:
        if self._orphans:
            return True
        with self._lock:
            reps = list(self._replicas.values())
        return any(rep.sup.busy() for rep in reps)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop nothing fleet-wide (submits keep routing); wait for
        every replica to go idle."""
        t0 = time.perf_counter()
        while self.busy():
            if time.perf_counter() - t0 > timeout_s:
                return False
            time.sleep(self._poll_s)
        return True

    def close(self, drain_timeout_s: float = 30.0):
        """Drain every replica, stop the pump, close supervisors.
        Every still-pending handle is finished — result() never hangs
        on a closed fleet."""
        if self._closed:
            return
        self.drain(drain_timeout_s)
        self._closed = True
        if self._pump_thread is not threading.current_thread():
            self._pump_thread.join(timeout=5.0)
        with self._lock:
            reps = list(self._replicas.values())
            self._replicas.clear()
            self._publish_replicas_locked()
        for rep in reps:
            try:
                rep.sup.close(drain_timeout_s=0.0)
            except Exception:
                pass
        # orphans that raced the shutdown: nobody will replay them
        while True:
            try:
                sr = self._orphans.popleft()
            except IndexError:
                break
            if sr.outcome is None:
                sr._finish("error")
        with self._journal_lock:
            self._journal.clear()
        _FLEETS.discard(self)

    def stats(self) -> Dict:
        """One JSON-able fleet row for the /fleet route."""
        with self._lock:
            reps = list(self._replicas.values())
        rows = []
        for rep in reps:
            try:
                eng = rep.sup.engine
                row = {
                    "replica": rep.id,
                    "engine_id": eng.engine_id,
                    "state": (rep.state if rep.state == "draining"
                              else rep.sup.state),
                    "generation": rep.generation,
                    "queue_depth": len(eng._queue),
                    "slots_active": int(eng._active_mask().sum()),
                    "heartbeat_age_ms": round(
                        eng.heartbeat_age_s() * 1e3, 1),
                    "routed": rep.routed,
                    "restarts": rep.sup.restarts,
                    "qwait_ewma_ms": round(
                        rep.qwait_ewma_s * 1e3, 3),
                }
            except Exception as e:  # a replica mid-teardown
                row = {"replica": rep.id, "state": "unknown",
                       "error": f"{type(e).__name__}: {e}"}
            rows.append(row)
        with self._journal_lock:
            in_flight = len(self._journal)
        return {
            "replicas": rows,
            "replica_count": len(rows),
            "queue_depth": sum(r.get("queue_depth", 0) for r in rows),
            "generation": self.generation,
            "in_flight": in_flight,
            "orphans_pending": len(self._orphans),
            "failovers": self.failovers,
            "replayed": self.replayed,
            "shed": self._shed,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "rollouts": self.rollouts,
            "pump_errors": self.pump_errors,
            "last_pump_error": self.last_pump_error,
        }


def fleet_view() -> Optional[Dict]:
    """The /fleet route's ``serving_fleet`` section: one stats row per
    live ServingFleet, or None when no fleet is up (the route then
    serves the training-fleet view unchanged)."""
    fleets = [f.stats() for f in list(_FLEETS) if not f._closed]
    if not fleets:
        return None
    return {"fleets": fleets, "fleet_count": len(fleets)}


def serve_fleet(cfg, weights, *, replicas: int = 2,
                **kwargs) -> ServingFleet:
    """Front end mirroring serving.serve(): build a routed fleet of
    ``replicas`` supervised engines over shared weights."""
    return ServingFleet(cfg, weights, replicas=replicas, **kwargs)
