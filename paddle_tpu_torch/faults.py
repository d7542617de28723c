"""Deterministic fault injection: named sites armed by a seeded plan.

The port's copy of the JAX package's ``faults`` module: the same plan
grammar, the same ``BUILTIN_SITES`` table and the same seeded streams,
so one plan string drills both packages alike. Sites whose module the
port has not yet (fleet, compile cache) are declared at the end of this
module, so arming one binds its rules as in the JAX package and the site
never fires.

Chaos engineering for the fault-tolerance plane (SURVEY.md section 5):
production code declares *sites* — module-level
``_F_X = faults.site("ckpt.write_shards")`` objects whose ``hit()`` sits
at the failure-prone point — and a *plan* arms specific sites to fail in
a specific way at a specific hit. Because triggering is a pure function
of (plan, seed, per-site hit count), a chaos run reproduces its fault
sequence exactly: the same plan string replays the same crash.

Plan syntax (the ``fault_plan`` flag / ``PT_FLAGS_fault_plan`` env)::

    plan    := entry (';' entry)*
    entry   := site ':' action '@' trigger (',' trigger)*
    action  := 'raise' | 'raise(message)'
             | 'delay(seconds)'        -- sleep, simulating a slow dep
             | 'truncate(bytes)'       -- torn write: truncate the file
                                          the site passed via hit(path=)
    trigger := N        -- fire at the Nth hit of the site (1-based)
             | 'p' F    -- fire each hit with probability F, drawn from
                           a per-site stream seeded by the fault_seed
                           flag (deterministic given seed + hit order)

Disabled path contract (same as monitor.py): while no plan is armed,
``Site.hit()`` is one module-boolean check and allocates nothing —
sites are safe to leave in hot code.

Every injected fault counts into ``pt_fault_injected_total{site=}`` and
appends a record (site, hit number, action) readable via ``records()``.
"""

from __future__ import annotations

import random
import re
import threading
import time
import warnings
from typing import Dict, List, Optional

from paddle_tpu_torch import flags as _flags
from paddle_tpu_torch import monitor as _monitor

_M_INJECTED = _monitor.counter(
    "pt_fault_injected_total",
    "faults injected by the chaos plan, by site")

# THE fast-path flag: Site.hit reads this one module boolean and returns
# before touching any other state while no plan is armed.
_armed = False
# whether the live plan came from the fault_plan flag (the flag watcher
# may only disarm plans it armed itself)
_armed_from_flag = False

_LOCK = threading.Lock()
_sites: Dict[str, "Site"] = {}
_records: List[dict] = []
_MAX_RECORDS = 256


class InjectedFault(RuntimeError):
    """Raised by a site whose plan says ``raise``. Distinct from organic
    failures so chaos tests can assert the *injected* fault (and only
    it) propagated."""

    def __init__(self, site: str, hit: int, message: str = ""):
        self.site = site
        self.hit = hit
        super().__init__(
            message or f"injected fault at site {site!r} (hit {hit})")


class _Rule:
    """One parsed plan entry bound to a site: when + what."""

    __slots__ = ("action", "arg", "at", "prob")

    def __init__(self, action: str, arg, at: frozenset, prob: Optional[float]):
        self.action = action  # 'raise' | 'delay' | 'truncate'
        self.arg = arg        # message | seconds | bytes
        self.at = at          # hit numbers (1-based), possibly empty
        self.prob = prob      # per-hit probability, or None

    def fires(self, hit: int, rng: Optional[random.Random]) -> bool:
        if hit in self.at:
            return True
        if self.prob is not None and rng is not None:
            # one draw per hit per probabilistic rule — the stream is
            # positional, so determinism needs the same hit sequence
            return rng.random() < self.prob
        return False


class Site:
    """A named fault-injection point. Create once at module level;
    call ``hit()`` (optionally with the path of the file just written,
    enabling ``truncate``) where the failure would bite."""

    __slots__ = ("name", "hits", "_rules", "_rng")

    def __init__(self, name: str):
        self.name = name
        self.hits = 0
        self._rules: List[_Rule] = []
        self._rng: Optional[random.Random] = None

    def hit(self, path: Optional[str] = None):
        if not _armed:
            return
        self._hit_slow(path)

    def _hit_slow(self, path: Optional[str]):
        with _LOCK:
            self.hits += 1
            hit = self.hits
            fired = [r for r in self._rules if r.fires(hit, self._rng)]
        for r in fired:
            _M_INJECTED.inc(labels={"site": self.name})
            with _LOCK:
                if len(_records) >= _MAX_RECORDS:
                    del _records[0]
                _records.append(
                    {"site": self.name, "hit": hit, "action": r.action})
            if r.action == "delay":
                time.sleep(float(r.arg))
            elif r.action == "truncate":
                if path is not None:
                    with open(path, "r+b") as f:
                        f.truncate(int(r.arg))
                else:
                    # still counted as injected above — but a chaos run
                    # must not believe it tore a file it never touched
                    warnings.warn(
                        f"truncate fault fired at site {self.name!r} "
                        f"(hit {hit}) but the site passed no file path; "
                        f"nothing was truncated", RuntimeWarning)
            else:  # raise
                raise InjectedFault(self.name, hit, str(r.arg or ""))


# The production sites, for plan authors (each is created by its
# declaring module's import; `import paddle_tpu_torch` pulls in all of
# them, and the end of this module declares those the port does not wire
# yet). tests/test_torch_planes.py proves every name here resolves to a
# registered site.
BUILTIN_SITES = {
    "ckpt.write_shards": "checkpoint shard .npz written, pre-commit "
                         "(parallel/checkpoint.py; truncate = torn shard)",
    "ckpt.commit": "checkpoint COMMIT-marker write on process 0 "
                   "(parallel/checkpoint.py; delay = slow commit, "
                   "proving async-save overlap)",
    "ckpt.read": "restore path: each manifest parse AND each shard-file "
                 "read (parallel/checkpoint.py _read_raw; raise/truncate "
                 "= torn restore, validation treats the serial invalid)",
    "fleet.connect": "coord-server connect attempt (fleet_base)",
    "fleet.kv_get": "coord KV get attempt (fleet_base; also the "
                    "commit-barrier ack/publish waits)",
    "fleet.kv_put": "coord KV put attempt (fleet_base; also the "
                    "commit-barrier acks)",
    "fleet.heartbeat": "worker heartbeat RPC (fleet_base)",
    "fleet.resize": "elastic-resize planning after dead-worker "
                    "detection (fleet_base.plan_resize)",
    "fleet.join": "scale-out admission on the JOINER (fleet_base."
                  "join_world): hit 1 = the announce, hit 2 = plan "
                  "adoption — chaos plans can tear an admission at "
                  "either seam",
    "executor.step": "executor step/window body, pre-dispatch "
                     "(executor.py; delay = a slowed rank for the fleet "
                     "straggler drill — the sleep lands in the dispatch "
                     "phase; raise(RESOURCE_EXHAUSTED ...) = synthetic "
                     "device OOM for forensics drills)",
    "reader.next": "trainer batch fetch (contrib/trainer.py)",
    "pipeline.prefetch": "device-feed prefetch worker, per batch before "
                         "its device_put (reader/pipeline.py; "
                         "raise(RESOURCE_EXHAUSTED ...) = infeed OOM "
                         "drill — surfaces in the consumer with OOM "
                         "forensics; delay = slow host pipeline driving "
                         "the input_bound verdict)",
    "executor.fetch": "deferred-fetch materialization (executor.py "
                      "LazyFetches.wait; raise(RESOURCE_EXHAUSTED ...) "
                      "= a device failure surfacing only at the async "
                      "fetch boundary — must still run donated-buffer "
                      "hygiene + OOM forensics)",
    "io.export": "inference-model export publish (io.py)",
    "ccache.load": "persistent compile-cache entry read, pre-deserialize "
                   "(compile_cache.load; truncate = corrupt published "
                   "entry, which must degrade to a metered miss)",
    "ccache.store": "persistent compile-cache staged write, pre-rename "
                    "(compile_cache.store; raise/truncate = torn store — "
                    "the atomic publish must leave no torn entry)",
    "serve.enqueue": "serving request intake, pre-queue (serving.py "
                     "ServingEngine.submit; raise = failed admission "
                     "path — the request must surface the error, not "
                     "hang)",
    "serve.prefill": "serving admission, pre-prefill of the popped "
                     "request (serving.py _admit; raise = torn "
                     "admission — the handle finishes 'error' before "
                     "the exception propagates, the engine keeps "
                     "serving)",
    "serve.decode": "serving decode loop, pre-dispatch of each "
                    "single-token step (serving.py; delay = a "
                    "stalled/wedged decode loop for SLO + supervisor "
                    "drills; raise(slot=N[,M]) = a CONTAINED poisoned-"
                    "slot fault — only the named slots are evicted "
                    "(outcome 'evicted', partial output kept) and the "
                    "engine keeps decoding; a raise WITHOUT a slot hint "
                    "drills an unattributable device error: the engine "
                    "fails and an EngineSupervisor warm-restarts it)",
    "serve.fetch": "serving token materialization, pre-wait of the "
                   "double-buffered decode step's LazyFetches "
                   "(serving.py _process_ready; raise(slot=N) = "
                   "contained eviction with the step's remaining "
                   "fetches retried once; unhinted raise = engine-"
                   "fatal, the supervisor-restart seam)",
    "router.route": "fleet router replica selection, per submit() "
                    "(fleet_serving.py ServingFleet.submit; raise = a "
                    "routing-plane failure the caller must see — no "
                    "replica is charged; delay = slow routing under "
                    "the deadline budget)",
    "router.replica_crash": "fleet pump tick, once per tick "
                            "(fleet_serving.py; raise(replica=N) = "
                            "hard-kill the N-th live replica (id "
                            "order, default 0) mid-flight — the kill-"
                            "one-replica drill: its supervisor is "
                            "harvested and every in-flight request "
                            "replays on survivors byte-identically)",
    "router.handoff": "rolling-rollout drain of one replica, pre-"
                      "handoff (fleet_serving.py _retire_replica; "
                      "raise = the drain tears mid-rollout — the "
                      "replica is hard-harvested instead and its "
                      "requests still re-home on survivors; delay = "
                      "slow handoff under the rollout timeout)",
}


def site(name: str) -> Site:
    """Get-or-create the named site (module-level singleton)."""
    with _LOCK:
        s = _sites.get(name)
        if s is None:
            s = _sites[name] = Site(name)
            s._rules = _plan_rules.get(name, [])
            if s._rules and _seed is not None:
                s._rng = random.Random(f"{_seed}:{name}")
        return s


# parsed plan: site name -> rules (kept so sites created AFTER arm()
# still bind their rules)
_plan_rules: Dict[str, List[_Rule]] = {}
_seed: Optional[int] = None

_ACTION_RE = re.compile(r"^(raise|delay|truncate)(?:\((.*)\))?$")


def _parse_entry(entry: str):
    entry = entry.strip()
    if not entry:
        return None
    site_name, sep, rest = entry.partition(":")
    if not sep or "@" not in rest:
        raise ValueError(
            f"bad fault-plan entry {entry!r}: want 'site:action@trigger'")
    action_s, _, trig_s = rest.partition("@")
    m = _ACTION_RE.match(action_s.strip())
    if not m:
        raise ValueError(
            f"bad fault-plan action {action_s!r} in {entry!r} "
            f"(want raise[(msg)] / delay(seconds) / truncate(bytes))")
    action, arg = m.group(1), m.group(2)
    if action == "delay":
        arg = float(arg if arg is not None else 0.0)
    elif action == "truncate":
        arg = int(arg if arg is not None else 0)
    at, prob = set(), None
    for t in trig_s.split(","):
        t = t.strip()
        if not t:
            continue
        if t[0] in "pP":
            prob = float(t[1:])
        else:
            at.add(int(t))
    if not at and prob is None:
        raise ValueError(f"fault-plan entry {entry!r} has no trigger")
    return site_name.strip(), _Rule(action, arg, frozenset(at), prob)


def arm(plan: str, seed: Optional[int] = None, _from_flag: bool = False):
    """Parse ``plan`` and arm its sites. Hit counters reset so the plan's
    Nth-hit triggers count from here; ``seed`` (default: the
    ``fault_seed`` flag) fixes the probabilistic streams."""
    global _armed, _seed, _armed_from_flag
    rules: Dict[str, List[_Rule]] = {}
    for entry in plan.split(";"):
        parsed = _parse_entry(entry)
        if parsed is None:
            continue
        name, rule = parsed
        rules.setdefault(name, []).append(rule)
    if not rules:
        disarm()
        return
    with _LOCK:
        _seed = int(_flags.get_flag("fault_seed")) if seed is None else seed
        _armed_from_flag = _from_flag
        _plan_rules.clear()
        _plan_rules.update(rules)
        _records.clear()  # fresh log per plan; survives disarm()
        for s in _sites.values():
            s.hits = 0
            s._rules = _plan_rules.get(s.name, [])
            s._rng = (random.Random(f"{_seed}:{s.name}")
                      if s._rules else None)
        _armed = True


def disarm():
    """Drop the plan: every site back to the one-boolean disabled path.
    The injected-fault log survives (post-mortems read ``records()``
    AFTER disarming); the next ``arm()`` starts a fresh log."""
    global _armed, _armed_from_flag
    with _LOCK:
        _armed = False
        _armed_from_flag = False
        _plan_rules.clear()
        for s in _sites.values():
            s.hits = 0
            s._rules = []
            s._rng = None


def active() -> bool:
    return _armed


def records() -> List[dict]:
    """Injected-fault log (site, hit, action), oldest first, bounded."""
    with _LOCK:
        return list(_records)


def sites() -> List[str]:
    with _LOCK:
        return sorted(_sites)


def _sync_plan(_value=None):
    plan = _flags.get_flag("fault_plan")
    if plan:
        arm(plan, _from_flag=True)
    elif _armed and _armed_from_flag:
        # only un-arm what the flag armed: a watcher firing on an
        # unrelated flag write (e.g. set_flags({'fault_seed': 7}) with
        # fault_plan still "") must not drop a faults.arm()'d plan
        disarm()


# env-set plans (PT_FLAGS_fault_plan) arm at import; later set_flags
# calls re-arm / disarm live
_flags.watch_flag("fault_plan", _sync_plan)
_flags.watch_flag("fault_seed", _sync_plan)


# Sites whose declaring module is not ported yet: declared here so a plan
# that names one arms it (no "unknown site" surprise, the same records),
# while nothing in the port hits it. ROADMAP names the item that wires
# each one.
UNWIRED_SITES = ("fleet.connect", "fleet.kv_get", "fleet.kv_put",
                 "fleet.heartbeat", "fleet.resize", "fleet.join",
                 "ccache.load", "ccache.store")
for _name in UNWIRED_SITES:
    site(_name)
del _name
