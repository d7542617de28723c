"""Fleet-wide observability: cross-rank metric aggregation, straggler
detection, and the /fleet cluster view.

The port of the JAX package's ``fleet_monitor`` module: the same digest
schema (``monitor.FLEET_DIGEST_FIELDS``), KV keys, view, straggler
records, metric names and Prometheus text, over the fleet KV client it
is handed. A "fleet" here is any object with the JAX ``Fleet``'s
surface that this module reads: ``_client`` (``put``, ``get(key,
timeout_ms=)``, ``dead_peers(max_age_ms)``), ``_role``,
``worker_index()``, ``worker_num()`` and ``generation()``. The port has
no ``Fleet`` class and no coordination service yet (the native runtime,
ROADMAP Queue 1 item 9): a caller that has a KV client publishes with
``maybe_publish`` on its own heartbeat cadence. Three pieces:

1. **Digest publish** — a worker serializes a compact registry digest
   (counter/gauge values, histogram sums/counts, the last step record
   with phases + boundedness verdict, trailing step-time medians) into
   fleet KV under ``fleet/metrics/g<gen>/<rank>``, rate-limited by the
   ``fleet_metrics_interval_ms`` flag, under a quick retry policy — a KV
   hiccup drops ONE digest, never stalls a step.

2. **Aggregation + cluster view** — rank 0 (or any caller) resolves the
   per-rank digests into one view: per-rank step time, phase breakdown,
   boundedness verdict, heartbeat age — with a rank whose digest aged
   past the staleness window marked ``dead`` instead of serving its
   stale row. Served at the monitor endpoint's ``/fleet`` route;
   ``/metrics?fleet=1`` is the merged Prometheus exposition (every
   rank's digest samples labelled ``rank=``). The JAX module reads
   through a dedicated socket to the coord server when the fleet's role
   names its endpoint (``coord_endpoint()``); that socket needs the
   native runtime, so here such a fleet raises ``NotImplementedError``
   naming it, and the view never falls back to another client.

3. **Straggler detection** — a rolling cross-rank skew detector over
   the digests' trailing step-time medians: an alive rank whose step time
   exceeds BOTH ``fleet_straggler_factor`` x the alive-rank median AND
   the median + ``fleet_straggler_min_ms`` is named a straggler, with
   the inflated phase attributed by the largest per-phase delta vs the
   cross-rank median phase profile. Detections count into
   ``pt_fleet_straggler_total{rank=}``, append structured records
   (``monitor.STRAGGLER_RECORD_SCHEMA_VERSION``) surfaced at ``/fleet``
   and in stall-watchdog flight-recorder dumps, and warn once per
   (rank, phase) streak.

Disabled-path contract (the monitor.py house rule): with telemetry off
or no multi-worker fleet attached, every entry point returns after one
boolean/None check and allocates nothing.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import warnings
from statistics import median as _median
from typing import Any, Dict, List, Optional

from paddle_tpu_torch import flags as _flags
from paddle_tpu_torch import monitor as _monitor
from paddle_tpu_torch import retry as _retry

# Publishes ride the heartbeat cadence, so they get the heartbeat's
# retry shape: a few quick attempts, never a long backoff that would
# age the heartbeat itself.
_PUBLISH_POLICY = _retry.RetryPolicy(
    base_delay=0.05, max_delay=0.5, max_attempts=3, retry_on=(OSError,))

_M_PUBLISHED = _monitor.counter(
    "pt_fleet_digests_published_total",
    "metric digests published into fleet KV (piggybacked on heartbeats)")
_M_PUBLISH_DROPS = _monitor.counter(
    "pt_fleet_digest_publish_drops_total",
    "digest publishes dropped after the quick-retry budget (a drop "
    "skips ONE digest; the next heartbeat publishes fresh)")
_M_STRAGGLERS = _monitor.counter(
    "pt_fleet_straggler_total",
    "straggler streaks named by the cross-rank skew detector, by rank "
    "(ticks once per (rank, phase) streak, not per aggregation pass)")

# KV key prefix; generation-scoped so an elastic resize starts a fresh
# namespace instead of mixing digests across worlds.
KV_PREFIX = "fleet/metrics"

# Trailing step-record window the digest medians are computed over: small
# for the same reason monitor.BOUND_WINDOW is — the straggler detector
# must track the CURRENT skew, not average a warmup compile into it.
DIGEST_WINDOW = 8

_LOCK = threading.Lock()

# the Fleet object whose client the /fleet route aggregates through;
# set by maybe_publish (workers) or attach (rank 0 / tests)
_fleet = None

# Aggregation runs on whatever thread asks (the /fleet HTTP handler,
# the trainer's epoch summary, the worker's own loop) but a KV client
# may be ONE socket speaking a request/response protocol — two threads
# interleaving frames on it corrupt the stream for good. So every pass
# runs under one lock.
_AGG_LOCK = threading.Lock()


def _agg_client_for(fleet):
    """The aggregation-side coord connection (caller holds _AGG_LOCK):
    the fleet's own client (the stub-client tests drive aggregation
    single-threaded). A fleet whose role names a coord endpoint asks
    for the JAX module's dedicated socket, which needs the native
    runtime: that raises."""
    role = getattr(fleet, "_role", None)
    ep_fn = getattr(role, "coord_endpoint", None)
    endpoint = ep_fn() if callable(ep_fn) else None
    if endpoint:
        raise NotImplementedError(
            f"fleet_monitor: aggregating through a dedicated coord "
            f"socket to {endpoint} needs the native runtime "
            f"(paddle_tpu.native.CoordClient), which paddle_tpu_torch "
            f"has not ported yet")
    return fleet._client


_pub_seq = 0
_last_publish_perf = 0.0

_last_view: Optional[Dict[str, Any]] = None
_STRAGGLER_RECORDS: collections.deque = collections.deque(maxlen=64)
# (rank, phase) of the previous detection pass, to warn once per streak
_last_named: frozenset = frozenset()

# aggregator-side digest observation history: (gen, rank) -> [seq,
# local perf_counter of the first pass that saw this seq]. Digest age
# is measured against THIS clock once a rank has history — the
# publisher's wall-clock ts is trusted only for the very first sight
# of a rank, so cross-host clock skew cannot keep flagging a healthy
# publisher dead (or keep a dead rank's future-stamped digest fresh).
_seen: Dict[tuple, list] = {}

# cached hot flag values (flags.watch_flag pattern)
_interval_ms = 1000
_factor = 2.0
_min_ms = 20


def _sync_interval(value):
    global _interval_ms
    _interval_ms = int(value)


def _sync_factor(value):
    global _factor
    _factor = float(value)


def _sync_min_ms(value):
    global _min_ms
    _min_ms = int(value)


_flags.watch_flag("fleet_metrics_interval_ms", _sync_interval)
_flags.watch_flag("fleet_straggler_factor", _sync_factor)
_flags.watch_flag("fleet_straggler_min_ms", _sync_min_ms)


# ---------------------------------------------------------------------------
# digest assembly
# ---------------------------------------------------------------------------

def registry_digest(rank: int = 0, world: int = 1,
                    gen: int = 0) -> Dict[str, Any]:
    """One worker's compact telemetry digest
    (``monitor.FLEET_DIGEST_FIELDS``): counter/gauge cells, histogram
    sum/count cells (no buckets — the digest must stay KV-sized), the
    last step record, the boundedness verdict, and trailing step-time /
    phase medians for the straggler detector."""
    global _pub_seq
    counters: Dict[str, list] = {}
    gauges: Dict[str, list] = {}
    hists: Dict[str, list] = {}
    for name, m in _monitor.snapshot().items():
        cells = m["values"]
        if not cells:
            continue
        if m["kind"] == "counter":
            counters[name] = [{"labels": c["labels"], "value": c["value"]}
                              for c in cells]
        elif m["kind"] == "gauge":
            gauges[name] = [{"labels": c["labels"], "value": c["value"]}
                            for c in cells]
        else:
            hists[name] = [{"labels": c["labels"], "sum": c["sum"],
                            "count": c["count"]} for c in cells]
    recs = _monitor.recent_steps(DIGEST_WINDOW)
    # window MEDIANS, not means: one compile-inflated warmup step in the
    # trailing window would otherwise skew every rank's signal by ITS
    # compile time, and compile durations vary enough across ranks to
    # fake (or mask) a straggler during the first post-warmup steps
    # sampled=False records dispatched fully async: their wall_ms is
    # host-only (no device time) and would drag the median toward zero —
    # only phase-sampled (or pre-sampling-era) records carry honest walls
    walls = [r["wall_ms"] for r in recs
             if isinstance(r.get("wall_ms"), (int, float))
             and r.get("sampled") is not False]
    phase_recs = [r["phases"] for r in recs if isinstance(
        r.get("phases"), dict)]
    phases_ms: Optional[Dict[str, float]] = None
    if phase_recs:
        phases_ms = {}
        for ph in _monitor.STEP_PHASES:
            vals = [p[ph] for p in phase_recs
                    if isinstance(p.get(ph), (int, float))]
            if vals:
                phases_ms[ph] = _median(vals)
    with _LOCK:
        seq = _pub_seq
        _pub_seq += 1
    # roofline rollup (optional field, schema stays v1): per-program
    # measured MFU + verdict, so /fleet names each rank's MFU without
    # shipping whole profiles through KV. Lazy via sys.modules — a
    # worker that never loaded the plane publishes no section.
    import sys as _sys

    rl = _sys.modules.get("paddle_tpu_torch.roofline")
    roofline = rl.digest_section() if rl is not None else None
    # serving rollup (same optional-field pattern): per-replica engine
    # rows + TTFT/token quantiles + SLO counts — the /fleet row a
    # multi-replica router selects replicas on. Absent on ranks that
    # never served.
    st = _sys.modules.get("paddle_tpu_torch.serving_trace")
    serving_sec = st.digest_section() if st is not None else None
    digest = {
        "v": _monitor.FLEET_DIGEST_SCHEMA_VERSION,
        "ts": time.time(),
        "seq": seq,
        "rank": int(rank),
        "world": int(world),
        "gen": int(gen),
        "host": _monitor._HOSTNAME,
        "pid": os.getpid(),
        "counters": counters,
        "gauges": gauges,
        "hists": hists,
        "last_step": recs[-1] if recs else None,
        "bound": _monitor.boundedness(),
        "step_wall_ms": _median(walls) if walls else None,
        "phases_ms": phases_ms,
        "steps": int(_monitor.counter(
            "pt_executor_steps_total").value()),
    }
    if roofline is not None:
        digest["roofline"] = roofline
    if serving_sec is not None:
        digest["serving"] = serving_sec
    return digest


# ---------------------------------------------------------------------------
# publish (piggybacked on Fleet.heartbeat)
# ---------------------------------------------------------------------------

def attach(fleet):
    """Register the Fleet whose KV client the aggregation side reads
    through (done automatically by the first publish)."""
    global _fleet
    _fleet = fleet


def maybe_publish(fleet, force: bool = False):
    """Publish this worker's registry digest into fleet KV, rate-limited
    to one publish per ``fleet_metrics_interval_ms`` (0 = every call).
    Callers gate on ``monitor.enabled()`` — the disabled hot path never
    enters this module. A publish failure past the quick-retry budget
    drops THIS digest (metered + warned once), never raises: telemetry
    must not fail a step."""
    global _last_publish_perf
    client = getattr(fleet, "_client", None)
    if client is None:
        return  # single-worker: nothing to publish, nobody to read it
    if _fleet is not fleet:
        attach(fleet)
    now = time.perf_counter()
    if (not force and _last_publish_perf
            and (now - _last_publish_perf) * 1e3 < _interval_ms):
        return
    _last_publish_perf = now
    digest = registry_digest(rank=fleet.worker_index(),
                             world=fleet.worker_num(),
                             gen=fleet.generation())
    payload = json.dumps(digest, default=str).encode()
    key = f"{KV_PREFIX}/g{digest['gen']}/{digest['rank']}"
    try:
        _retry.call(lambda: client.put(key, payload),
                    site="fleet.metrics_publish", policy=_PUBLISH_POLICY)
        _M_PUBLISHED.inc()
    except Exception as e:
        _M_PUBLISH_DROPS.inc()
        if _M_PUBLISH_DROPS.value() == 1.0:
            warnings.warn(
                f"fleet metric-digest publish failed ({type(e).__name__}:"
                f" {e}); this digest is dropped, the next heartbeat "
                f"publishes fresh", RuntimeWarning)


# ---------------------------------------------------------------------------
# aggregation: the cluster view
# ---------------------------------------------------------------------------

def _staleness_ms(max_age_ms: Optional[int]) -> int:
    """Dead threshold for digest age: explicit, else 4 publish intervals
    floored at 10 s. Publishes ride heartbeats and heartbeats ride the
    STEP cadence, so the floor must tolerate multi-second steps — a
    healthy 5 s-step job must not flap every rank dead between steps
    (callers with slower cadences pass ``max_age_ms`` explicitly;
    ``Fleet.dead_workers`` keeps its own, looser 30 s default)."""
    if max_age_ms is not None:
        return int(max_age_ms)
    return max(10_000, 4 * _interval_ms)


def aggregate(fleet=None, max_age_ms: Optional[int] = None) -> Dict[str, Any]:
    """Resolve every rank's digest from fleet KV into one cluster view:

    ``{ts, gen, world, ranks: {rank: digest + age_ms + dead}, missing:
    [ranks with no digest yet], stragglers: [...], dead: [...]}``

    A rank is ``dead`` when its digest age exceeds the staleness window
    OR the coord service reports its heartbeat stale — the view marks it
    instead of serving its stale row as live. Runs the cross-rank skew
    detector over the alive rows. Uses non-blocking KV reads: the view
    reflects what has been published, it never waits for a peer."""
    fleet = fleet if fleet is not None else _fleet
    if fleet is None or getattr(fleet, "_client", None) is None:
        return _local_view()
    gen = fleet.generation()
    world = fleet.worker_num()
    stale_ms = _staleness_ms(max_age_ms)
    now = time.time()
    ranks: Dict[str, Any] = {}
    missing: List[int] = []
    with _AGG_LOCK:
        client = _agg_client_for(fleet)
        try:
            hb_dead = {str(d) for d in client.dead_peers(stale_ms)}
        except OSError:
            # a failed client must not serve the rank loop below: the
            # whole pass degrades to missing
            hb_dead = set()
            client = None
        for r in range(world):
            if client is None:
                missing.append(r)
                continue
            try:
                raw = client.get(f"{KV_PREFIX}/g{gen}/{r}", timeout_ms=0)
            except TimeoutError:
                missing.append(r)
                continue
            except OSError:
                missing.append(r)
                client = None
                continue
            try:
                digest = json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                missing.append(r)
                continue
            pnow = time.perf_counter()
            ent = _seen.get((gen, r))
            if ent is None:
                # first sight: the publisher's self-reported ts is the
                # only age signal (best-effort under clock skew). The
                # anchor is BACKDATED by that age — an already-stale
                # digest must keep aging on later passes, not resurrect
                # as alive because the anchor said "just seen"
                age_ms = max(0.0,
                             (now - float(digest.get("ts", 0.0))) * 1e3)
                _seen[(gen, r)] = [digest.get("seq"), pnow - age_ms / 1e3]
            elif ent[0] != digest.get("seq"):
                # a fresh publish was OBSERVED — fresh by the
                # aggregator's own clock, whatever the publisher's says
                ent[0], ent[1] = digest.get("seq"), pnow
                age_ms = 0.0
            else:
                age_ms = (pnow - ent[1]) * 1e3
            row = dict(digest)
            row["age_ms"] = age_ms
            row["dead"] = bool(age_ms > stale_ms
                               or f"worker-{r}" in hb_dead)
            ranks[str(r)] = row
    stragglers = _detect_stragglers(ranks, world)
    view = {
        "ts": now,
        "gen": gen,
        "world": world,
        "ranks": ranks,
        "missing": missing,
        "dead": sorted(int(r) for r, row in ranks.items() if row["dead"]),
        "stragglers": stragglers,
        "oom_reports": _monitor.oom_records(),
    }
    global _last_view
    with _LOCK:
        _last_view = view
    return view


def _local_view() -> Dict[str, Any]:
    """Single-process fallback for /fleet: one live row (rank 0) from
    the local registry — the route answers the same shape whether or
    not a multi-worker fleet is up."""
    digest = registry_digest()
    digest["age_ms"] = 0.0
    digest["dead"] = False
    return {
        "ts": digest["ts"],
        "gen": 0,
        "world": 1,
        "ranks": {"0": digest},
        "missing": [],
        "dead": [],
        "stragglers": straggler_records(),
        "oom_reports": _monitor.oom_records(),
    }


def cluster_view(refresh: bool = True) -> Dict[str, Any]:
    """The /fleet route body: re-aggregate through the attached fleet
    when possible (``refresh``), else the last cached view, else the
    local single-rank view."""
    if refresh:
        try:
            return aggregate()
        except NotImplementedError:
            raise  # an unported path is an error, never a fallback
        except Exception as e:
            warnings.warn(f"fleet aggregation failed: {e!r}",
                          RuntimeWarning)
    with _LOCK:
        if _last_view is not None:
            return dict(_last_view)
    return _local_view()


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------

def _detect_stragglers(ranks: Dict[str, Any],
                       world: int) -> List[Dict[str, Any]]:
    """Rolling cross-rank skew pass over the alive rows' trailing
    step-time medians. Returns this pass's records (also appended to
    the bounded module buffer + counted into pt_fleet_straggler_total).
    Attribution: the phase whose median inflates most over the
    cross-rank median phase profile — the seeded delay drill lands its
    sleep in one phase, and THIS is what names it. Detection state
    (record buffer, warn-once streaks) mutates under _LOCK: passes run
    concurrently from the /fleet handler, the trainer's epoch summary
    and the aggregator's own loop."""
    global _last_named
    alive = {int(r): row for r, row in ranks.items()
             if not row.get("dead")
             and isinstance(row.get("step_wall_ms"), (int, float))}
    if len(alive) < 2:
        with _LOCK:
            _last_named = frozenset()
        return []
    med = _median([row["step_wall_ms"] for row in alive.values()])
    # cross-rank median per phase, for attribution deltas
    phase_med: Dict[str, float] = {}
    for ph in _monitor.STEP_PHASES:
        vals = [row["phases_ms"][ph] for row in alive.values()
                if isinstance(row.get("phases_ms"), dict)
                and isinstance(row["phases_ms"].get(ph), (int, float))]
        if vals:
            phase_med[ph] = _median(vals)
    records: List[Dict[str, Any]] = []
    named = set()
    fresh: List[Dict[str, Any]] = []
    for r, row in sorted(alive.items()):
        wall = float(row["step_wall_ms"])
        if wall <= med * _factor or wall - med <= _min_ms:
            continue
        deltas: Dict[str, float] = {}
        if isinstance(row.get("phases_ms"), dict):
            for ph, m in phase_med.items():
                v = row["phases_ms"].get(ph)
                if isinstance(v, (int, float)):
                    deltas[ph] = float(v) - m
        phase = (max(deltas, key=deltas.get) if deltas else "unknown")
        rec = {
            "v": _monitor.STRAGGLER_RECORD_SCHEMA_VERSION,
            "ts": time.time(),
            "rank": r,
            "phase": phase,
            "step_wall_ms": wall,
            "median_wall_ms": med,
            "factor": wall / med if med > 0 else float("inf"),
            "steps": int(row.get("steps", 0)),
            "world": int(world),
            "deltas_ms": deltas,
        }
        records.append(rec)
        named.add((r, phase))
    # the counter, the bounded record buffer and the warning all tick
    # once per (rank, phase) STREAK — aggregation runs on every /fleet
    # scrape, and per-pass accounting would make the metric's rate a
    # function of whoever is polling (and flood the flight-recorder
    # buffer with duplicates of the current streak). The returned
    # records still reflect THIS pass, so the live view always shows
    # the current stragglers.
    with _LOCK:
        fresh = [rec for rec in records
                 if (rec["rank"], rec["phase"]) not in _last_named]
        _STRAGGLER_RECORDS.extend(fresh)
        _last_named = frozenset(named)
    for rec in fresh:
        _M_STRAGGLERS.inc(labels={"rank": rec["rank"]})
        warnings.warn(
            f"fleet straggler: rank {rec['rank']} step time "
            f"{rec['step_wall_ms']:.1f} ms vs cluster median "
            f"{rec['median_wall_ms']:.1f} ms ({rec['factor']:.1f}x); "
            f"inflated phase: {rec['phase']}",
            RuntimeWarning)
    return records


def straggler_records() -> List[Dict[str, Any]]:
    """Buffered straggler records, oldest first (bounded)."""
    with _LOCK:
        return [dict(r) for r in _STRAGGLER_RECORDS]


def summary() -> Dict[str, Any]:
    """The stall watchdog's flight-recorder section: the last cluster
    view (if any) + the straggler record buffer."""
    with _LOCK:
        view = dict(_last_view) if _last_view is not None else None
    return {"view": view, "stragglers": straggler_records()}


# ---------------------------------------------------------------------------
# merged Prometheus exposition (/metrics?fleet=1)
# ---------------------------------------------------------------------------

def to_prometheus_fleet(view: Optional[Dict[str, Any]] = None) -> str:
    """Merge the latest aggregated digests into one Prometheus text
    exposition: every rank's counter/gauge cells re-labelled with
    ``rank=``; histograms as ``_sum``/``_count`` pairs (buckets stay on
    each worker's own /metrics). Docs/types come from the local
    registry when the metric is registered here too."""
    view = cluster_view() if view is None else view

    def _labels(cell, r):
        # publisher rank labels every merged sample; a metric's OWN
        # rank label (pt_fleet_straggler_total{rank=}) must survive as
        # exported_rank (the Prometheus-federation convention), not be
        # clobbered into naming the publisher
        labels = dict(cell["labels"])
        if "rank" in labels:
            labels["exported_rank"] = labels.pop("rank")
        labels["rank"] = r
        return labels

    # name -> (kind, [(labels+rank, value-or-(sum,count))])
    merged: Dict[str, tuple] = {}
    for r, row in sorted(view.get("ranks", {}).items(),
                         key=lambda kv: int(kv[0])):
        for name, cells in sorted(row.get("counters", {}).items()):
            merged.setdefault(name, ("counter", []))[1].extend(
                (_labels(c, r), c["value"]) for c in cells)
        for name, cells in sorted(row.get("gauges", {}).items()):
            merged.setdefault(name, ("gauge", []))[1].extend(
                (_labels(c, r), c["value"]) for c in cells)
        for name, cells in sorted(row.get("hists", {}).items()):
            merged.setdefault(name, ("histogram", []))[1].extend(
                (_labels(c, r), (c["sum"], c["count"]))
                for c in cells)
    lines: List[str] = []
    for name, (kind, cells) in sorted(merged.items()):
        local = _monitor._REGISTRY.get(name)
        if local is not None and local.doc:
            lines.append(f"# HELP {name} {local.doc}")
        lines.append(f"# TYPE {name} {'untyped' if kind == 'histogram' else kind}")
        for labels, val in cells:
            if kind == "histogram":
                s, c = val
                lines.append(
                    f"{name}_sum{_monitor._prom_labels(labels)} {s}")
                lines.append(
                    f"{name}_count{_monitor._prom_labels(labels)} {c}")
            else:
                lines.append(
                    f"{name}{_monitor._prom_labels(labels)} {val}")
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# trainer epoch summary + test isolation
# ---------------------------------------------------------------------------

def epoch_summary_line() -> Optional[str]:
    """One fleet-summary line for the trainer's per-epoch log, or None
    when there is nothing fleet-wide to say (single worker, no fleet
    attached, or not rank 0 — only the aggregator prints, or N workers
    would log N copies)."""
    fleet = _fleet
    if (fleet is None or getattr(fleet, "_client", None) is None
            or fleet.worker_num() <= 1 or fleet.worker_index() != 0):
        return None
    view = aggregate(fleet)
    ranks = view["ranks"]
    walls = sorted(
        (row["step_wall_ms"], int(r)) for r, row in ranks.items()
        if not row["dead"]
        and isinstance(row.get("step_wall_ms"), (int, float)))
    span = ""
    if walls:
        lo, lo_r = walls[0]
        hi, hi_r = walls[-1]
        span = (f", step ms min {lo:.1f} (rank {lo_r}) / "
                f"max {hi:.1f} (rank {hi_r})")
    streak = {f"rank {rec['rank']} ({rec['phase']})"
              for rec in view["stragglers"]}
    lagline = ("stragglers: " + ", ".join(sorted(streak))
               if streak else "stragglers: none")
    n_alive = len(ranks) - len(view["dead"])
    return (f"fleet: {n_alive}/{view['world']} ranks alive"
            + (f", dead {view['dead']}" if view["dead"] else "")
            + (f", missing {view['missing']}" if view["missing"] else "")
            + span + ", " + lagline)


def reset():
    """Test isolation (called from monitor.reset): drop the attached
    fleet, cached view, straggler buffer and publish cursor."""
    global _fleet, _last_view, _pub_seq, _last_publish_perf, _last_named
    with _LOCK:
        _fleet = None
        _last_view = None
        _pub_seq = 0
        _last_publish_perf = 0.0
        _last_named = frozenset()
        _STRAGGLER_RECORDS.clear()
    with _AGG_LOCK:
        # _seen is aggregation state mutated under _AGG_LOCK — clearing
        # it under _LOCK would race an in-flight aggregate() pass
        # reinserting pre-reset entries after the clear
        _seen.clear()
