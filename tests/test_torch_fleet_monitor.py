"""The port's fleet observability plane (paddle_tpu_torch/fleet_monitor.py)
against the JAX package's ``fleet_monitor`` on the CPU: both modules are
handed the same digests through the stub KV client of
tests/test_fleet_observability.py, and give equal digests, views,
straggler records, Prometheus text and epoch lines.

- ``registry_digest`` over the same step records: equal fields (the
  trailing medians, the last step), valid under both schemas;
- ``aggregate`` over equal stores, scenario by scenario (all alive, a
  stale rank, a missing rank, a heartbeat-dead rank, a straggler, the
  sub-ms floor), and the staleness anchor across passes;
- the straggler records and counters tick once a streak in both;
- ``to_prometheus_fleet`` gives the same text from the same view;
- ``maybe_publish`` rate-limits and drops one digest as the JAX one
  does, ``cluster_view`` answers the local view without a fleet, and a
  fleet that names a coord endpoint raises (the dedicated socket needs
  the native runtime, not ported);
- the flags ``fleet_metrics_interval_ms``, ``fleet_straggler_factor``
  and ``fleet_straggler_min_ms`` are read live.

Every comparison is exact except the wall-clock fields (``ts``,
``age_ms``), which each side stamps itself."""

import contextlib
import copy
import json
import threading
import time

import pytest

from paddle_tpu import fleet_monitor as jfm
from paddle_tpu import flags as jflags
from paddle_tpu import monitor as jmonitor
from paddle_tpu import serving as _jserving  # noqa: F401 (its metrics)

from paddle_tpu_torch import fleet_monitor as tfm
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import monitor as tmonitor

PKGS = ((jfm, jflags, jmonitor), (tfm, tflags, tmonitor))
_FLAGS = {"telemetry": True, "fleet_metrics_interval_ms": 1000,
          "fleet_straggler_factor": 2.0, "fleet_straggler_min_ms": 20}
_PHASES = {"feed": 1.0, "dispatch": 2.0, "device": 1.5, "fetch": 0.5}


@pytest.fixture(autouse=True)
def _clean():
    for fm, flags, monitor in PKGS:
        monitor.reset()
        flags.set_flags(_FLAGS)
    yield
    for fm, flags, monitor in PKGS:
        monitor.reset()
        flags.set_flags({**_FLAGS, "telemetry": False})


class _Role:
    def __init__(self, rank, world, endpoint=None):
        self._r, self._n, self._ep = rank, world, endpoint

    def worker_index(self):
        return self._r

    def worker_num(self):
        return self._n

    def coord_endpoint(self):
        return self._ep


class _Client:
    def __init__(self, store, lock, dead=()):
        self._store, self._lock, self._dead = store, lock, list(dead)

    def put(self, key, value):
        with self._lock:
            self._store[key] = bytes(value)

    def get(self, key, timeout_ms=-1, max_len=0):
        with self._lock:
            if key in self._store:
                return self._store[key]
        raise TimeoutError(key)

    def dead_peers(self, max_age_ms):
        return list(self._dead)


class _Fleet:
    """The Fleet surface both modules read: a KV client, a role, and the
    rank / world / generation accessors."""

    def __init__(self, rank, world, store, lock, dead=(), endpoint=None):
        self._role = _Role(rank, world, endpoint)
        self._client = _Client(store, lock, dead)

    def worker_index(self):
        return self._role.worker_index()

    def worker_num(self):
        return self._role.worker_num()

    def generation(self):
        return 0


def _digest(rank, wall_ms, phases=None, steps=20, ts=None, world=4, seq=0):
    """A schema-valid digest with the fields aggregation reads, written
    the same for both packages."""
    d = {"v": jmonitor.FLEET_DIGEST_SCHEMA_VERSION,
         "ts": time.time() if ts is None else ts, "seq": seq, "rank": rank,
         "world": world, "gen": 0, "host": "h", "pid": 100 + rank,
         "counters": {"pt_executor_steps_total": [
             {"labels": {}, "value": float(steps)}]},
         "gauges": {"pt_serve_queue_depth": [
             {"labels": {}, "value": float(rank)}]},
         "hists": {"pt_step_phase_seconds": [
             {"labels": {"phase": "device"}, "sum": 0.5 * rank,
              "count": steps}]},
         "last_step": None, "bound": None, "step_wall_ms": wall_ms,
         "phases_ms": phases, "steps": steps}
    for _, _, monitor in PKGS:
        monitor.validate_fleet_digest(d)
    return d


def _stores(digests):
    """One store per package holding the same digest bytes."""
    raw = {f"fleet/metrics/g0/{d['rank']}": json.dumps(d).encode()
           for d in digests}
    return [dict(raw) for _ in PKGS]


def _strip(view):
    """A view without the fields each side stamps with its own clock."""
    v = copy.deepcopy(view)
    v.pop("ts", None)
    for row in v.get("ranks", {}).values():
        row.pop("age_ms", None)
    for rec in v.get("stragglers", []):
        rec.pop("ts", None)
    return v


def _both_aggregate(stores, world, dead=(), max_age_ms=None, **kw):
    views = []
    for (fm, _, _), store in zip(PKGS, stores):
        f = _Fleet(0, world, store, threading.Lock(), dead=dead)
        views.append(fm.aggregate(f, max_age_ms=max_age_ms, **kw))
    return views


def test_registry_digest_equals_jax():
    recs = [{"kind": "step", "step": i, "wall_ms": 10.0 + i,
             "sampled": i % 2 == 0,
             "phases": {"feed": 1.0 + i, "dispatch": 2.0, "device": 3.0 * i,
                        "fetch": 0.25}} for i in range(10)]
    digests = []
    for fm, _, monitor in PKGS:
        for r in recs:
            monitor.log_step(r)
        d = fm.registry_digest(rank=2, world=4, gen=1)
        jmonitor.validate_fleet_digest(d)
        tmonitor.validate_fleet_digest(d)
        digests.append(d)
    j, t = digests
    assert set(j) == set(t)
    for k in ("v", "seq", "rank", "world", "gen", "host", "pid",
              "step_wall_ms", "phases_ms", "bound"):
        assert j[k] == t[k], k
    assert {k: v for k, v in j["last_step"].items() if k != "ts"} == \
        {k: v for k, v in t["last_step"].items() if k != "ts"}
    # medians over the trailing window's sampled records only
    assert t["step_wall_ms"] == 15.0
    assert t["phases_ms"]["device"] == 16.5
    assert tfm.registry_digest()["seq"] == jfm.registry_digest()["seq"] == 1


_SCENARIOS = {
    "all_alive": (lambda now: [_digest(r, 5.0, _PHASES, ts=now, world=3)
                               for r in range(3)], 3, (), None),
    "stale_and_missing": (lambda now: [
        _digest(0, 5.0, _PHASES, ts=now, world=3),
        _digest(1, 5.0, _PHASES, ts=now - 60.0, world=3)], 3, (), 2_000),
    "heartbeat_dead": (lambda now: [_digest(r, 5.0, _PHASES, ts=now)
                                    for r in range(4)], 4, ("worker-3",),
                       None),
    "straggler": (lambda now: [
        _digest(r, 85.0 if r == 2 else 5.0,
                {**_PHASES, "dispatch": 82.0} if r == 2 else _PHASES,
                steps=12, ts=now) for r in range(4)], 4, (), None),
    "submillisecond_floor": (lambda now: [
        _digest(r, w, None, ts=now, world=3)
        for r, w in enumerate((0.4, 0.4, 1.4))], 3, (), None),
}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_aggregate_view_equals_jax(name):
    make, world, dead, max_age = _SCENARIOS[name]
    stores = _stores(make(time.time()))
    j, t = _both_aggregate(stores, world, dead=dead, max_age_ms=max_age)
    assert _strip(j) == _strip(t)
    assert set(t["ranks"]) | set(map(str, t["missing"])) == \
        {str(r) for r in range(world)}
    if name == "straggler":
        (rec,) = t["stragglers"]
        assert (rec["rank"], rec["phase"]) == (2, "dispatch")
    if name == "stale_and_missing":
        assert t["dead"] == [1] and t["missing"] == [2]
    if name == "heartbeat_dead":
        assert t["dead"] == [3]


def test_straggler_streak_ticks_once_in_both():
    slow = {**_PHASES, "dispatch": 82.0}
    stores = _stores([_digest(r, 85.0 if r == 2 else 5.0,
                              slow if r == 2 else _PHASES, steps=12)
                      for r in range(4)])
    for _ in range(3):  # every /fleet scrape re-aggregates
        with (pytest.warns(RuntimeWarning) if _ == 0
              else contextlib.nullcontext()):
            views = _both_aggregate(stores, 4)
        assert _strip(views[0]) == _strip(views[1])
    recs = [fm.straggler_records() for fm, _, _ in PKGS]
    assert len(recs[0]) == len(recs[1]) == 1
    assert [{k: v for k, v in r.items() if k != "ts"} for r in recs[0]] == \
        [{k: v for k, v in r.items() if k != "ts"} for r in recs[1]]
    for _, _, monitor in PKGS:
        assert monitor.counter("pt_fleet_straggler_total").value(
            labels={"rank": 2}) == 1
    summaries = [fm.summary() for fm, _, _ in PKGS]
    assert _strip(summaries[0]["view"]) == _strip(summaries[1]["view"])


def test_staleness_anchor_equals_jax():
    """First sight ages by the publisher's ts; a fresh seq is fresh by
    the aggregator's clock; a frozen seq keeps ageing."""
    skewed = _digest(0, 5.0, None, ts=time.time() - 60.0, world=2)
    stores = _stores([skewed])
    for max_age in (2_000, 2_000):
        j, t = _both_aggregate(stores, 2, max_age_ms=max_age)
        assert j["dead"] == t["dead"] == [0]
        assert t["ranks"]["0"]["age_ms"] >= 59_000
    fresh = json.dumps(dict(skewed, seq=1, ts=time.time() - 60.0)).encode()
    for store in stores:
        store["fleet/metrics/g0/0"] = fresh
    j, t = _both_aggregate(stores, 2, max_age_ms=2_000)
    assert j["dead"] == t["dead"] == []
    assert t["ranks"]["0"]["age_ms"] == j["ranks"]["0"]["age_ms"] == 0.0
    time.sleep(0.05)
    j, t = _both_aggregate(stores, 2, max_age_ms=40)
    assert j["dead"] == t["dead"] == [0]


def test_prometheus_fleet_text_equals_jax():
    stores = _stores([_digest(r, 5.0, _PHASES, world=3) for r in range(3)])
    j, t = _both_aggregate(stores, 3)
    # the same view through both exporters, and each side's own view
    assert jfm.to_prometheus_fleet(t) == tfm.to_prometheus_fleet(t)
    text = tfm.to_prometheus_fleet(t)
    assert text == jfm.to_prometheus_fleet(j)
    for r in range(3):
        assert f'pt_executor_steps_total{{rank="{r}"}}' in text
    assert 'pt_step_phase_seconds_sum{phase="device",rank="2"} 1.0' in text
    # a metric's own rank label survives as exported_rank
    view = copy.deepcopy(t)
    view["ranks"]["0"]["counters"]["pt_fleet_straggler_total"] = [
        {"labels": {"rank": "2"}, "value": 1.0}]
    text = tfm.to_prometheus_fleet(view)
    assert text == jfm.to_prometheus_fleet(view)
    assert 'pt_fleet_straggler_total{exported_rank="2",rank="0"} 1.0' in text


def test_epoch_summary_line_equals_jax():
    slow = {**_PHASES, "dispatch": 82.0}
    now = time.time()
    digests = [_digest(r, 85.0 if r == 2 else 5.0,
                       slow if r == 2 else _PHASES, ts=now)
               for r in range(3)]
    digests.append(_digest(3, 5.0, _PHASES, ts=now - 60.0))
    lines = []
    for (fm, _, _), store in zip(PKGS, _stores(digests)):
        assert fm.epoch_summary_line() is None   # no fleet attached
        fm.attach(_Fleet(0, 5, store, threading.Lock()))
        with pytest.warns(RuntimeWarning, match="straggler: rank 2"):
            lines.append(fm.epoch_summary_line())
    assert lines[0] == lines[1]
    assert "rank 2 (dispatch)" in lines[1] and "missing [4]" in lines[1]


def test_publish_rate_limits_and_drops_like_jax():
    for fm, flags, monitor in PKGS:
        store, lock = {}, threading.Lock()
        f = _Fleet(1, 2, store, lock)
        flags.set_flags({"fleet_metrics_interval_ms": 0})
        fm.maybe_publish(f)
        key = "fleet/metrics/g0/1"
        first = json.loads(store[key].decode())
        monitor.validate_fleet_digest(first)
        fm.maybe_publish(f)
        assert json.loads(store[key].decode())["seq"] == first["seq"] + 1
        flags.set_flags({"fleet_metrics_interval_ms": 3_600_000})
        before = store[key]
        fm.maybe_publish(f)
        assert store[key] is before
        assert monitor.counter(
            "pt_fleet_digests_published_total").value() == 2

        class _DeadPut(_Client):
            def put(self, key, value):
                raise OSError("kv down")

        dead = _Fleet(0, 2, {}, lock)
        dead._client = _DeadPut({}, lock)
        with pytest.warns(RuntimeWarning, match="digest publish failed"):
            fm.maybe_publish(dead, force=True)
        assert monitor.counter(
            "pt_fleet_digest_publish_drops_total").value() == 1
        # single-worker (no client): nothing to publish
        solo = _Fleet(0, 1, {}, lock)
        solo._client = None
        fm.maybe_publish(solo, force=True)


def test_local_view_without_fleet_and_reset():
    views = [fm.cluster_view() for fm, _, _ in PKGS]
    for v in views:
        assert v["world"] == 1 and list(v["ranks"]) == ["0"]
        assert v["ranks"]["0"]["dead"] is False
    assert set(views[0]) == set(views[1])
    # monitor.reset clears the attached fleet and the records
    tfm.attach(_Fleet(0, 2, {}, threading.Lock()))
    tmonitor.reset()
    assert tfm._fleet is None and tfm.straggler_records() == []


def test_coord_endpoint_raises_not_ported():
    f = _Fleet(0, 2, {}, threading.Lock(), endpoint="127.0.0.1:7000")
    with pytest.raises(NotImplementedError, match="native runtime"):
        tfm.aggregate(f)
    tfm.attach(f)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tfm.cluster_view()   # no silent fallback to another view


def test_straggler_flags_are_read_live():
    stores = _stores([_digest(r, 40.0 if r == 2 else 10.0, None, ts=None,
                              world=3) for r in range(3)])
    # 4x the median, +30 ms: named at the defaults
    with pytest.warns(RuntimeWarning):
        j, t = _both_aggregate(stores, 3)
    assert [r["rank"] for r in t["stragglers"]] == [2]
    for _, flags, _ in PKGS:
        flags.set_flags({"fleet_straggler_factor": 4.0})
    j, t = _both_aggregate(stores, 3)
    assert t["stragglers"] == j["stragglers"] == []
    for _, flags, _ in PKGS:
        flags.set_flags({"fleet_straggler_factor": 2.0,
                         "fleet_straggler_min_ms": 30})
    j, t = _both_aggregate(stores, 3)
    assert t["stragglers"] == j["stragglers"] == []
    # the staleness window follows fleet_metrics_interval_ms
    for _, flags, _ in PKGS:
        flags.set_flags({"fleet_metrics_interval_ms": 5_000})
    assert tfm._staleness_ms(None) == jfm._staleness_ms(None) == 20_000
