"""The port's fleet front door (paddle_tpu_torch/fleet_serving.py) on the
CPU: the contracts of tests/test_fleet_serving.py, each stream held to
the JAX package's single ``ServingEngine`` run in the calling thread on
the same weights (the JAX startup's arrays carried across by
``io.scope_from_numpy``), greedy token for token.

- routing: streams equal the oracle and a cold fleet spreads; the router
  prefers the less loaded replica; it sheds only when every replica
  refuses; a ``router.route`` failure surfaces and the next submit
  routes;
- the kill-one-replica drill (``router.replica_crash``): monotone streams
  equal to the oracle, one trace tid a request; a replica killed while
  requests are still queued (replay from scratch); a drain torn by
  ``router.handoff``; an exhausted restart budget handed to the fleet;
- rollout and autoscale: a rolling rollout rejects nothing and tags
  generations, to the same weights and to a second seeded weight set
  (each stream equals the oracle of its generation's weights); the
  autoscaler both ways; a spun-up replica lowers and captures exactly
  its programs, no more (the port has no compile cache: the JAX test of
  zero fresh compiles becomes this count);
- observability and lifecycle: ``fleet_view`` and the ``/fleet`` route's
  ``serving_fleet`` section, the routed counter, ``close`` finishing
  every handle, the router sites registered and wired, a pump error
  counted in ``stats()``, and replicas on the card unless the CPU is
  asked for.

Every wait has a timeout; fault-plan delays keep a drill mid-flight."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu as pfluid
from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as T

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import faults, fleet_serving, flags, monitor, serving
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.models import transformer as TT

BOS, EOS = 0, 1
CPU = tfluid.CPUPlace()
_CFG = dict(src_vocab_size=37, trg_vocab_size=41, max_length=64, d_model=16,
            d_inner=32, n_head=2, n_layer=1, dropout=0.0,
            label_smooth_eps=0.0)


def _jax_weights(seed):
    cfg = T.TransformerConfig(**_CFG)
    scope = pfluid.Scope()
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        T.build(cfg, is_test=True)
    if seed is not None:
        startup.random_seed = seed
    with pfluid.scope_guard(scope):
        pfluid.Executor(pfluid.CPUPlace()).run(startup)
    return cfg, scope


def _port(jscope):
    params = {n: np.asarray(jscope.find_var(n)) for n in jscope.var_names()}
    return tio.scope_from_numpy(params, CPU)


@pytest.fixture(scope="module")
def jweights():
    return _jax_weights(None)


@pytest.fixture(scope="module")
def weights(jweights):
    return TT.TransformerConfig(**_CFG), _port(jweights[1])


@pytest.fixture(scope="module")
def jweights2():
    return _jax_weights(77)


def _srcs(k, seed=0, lens=(5, 3, 7, 4, 6, 2, 8, 5)):
    r = np.random.RandomState(seed)
    return [r.randint(2, 37, (lens[i % len(lens)],)).astype(np.int64)
            for i in range(k)]


_ORACLE = {}


def _oracle(jweights, srcs, slots=2, max_new_tokens=None):
    """Greedy streams of the JAX package's single ServingEngine, stepped
    in this thread, each request alone at the fleet's slot geometry."""
    key = (id(jweights), tuple(tuple(s) for s in srcs), slots,
           max_new_tokens)
    if key not in _ORACLE:
        cfg, scope = jweights
        eng = jserving.ServingEngine(cfg, scope, slots=slots, src_len=8,
                                     max_len=12, bos_id=BOS, end_id=EOS)
        out = []
        for s in srcs:
            q = eng.submit(s, max_new_tokens=max_new_tokens)
            eng.run_until_idle()
            out.append(list(q.tokens))
        eng.close()
        _ORACLE[key] = out
    return _ORACLE[key]


def _fleet(weights, replicas=3, **kw):
    cfg, scope = weights
    kw.setdefault("slots", 2)
    kw.setdefault("src_len", 8)
    kw.setdefault("max_len", 12)
    kw.setdefault("bos_id", BOS)
    kw.setdefault("end_id", EOS)
    kw.setdefault("poll_s", 0.005)
    kw.setdefault("place", CPU)
    return fleet_serving.ServingFleet(cfg, scope, replicas=replicas, **kw)


def _wait_tokens(frs, n=1, timeout=60.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if all(len(fr.tokens) >= n or fr.done for fr in frs):
            return
        time.sleep(0.002)
    raise TimeoutError("requests never reached mid-decode")


@pytest.fixture()
def telemetry():
    flags.set_flags({"telemetry": True})
    try:
        yield
    finally:
        flags.set_flags({"telemetry": False})


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    faults.disarm()


def _no_pump_errors(fleet):
    st = fleet.stats()
    assert st["pump_errors"] == 0, st["last_pump_error"]


# --- routing ------------------------------------------------------------------


def test_fleet_streams_byte_identical_and_spread(weights, jweights):
    srcs = _srcs(6, seed=7)
    clean = _oracle(jweights, srcs)
    fleet = _fleet(weights, replicas=3)
    try:
        frs = [fleet.submit(s) for s in srcs]
        streams = [fr.result(timeout=60) for fr in frs]
        assert streams == clean
        assert len({fr.replica_id for fr in frs}) > 1
        assert all(fr.generation == 0 for fr in frs)
        assert all(fr.outcome in ("completed", "length") for fr in frs)
        _no_pump_errors(fleet)
    finally:
        fleet.close()


def test_router_prefers_less_loaded_replica(weights):
    fleet = _fleet(weights, replicas=2, slots=1)
    try:
        faults.arm("serve.decode:delay(0.05)@p1.0", seed=3)
        try:
            first = [fleet.submit(s, max_new_tokens=6)
                     for s in _srcs(2, seed=9)]
            loaded = {fr.replica_id for fr in first}
            nxt = fleet.submit(_srcs(1, seed=10)[0], max_new_tokens=2)
            assert nxt.replica_id in {r["replica"]
                                      for r in fleet.stats()["replicas"]}
            assert len(loaded) == 2  # the cold spread
        finally:
            faults.disarm()
        for fr in first + [nxt]:
            fr.result(timeout=60)
    finally:
        fleet.close()


def test_fleet_sheds_only_when_every_replica_refuses(weights, telemetry):
    shed0 = monitor.counter("pt_fleet_serve_shed_total").value(
        labels={"kind": "queue_full"})
    fleet = _fleet(weights, replicas=2, slots=1, queue_depth=1)
    try:
        faults.arm("serve.decode:delay(0.1)@p1.0", seed=5)
        try:
            srcs = _srcs(8, seed=21)
            # one request in each replica's slot first (the cold spread),
            # so the capacity below does not race the loops' admissions
            admitted = [fleet.submit(s, max_new_tokens=4) for s in srcs[:2]]
            t0 = time.time()
            while (fleet.stats()["queue_depth"] > 0
                   and time.time() - t0 < 30):
                time.sleep(0.002)
            with pytest.raises(serving.QueueFull):
                for s in srcs[2:]:
                    admitted.append(fleet.submit(s, max_new_tokens=4))
        finally:
            faults.disarm()
        # capacity: 2 replicas x (1 slot + 1 queue entry), spilled across
        # BOTH replicas
        assert len(admitted) == 4
        assert len({fr.replica_id for fr in admitted}) == 2
        assert monitor.counter("pt_fleet_serve_shed_total").value(
            labels={"kind": "queue_full"}) > shed0
        assert fleet.stats()["shed"] >= 1
        for fr in admitted:
            fr.result(timeout=120)
    finally:
        fleet.close()


def test_router_route_site_failure_surfaces(weights, jweights):
    clean = _oracle(jweights, _srcs(1, seed=33))
    fleet = _fleet(weights, replicas=2)
    try:
        faults.arm("router.route:raise(routing torn)@1")
        try:
            with pytest.raises(faults.InjectedFault):
                fleet.submit(_srcs(1, seed=33)[0])
            assert fleet.stats()["in_flight"] == 0
            assert sum(r["routed"] for r in fleet.stats()["replicas"]) == 0
            fr = fleet.submit(_srcs(1, seed=33)[0])  # hit 2: clean
        finally:
            faults.disarm()
        assert fr.result(timeout=60) == clean[0]
    finally:
        fleet.close()


# --- the kill-one-replica drill and the journal's edge cases ------------------


def test_kill_one_replica_mid_decode_chaos_drill(weights, jweights,
                                                 telemetry, tmp_path):
    flags.set_flags({"trace_dir": str(tmp_path)})
    srcs = _srcs(6, seed=41)
    clean = _oracle(jweights, srcs, max_new_tokens=8)
    fleet = _fleet(weights, replicas=3)
    try:
        faults.arm("serve.decode:delay(0.03)@p1.0", seed=11)
        frs = [fleet.submit(s, max_new_tokens=8) for s in srcs]
        _wait_tokens(frs, n=1)
        snapshots = {id(fr): list(fr.tokens) for fr in frs}
        views = {id(fr): [] for fr in frs}
        stop = threading.Event()

        def watch():  # the client's view, read throughout the failover
            while not stop.is_set():
                for fr in frs:
                    views[id(fr)].append(list(fr.tokens))
                time.sleep(0.001)

        watcher = threading.Thread(target=watch)
        watcher.start()
        # the victim: the lowest-id live replica still holding work (a
        # request may end on EOS early)
        live = sorted(fleet._replicas.values(), key=lambda r: r.id)
        victim = next(i for i, rep in enumerate(live)
                      if any(fr.replica_id == rep.id and not fr.done
                             for fr in frs))
        faults.arm("serve.decode:delay(0.03)@p1.0;"
                   f"router.replica_crash:raise(replica={victim})@1",
                   seed=11)
        try:
            streams = []
            for fr in frs:
                streams.append(fr.result(timeout=120))
                pre = snapshots[id(fr)]
                assert streams[-1][:len(pre)] == pre
        finally:
            faults.disarm()
            stop.set()
            watcher.join(30)
        assert not watcher.is_alive()
        assert streams == clean
        # monotone: every view the client read is a prefix of the next
        for fr, final in zip(frs, streams):
            seen = views[id(fr)] + [final]
            for a, b in zip(seen, seen[1:]):
                assert b[:len(a)] == a, (a, b)
        assert fleet.failovers >= 1
        assert fleet.stats()["replica_count"] == 2
        rehomed = [fr for fr in frs if fr.failovers >= 1]
        assert rehomed, "the kill landed on a replica with no work"
        for fr in rehomed:
            evs = [e for e in monitor.trace_events()
                   if e.get("args", {}).get("req") == fr.trace_id]
            assert {e["tid"] for e in evs} == {fr.trace_tid}
            assert [e["name"] for e in evs].count("submit") == 1
        _no_pump_errors(fleet)
    finally:
        fleet.close()
        flags.set_flags({"trace_dir": ""})


def test_replica_dies_mid_prefill_replays_from_scratch(weights, jweights):
    srcs = _srcs(6, seed=55)
    clean = _oracle(jweights, srcs, slots=1, max_new_tokens=6)
    fleet = _fleet(weights, replicas=2, slots=1)
    try:
        faults.arm("serve.decode:delay(0.04)@p1.0;"
                   "router.replica_crash:raise(replica=0)@3", seed=13)
        try:
            frs = [fleet.submit(s, max_new_tokens=6) for s in srcs]
            streams = [fr.result(timeout=120) for fr in frs]
        finally:
            faults.disarm()
        assert streams == clean
        assert fleet.failovers >= 1
        rehomed = [fr for fr in frs if fr.failovers >= 1]
        assert rehomed
        for fr in rehomed:
            assert fr.outcome in ("completed", "length")
    finally:
        fleet.close()


def test_replica_dies_during_drain_handoff(weights, jweights):
    cfg, scope = weights
    srcs = _srcs(4, seed=61)
    clean = _oracle(jweights, srcs, max_new_tokens=8)
    fleet = _fleet(weights, replicas=2)
    try:
        faults.arm("serve.decode:delay(0.03)@p1.0;"
                   "router.handoff:raise(handoff torn)@1", seed=17)
        try:
            frs = [fleet.submit(s, max_new_tokens=8) for s in srcs]
            _wait_tokens(frs, n=1)
            out = fleet.rollout(scope)
        finally:
            faults.disarm()
        assert out["replicas_rotated"] == 2
        streams = [fr.result(timeout=120) for fr in frs]
        assert streams == clean
        assert all(fr.outcome in ("completed", "length") for fr in frs)
    finally:
        fleet.close()


def test_budget_exhausted_supervisor_hands_off_to_fleet(weights, jweights):
    srcs = _srcs(4, seed=71)
    clean = _oracle(jweights, srcs, max_new_tokens=6)
    fleet = _fleet(weights, replicas=2, max_restarts=0)
    try:
        faults.arm("serve.decode:delay(0.02)@p1.0;"
                   "serve.decode:raise(engine fatal)@4", seed=19)
        try:
            frs = [fleet.submit(s, max_new_tokens=6) for s in srcs]
            streams = [fr.result(timeout=120) for fr in frs]
        finally:
            faults.disarm()
        assert streams == clean
        assert all(fr.outcome in ("completed", "length") for fr in frs)
        t0 = time.time()
        while fleet.stats()["replica_count"] != 1 and time.time() - t0 < 10:
            time.sleep(0.01)
        assert fleet.stats()["replica_count"] == 1
        assert fleet.failovers >= 1
    finally:
        fleet.close()


# --- rolling rollout and autoscale --------------------------------------------


def test_rolling_rollout_zero_downtime(weights, jweights):
    cfg, scope = weights
    srcs = _srcs(8, seed=81)
    clean = _oracle(jweights, srcs, max_new_tokens=6)
    fleet = _fleet(weights, replicas=2)
    try:
        faults.arm("serve.decode:delay(0.02)@p1.0", seed=23)
        try:
            pre = [fleet.submit(s, max_new_tokens=6) for s in srcs[:4]]
            _wait_tokens(pre, n=1)
            out = fleet.rollout(scope)  # same weights, new generation
            post = [fleet.submit(s, max_new_tokens=6) for s in srcs[4:]]
            streams = [fr.result(timeout=120) for fr in pre + post]
        finally:
            faults.disarm()
        assert streams == clean
        assert out == {"generation": 1, "replicas_rotated": 2,
                       "replicas": 2}
        assert all(fr.outcome in ("completed", "length")
                   for fr in pre + post)
        assert all(fr.generation == 1 for fr in post)
        assert all(r["generation"] == 1 for r in fleet.stats()["replicas"])
        assert fleet.stats()["generation"] == 1
        _no_pump_errors(fleet)
    finally:
        fleet.close()


def test_rollout_to_a_second_weight_set(weights, jweights, jweights2):
    """A rollout to other weights: every stream equals the oracle on the
    weights of the generation that served it, and requests admitted after
    the rollout see the new weights."""
    srcs = _srcs(8, seed=83)
    fleet = _fleet(weights, replicas=2)
    try:
        faults.arm("serve.decode:delay(0.02)@p1.0", seed=29)
        try:
            pre = [fleet.submit(s, max_new_tokens=6) for s in srcs[:4]]
            _wait_tokens(pre, n=1)
            out = fleet.rollout(_port(jweights2[1]))
            post = [fleet.submit(s, max_new_tokens=6) for s in srcs[4:]]
            streams = [fr.result(timeout=120) for fr in pre + post]
        finally:
            faults.disarm()
        assert out["generation"] == 1 and out["replicas_rotated"] == 2
        oracles = {0: _oracle(jweights, srcs, max_new_tokens=6),
                   1: _oracle(jweights2, srcs, max_new_tokens=6)}
        assert oracles[0] != oracles[1]
        for i, (fr, got) in enumerate(zip(pre + post, streams)):
            assert fr.outcome in ("completed", "length")
            assert got == oracles[fr.generation][i], (i, fr.generation)
        assert all(fr.generation == 1 for fr in post)
    finally:
        fleet.close()


@pytest.fixture()
def autoscale_flags():
    flags.set_flags({"serve_fleet_autoscale_window": 2,
                     "serve_fleet_scale_down_idle_ticks": 3,
                     "serve_fleet_scale_up_queue_factor": 0.5})
    try:
        yield
    finally:
        flags.set_flags({
            name: flags._DEFS[name][1]
            for name in ("serve_fleet_autoscale_window",
                         "serve_fleet_scale_down_idle_ticks",
                         "serve_fleet_scale_up_queue_factor")})


def test_autoscale_up_under_saturation_and_down_when_idle(weights,
                                                          autoscale_flags):
    fleet = _fleet(weights, replicas=1, slots=1, queue_depth=2,
                   min_replicas=1, max_replicas=2)
    try:
        faults.arm("serve.decode:delay(0.05)@p1.0", seed=29)
        try:
            srcs = _srcs(3, seed=91)
            frs = [fleet.submit(srcs[0], max_new_tokens=4)]
            t0 = time.time()
            while (fleet.stats()["queue_depth"] > 0
                   and time.time() - t0 < 30):
                time.sleep(0.002)
            frs += [fleet.submit(s, max_new_tokens=4) for s in srcs[1:]]
            acts = [fleet.autoscale_tick() for _ in range(2)]
            assert acts[-1] == "up"
            assert fleet.stats()["replica_count"] == 2
            assert fleet.scale_ups == 1
        finally:
            faults.disarm()
        for fr in frs:
            fr.result(timeout=120)
        assert fleet.drain(timeout_s=60)
        acts = [fleet.autoscale_tick() for _ in range(3)]
        assert acts[-1] == "down"
        assert fleet.stats()["replica_count"] == 1
        assert fleet.scale_downs == 1
        fr = fleet.submit(_srcs(1, seed=92)[0], max_new_tokens=2)
        assert fr.result(timeout=60) is not None
    finally:
        fleet.close()


def _costs(rep):
    """(uids of the programs a replica's engine lowered, its runners that
    made their captured call, its programs that ran twice or more): on
    the CPU a runner that made its captured call is bound."""
    eng = rep.sup.engine
    exe = eng._exe
    bound = sum(r._bound for rs in exe._runners.values() for r in rs.values())
    twice = sum(1 for n in eng._runs.values() if n >= 2)
    return {key[0] for key in exe._cache}, bound, twice


def test_spun_up_replica_lowers_exactly_its_programs(weights, jweights,
                                                     autoscale_flags):
    """The port's counterpart of the zero-fresh-compile spin-up: a
    replica the autoscaler adds lowers its prefill and decode programs
    and captures each one it runs twice, no more, and the warm replica
    lowers nothing more for the spin-up; both serve the oracle's
    tokens."""
    srcs = _srcs(4, seed=93)
    clean = _oracle(jweights, srcs, slots=1, max_new_tokens=4)
    fleet = _fleet(weights, replicas=1, slots=1, queue_depth=4,
                   min_replicas=1, max_replicas=2)
    try:
        for i in (0, 1):
            got = fleet.submit(srcs[i], max_new_tokens=4).result(timeout=60)
            assert got == clean[i]
        (warm,) = fleet._replicas.values()
        progs = warm.sup.engine._progs
        serving_uids = {progs["prefill_program"]._uid,
                        progs["decode_program"]._uid}
        warm_costs = _costs(warm)
        assert warm_costs == (serving_uids, 2, 2)
        faults.arm("serve.decode:delay(0.05)@p1.0", seed=31)
        try:
            frs = [fleet.submit(s, max_new_tokens=4) for s in srcs[1:]]
            acts = [fleet.autoscale_tick() for _ in range(2)]
            assert acts[-1] == "up"
        finally:
            faults.disarm()
        (new,) = [r for r in fleet._replicas.values() if r is not warm]
        assert _costs(new) == (set(), 0, 0)   # nothing lowered before work
        more = [fleet.submit(s, max_new_tokens=4) for s in srcs[1:]]
        got = [fr.result(timeout=120) for fr in frs + more]
        assert got == clean[1:] + clean[1:]
        assert new.routed >= 1
        nprogs = new.sup.engine._progs
        lowered, bound, twice = _costs(new)
        assert lowered == {nprogs["prefill_program"]._uid,
                           nprogs["decode_program"]._uid}
        assert bound == twice <= 2
        assert _costs(warm) == warm_costs
        _no_pump_errors(fleet)
    finally:
        fleet.close()


# --- observability and lifecycle ----------------------------------------------


def test_fleet_view_and_request_records(weights, telemetry):
    assert fleet_serving.fleet_view() is None
    routed0 = monitor.counter("pt_fleet_serve_routed_total").value()
    fleet = _fleet(weights, replicas=2)
    try:
        frs = [fleet.submit(s) for s in _srcs(3, seed=95)]
        for fr in frs:
            fr.result(timeout=60)
        view = fleet_serving.fleet_view()
        assert view is not None and view["fleet_count"] == 1
        row = view["fleets"][0]
        assert row["replica_count"] == 2 and row["generation"] == 0
        for rep in row["replicas"]:
            assert rep["state"] == "serving"
            assert {"queue_depth", "generation",
                    "heartbeat_age_ms"} <= set(rep)
        assert sum(r["routed"] for r in row["replicas"]) == 3
        assert monitor.counter(
            "pt_fleet_serve_routed_total").value() == routed0 + 3
        assert all(fr.replica_id in {r["replica"] for r in row["replicas"]}
                   for fr in frs)
        assert all(fr.ttft_s is not None and fr.replays == 0 for fr in frs)
        # the /fleet route carries the same section
        port = monitor.serve(port=0, host="127.0.0.1")
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/fleet", timeout=10) as r:
                body = json.loads(r.read().decode())
        finally:
            monitor.stop_server()
        assert body["serving_fleet"]["fleets"][0]["replica_count"] == 2
        assert body["world"] == 1
    finally:
        fleet.close()
    assert fleet_serving.fleet_view() is None


def test_close_finishes_every_handle(weights):
    fleet = _fleet(weights, replicas=2)
    faults.arm("serve.decode:delay(0.05)@p1.0", seed=31)
    try:
        frs = [fleet.submit(s, max_new_tokens=8) for s in _srcs(4, seed=97)]
    finally:
        faults.disarm()
    fleet.close(drain_timeout_s=0.2)
    for fr in frs:
        assert fr.result(timeout=10) is not None
        assert fr.outcome is not None
    with pytest.raises(fleet_serving.FleetClosed):
        fleet.submit(_srcs(1)[0])


def test_router_fault_sites_registered():
    names = set(faults.sites())
    assert {"router.route", "router.replica_crash",
            "router.handoff"} <= names
    for s in ("router.route", "router.replica_crash", "router.handoff"):
        assert faults.BUILTIN_SITES[s]
        assert s not in faults.UNWIRED_SITES


def test_pump_error_is_swallowed_and_counted(weights, monkeypatch):
    fleet = _fleet(weights, replicas=1)
    try:
        boom = iter([RuntimeError("tick torn")] * 3)

        def tick():
            err = next(boom, None)
            if err is not None:
                raise err

        monkeypatch.setattr(fleet, "_pump_tick", tick)
        with pytest.warns(RuntimeWarning, match="pump error"):
            t0 = time.time()
            while fleet.stats()["pump_errors"] < 3 and time.time() - t0 < 30:
                time.sleep(0.01)
        st = fleet.stats()
        assert st["pump_errors"] == 3
        assert st["last_pump_error"] == "RuntimeError: tick torn"
    finally:
        fleet.close()


def test_replicas_run_on_the_card_unless_asked(weights):
    """Without ``place`` the replicas' engines are on CUDAPlace(0): here,
    with no CUDA device, building the fleet raises."""
    cfg, scope = weights
    with pytest.raises(RuntimeError, match="is_available"):
        fleet_serving.ServingFleet(cfg, scope, replicas=1, slots=1,
                                   src_len=8, max_len=12)
    fleet = _fleet(weights, replicas=1)
    try:
        eng = fleet.stats()["replicas"][0]["engine_id"]
        assert eng is not None
        (rep,) = fleet._replicas.values()
        assert rep.sup.engine._exe.device.type == "cpu"
    finally:
        fleet.close()


def test_serve_fleet_front_end_and_no_replica(weights):
    cfg, scope = weights
    fleet = fleet_serving.serve_fleet(cfg, scope, replicas=2, slots=1,
                                      src_len=8, max_len=12, place=CPU,
                                      poll_s=0.005)
    try:
        assert fleet.stats()["replica_count"] == 2
        for rep in list(fleet._replicas.values()):
            fleet._retire_replica(rep, cause="handoff")
        with pytest.raises(fleet_serving.NoReplicaAvailable):
            fleet.submit(_srcs(1)[0])
        assert fleet.stats()["shed"] == 1
    finally:
        fleet.close()
