"""The port's host planes against the JAX package's, on the CPU: flags,
faults, retry and monitor.

- the flag tables are equal (``describe_flags()``), and the environment
  bootstrap parses the same raw strings to the same values;
- ``BUILTIN_SITES`` is equal, every builtin name resolves to a site the
  port declares, and ``arm`` accepts and refuses the same plans
  (hypothesis strings); seeded ``p=`` triggers fire at the same hits;
- ``RetryPolicy`` delays from one seed are the same sequence, and
  ``retry.call`` retries, gives up and meters alike;
- one scripted counter / gauge / histogram sequence gives equal
  ``to_prometheus()``, ``snapshot()`` and quantiles;
- step, stall, OOM and trace records pass both packages' validators;
- ``device_memory()`` is ``{}`` on the CPU in both; ``is_oom_error``
  knows the card's out-of-memory text, which the JAX heuristic misses;
- ``monitor.serve(port=0)`` on 127.0.0.1 answers the JAX routes, and
  ``/lint`` and ``/profile`` answer 501 naming the module the port does
  not have yet (``/fleet`` and ``/metrics?fleet=1`` answer since
  fleet_monitor.py).

Every comparison is exact: both sides are host Python over the same
inputs."""

import json
import random
import urllib.error
import urllib.request

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu import faults as jfaults
from paddle_tpu import flags as jflags
from paddle_tpu import monitor as jmonitor
from paddle_tpu import retry as jretry

# the package and the three modules that wire the training runtime's sites
# declare every port fault site
import paddle_tpu_torch.contrib.trainer  # noqa: F401
import paddle_tpu_torch.parallel.checkpoint  # noqa: F401
import paddle_tpu_torch.reader.pipeline  # noqa: F401
from paddle_tpu_torch import faults as tfaults
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch import retry as tretry

PACKAGES = {"jax": (jflags, jfaults, jretry, jmonitor),
            "torch": (tflags, tfaults, tretry, tmonitor)}


@pytest.fixture()
def telemetry():
    for flags, _, _, monitor in PACKAGES.values():
        flags.set_flags({"telemetry": True})
        monitor.reset()
    try:
        yield
    finally:
        for flags, _, _, monitor in PACKAGES.values():
            flags.set_flags({"telemetry": False})
            monitor.reset()


# --- flags ------------------------------------------------------------------


def test_flag_tables_are_equal():
    assert tflags.describe_flags() == jflags.describe_flags()
    assert len(tflags.describe_flags()) == 56


@pytest.mark.parametrize("raw", ["1", "true", "Yes", " on ", "0", "off",
                                 "no", "17", "-3", "2.5", "1e-3", "abc"])
def test_env_bootstrap_parses_the_same(raw, monkeypatch):
    """Every flag read from ``PT_FLAGS_<name>`` (and the ``FLAGS_<name>``
    spelling) becomes the same value, or fails the same way."""
    for i, (name, (ty, _d, _doc)) in enumerate(sorted(tflags._DEFS.items())):
        outcomes = []
        for flags in (jflags, tflags):
            try:
                outcomes.append(("ok", flags._parse(ty, raw)))
            except ValueError as e:
                outcomes.append(("err", type(e)))
        assert outcomes[0] == outcomes[1], (name, raw, outcomes)
    saved = {f: dict(f._values) for f in (jflags, tflags)}
    prefix = "PT_FLAGS_" if len(raw) % 2 else "FLAGS_"
    monkeypatch.setenv(prefix + "serve_queue_depth", "17")
    monkeypatch.setenv(prefix + "telemetry", raw)
    monkeypatch.setenv(prefix + "fault_plan", "")
    try:
        for flags in (jflags, tflags):
            flags._bootstrap()
        assert jflags._values == tflags._values
        assert tflags.get_flag("serve_queue_depth") == 17
    finally:
        for flags, values in saved.items():
            flags._values.clear()
            flags._values.update(values)


def test_set_flags_watchers_and_unknown_names():
    seen = []
    tflags.watch_flag("serve_max_restarts", seen.append)
    try:
        tflags.set_flags({"serve_max_restarts": "5"})
        assert seen[-1] == 5 and tflags.get_flag("serve_max_restarts") == 5
    finally:
        tflags.set_flags({"serve_max_restarts": 3})
        tflags._watchers["serve_max_restarts"].remove(seen.append)
    for flags in (jflags, tflags):
        with pytest.raises(KeyError, match="unknown flag"):
            flags.set_flags({"no_such_flag": 1})


# --- faults -----------------------------------------------------------------


def test_builtin_sites_are_equal_and_declared():
    assert tfaults.BUILTIN_SITES == jfaults.BUILTIN_SITES
    declared = set(tfaults.sites())
    missing = set(tfaults.BUILTIN_SITES) - declared
    assert not missing, missing
    wired = {"executor.step", "executor.fetch", "io.export",
             "serve.enqueue", "serve.prefill", "serve.decode",
             "serve.fetch", "router.route", "router.replica_crash",
             "router.handoff", "ckpt.write_shards", "ckpt.commit",
             "ckpt.read", "reader.next", "pipeline.prefetch"}
    assert set(tfaults.UNWIRED_SITES) == set(tfaults.BUILTIN_SITES) - wired


_SITE = st.sampled_from(sorted(jfaults.BUILTIN_SITES) + ["x.y", ""])
_ACTION = st.sampled_from(["raise", "raise(boom slot=2)", "delay(0)",
                           "delay(x)", "truncate(4)", "truncate",
                           "explode", "raise(", ""])
_TRIGGER = st.sampled_from(["1", "3,5", "p0.5", "P1", "", "x", "2,p0.1",
                            "0"])


@settings(max_examples=80, deadline=None)
@given(entries=st.lists(st.tuples(_SITE, _ACTION, _TRIGGER), max_size=3),
       sep=st.sampled_from([":", "-"]), at=st.sampled_from(["@", "#"]))
def test_arm_accepts_and_refuses_the_same_plans(entries, sep, at):
    plan = ";".join(f"{s}{sep}{a}{at}{t}" for s, a, t in entries)
    outcomes = []
    for faults in (jfaults, tfaults):
        try:
            faults.arm(plan, seed=0)
            outcomes.append(("armed", faults.active()))
        except ValueError as e:
            outcomes.append(("refused", str(e)))
        finally:
            faults.disarm()
    assert outcomes[0] == outcomes[1], (plan, outcomes)


def test_seeded_probability_triggers_fire_at_the_same_hits():
    fired = []
    for faults in (jfaults, tfaults):
        faults.arm("serve.fetch:raise@p0.3,2;serve.prefill:raise@p0.7",
                   seed=11)
        try:
            hits = []
            for name in ("serve.fetch", "serve.prefill"):
                site = faults.site(name)
                for i in range(64):
                    try:
                        site.hit()
                    except faults.InjectedFault as e:
                        assert e.site == name
                        hits.append((name, i + 1))
            fired.append(hits)
            assert [r["hit"] for r in faults.records()] == [
                h for _, h in hits]
        finally:
            faults.disarm()
    assert fired[0] == fired[1] and len(fired[0]) > 10


def test_disarmed_site_is_inert_and_delay_sleeps():
    site = tfaults.site("serve.enqueue")
    site.hit()  # nothing armed: a boolean check
    tfaults.arm("serve.enqueue:delay(0.01)@1")
    try:
        site.hit()
        assert tfaults.records() == [
            {"site": "serve.enqueue", "hit": 1, "action": "delay"}]
    finally:
        tfaults.disarm()


# --- retry ------------------------------------------------------------------


def test_retry_delays_are_the_same_sequence():
    seqs = []
    for retry in (jretry, tretry):
        pol = retry.RetryPolicy(base_delay=0.01, max_delay=0.7,
                                max_attempts=9)
        rng, prev, out = random.Random(42), None, []
        for _ in range(20):
            prev = pol.next_sleep(prev, rng)
            out.append(prev)
        seqs.append(out)
    assert seqs[0] == seqs[1]


def test_retry_call_retries_gives_up_and_meters(telemetry, monkeypatch):
    runs = []
    for retry, monitor in ((jretry, jmonitor), (tretry, tmonitor)):
        sleeps = []
        monkeypatch.setattr(retry, "_sleep", sleeps.append)
        left = [3]

        def flaky():
            left[0] -= 1
            if left[0] >= 0:
                raise OSError("transient")
            return "ok"

        pol = retry.RetryPolicy(base_delay=0.05, max_delay=1.0,
                                max_attempts=5)
        got = retry.call(flaky, site="drill", policy=pol,
                         rng=random.Random(3))
        with pytest.raises(TimeoutError):
            retry.call(lambda: (_ for _ in ()).throw(TimeoutError("t")),
                       site="drill2", policy=retry.RetryPolicy(
                           0.01, 0.02, max_attempts=2),
                       rng=random.Random(3))
        c = monitor.counter("pt_retry_total")
        runs.append((got, sleeps, [c.value(labels={"site": s,
                                                   "outcome": o})
                                   for s, o in (("drill", "retry"),
                                                ("drill", "success"),
                                                ("drill2", "exhausted"))]))
        d = retry.Deadline(5.0)
        assert 0 < d.remaining() <= 5.0 and not d.expired()
    assert runs[0] == runs[1]
    assert runs[1][2] == [3.0, 1.0, 1.0]


# --- monitor ----------------------------------------------------------------


@pytest.fixture()
def drill_metrics():
    """Drops the scripted instruments from both registries afterwards: a
    later test in the same process holds every registered ``pt_`` metric
    to a README entry."""
    yield
    for _, _, _, monitor in PACKAGES.values():
        for name in ("pt_planes_drill_total", "pt_planes_drill_gauge",
                     "pt_planes_drill_seconds"):
            monitor._REGISTRY.pop(name, None)


def _script(monitor):
    c = monitor.counter("pt_planes_drill_total", "a scripted counter")
    g = monitor.gauge("pt_planes_drill_gauge", "a scripted gauge")
    h = monitor.histogram("pt_planes_drill_seconds", "a scripted histogram",
                          buckets=(0.001, 0.01, 0.1, 1.0))
    r = random.Random(5)
    for i in range(200):
        c.inc(labels={"kind": "ab"[i % 2]})
        g.set(r.uniform(-1, 1), labels={"slot": str(i % 3)})
        h.observe(r.expovariate(30.0), labels={"route": "xy"[i % 2]})
    g.add(2.5, labels={"slot": "0"})
    # past the label cap: one overflow cell, counted
    for i in range(300):
        c.inc(labels={"kind": f"k{i}"})
    return h


def test_scripted_metrics_give_equal_text_and_quantiles(telemetry,
                                                        drill_metrics):
    hists = [_script(monitor) for _, _, _, monitor in PACKAGES.values()]
    assert tmonitor.QUANTILE_LABELS == jmonitor.QUANTILE_LABELS

    def mine(text):
        return "\n".join(line for line in text.splitlines()
                         if "pt_planes_drill" in line
                         or "pt_metric_label_overflow" in line)

    assert mine(tmonitor.to_prometheus()) == mine(jmonitor.to_prometheus())
    snaps = [{k: v for k, v in m.snapshot().items()
              if "pt_planes_drill" in k}
             for m in (jmonitor, tmonitor)]
    assert snaps[0] == snaps[1] and len(snaps[0]) == 3
    for _, q in tmonitor.QUANTILE_LABELS:
        for route in "xy":
            lab = {"route": route}
            assert hists[1].quantile(q, labels=lab) == hists[0].quantile(
                q, labels=lab)
    assert json.loads(tmonitor.to_json()) is not None


def test_records_pass_both_validators(telemetry):
    """A step record the port's executor logs, a stall record, an OOM
    record and the trace export pass both packages' validators."""
    import numpy as np

    import paddle_tpu_torch as tfluid

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4], dtype="float32")
        y = tfluid.layers.fc(x, 3)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                    fetch_list=[y])
        exe.run_steps(main, [{"x": np.ones((2, 4), np.float32)}], 2, [y])
    recs = tmonitor.recent_steps()
    assert [r["kind"] for r in recs] == ["step"] * 4 + ["window"]
    assert recs[1]["cache"] == "miss" and recs[2]["cache"] == "hit"
    for rec in recs:
        tmonitor.validate_step_record(rec)
        jmonitor.validate_step_record(rec)
    assert tmonitor.counter("pt_executor_steps_total").value() == 6
    for monitor in (jmonitor, tmonitor):
        monitor._record_stall("serve.decode", 250.0, "loop", ("a", "b"))
    stall_keys = [sorted(m.stalls()[-1]) for m in (jmonitor, tmonitor)]
    assert stall_keys[0] == stall_keys[1]
    err = RuntimeError("RESOURCE_EXHAUSTED: drill")
    tmonitor.maybe_record_oom(err, program=main, phase="serve")
    rec = tmonitor.oom_records()[-1]
    for monitor in (jmonitor, tmonitor):
        monitor.validate_oom_report(rec)
    assert rec["phase"] == "serve" and rec["device_memory"] == {}
    trace = tmonitor.trace_snapshot()
    assert set(trace) == set(jmonitor.trace_snapshot())


def test_device_memory_is_empty_on_the_cpu_and_oom_text():
    assert tmonitor.device_memory() == {} == jmonitor.device_memory()
    cuda_oom = RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert tmonitor.is_oom_error(cuda_oom)
    assert not jmonitor.is_oom_error(cuda_oom)  # the text JAX would miss
    for text in ("RESOURCE_EXHAUSTED: x", "Out of memory while trying"):
        assert tmonitor.is_oom_error(RuntimeError(text))
        assert jmonitor.is_oom_error(RuntimeError(text))
    assert not tmonitor.is_oom_error(RuntimeError("illegal address"))
    import torch

    assert tmonitor.is_oom_error(torch.OutOfMemoryError("x"))
    assert tmonitor._largest_live_buffers() == []


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_server_answers_the_routes_and_501s_the_missing(telemetry):
    assert set(tmonitor.ROUTES) == set(jmonitor.ROUTES)
    port = tmonitor.serve(port=0, host="127.0.0.1")
    try:
        index = json.loads(_get(port, "/")[1])
        assert set(index["routes"]) == set(jmonitor.ROUTES)
        for path in ("/metrics", "/healthz", "/steps?n=2", "/compile",
                     "/numerics", "/trace", "/serve", "/requests",
                     "/fleet", "/metrics?fleet=1"):
            code, body = _get(port, path)
            assert code == 200, (path, code, body[:200])
        assert json.loads(_get(port, "/serve")[1])["engine_count"] >= 0
        assert json.loads(_get(port, "/fleet")[1])["world"] == 1
        for path, module in (("/lint", "analysis.py"),
                             ("/profile", "roofline.py")):
            code, body = _get(port, path)
            assert code == 501 and module in body, (path, code, body)
        assert _get(port, "/nope")[0] == 404
    finally:
        tmonitor.stop_server()
