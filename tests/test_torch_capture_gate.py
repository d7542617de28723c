"""The process-wide capture gate (core/lowering.py ``GATE``) and the
thread-safe kernel bookkeeping beside it (kernels.py), on the CPU.

The CPU runs no CUDA graph, but a runner's first captured call takes the
gate alone and records its launches as a capture does, so the
bookkeeping the card relies on runs here:

- a capture excludes a concurrent run of another executor, which waits
  and then completes;
- an engine whose loop thread waits for the gate is not wedge-armed,
  its heartbeat counts from the end of the wait, and a supervisor with a
  short watchdog does not restart a replica held back past it;
- two threads that build (or load) one source build it once;
- a capture's ``launch_delta`` leaves out another thread's launches, and
  launch counts from many threads add up.

Every wait on a thread has a timeout."""

import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import kernels, layers, serving
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.core.lowering import GATE
from paddle_tpu_torch.models import transformer as TT

CPU = tfluid.CPUPlace()
_CFG = dict(src_vocab_size=37, trg_vocab_size=41, max_length=64, d_model=16,
            d_inner=32, n_head=2, n_layer=1, dropout=0.0,
            label_smooth_eps=0.0)


def _program():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = layers.data("x", shape=[4], dtype="float32")
        y = layers.fc(x, 3)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
    return main, y, exe, scope


def _run(main, y, exe, scope):
    return exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                   fetch_list=[y], scope=scope)


def _blocking(exe, before=None):
    """Make the block of ``exe``'s one cached program wait on an event
    when it runs: returns (entered, release)."""
    (lowered,) = [lw for lw in exe._cache.values() if lw.fetch_names]
    entered, release = threading.Event(), threading.Event()
    fn = lowered.fn

    def blocking(*a, **k):
        if before is not None:
            before()
        entered.set()
        assert release.wait(30), "never released"
        return fn(*a, **k)

    lowered.fn = blocking
    return entered, release


def _wait_for(pred, timeout=30.0):
    t0 = time.perf_counter()
    while not pred():
        assert time.perf_counter() - t0 < timeout, "timed out"
        time.sleep(0.002)


def test_capture_excludes_a_concurrent_run():
    a = _program()
    b = _program()
    _run(*a)               # eager first calls
    _run(*b)
    GATE.reset_stats()
    entered, release = _blocking(a[2])
    capture = threading.Thread(target=_run, args=a)
    capture.start()        # a's second call: the capture, held open
    assert entered.wait(30)
    done, ident = threading.Event(), []

    def other():
        ident.append(threading.get_ident())
        _run(*b)
        done.set()

    runner = threading.Thread(target=other)
    runner.start()
    _wait_for(lambda: ident and GATE.waiting(ident[0]))
    assert not done.is_set()        # held back while the capture runs
    release.set()
    capture.join(30)
    runner.join(30)
    assert not capture.is_alive() and not runner.is_alive()
    assert done.is_set()
    stats = GATE.stats()
    assert stats["captures"] >= 1 and stats["capture_failures"] == 0
    assert stats["held_back"] >= 1 and stats["longest_hold_back_s"] > 0
    assert GATE.wait_ended(ident[0]) > 0


def test_a_waiting_capture_goes_before_new_shared_holders():
    """A capture that waits for a run in progress is served before a run
    that asks later: a busy fleet cannot starve it."""
    order = []
    held = threading.Event()
    free = threading.Event()

    def reader():
        with GATE.shared():
            held.set()
            assert free.wait(30)
        order.append("first reader")

    def capture():
        with GATE.exclusive():
            order.append("capture")

    def late_reader():
        with GATE.shared():
            order.append("late reader")

    t1 = threading.Thread(target=reader)
    t1.start()
    assert held.wait(30)
    t2 = threading.Thread(target=capture)
    t2.start()
    _wait_for(lambda: GATE._writers_waiting == 1)
    t3 = threading.Thread(target=late_reader)
    t3.start()
    _wait_for(lambda: GATE.waiting(t3.ident))
    free.set()
    for t in (t1, t2, t3):
        t.join(30)
        assert not t.is_alive()
    assert order.index("capture") < order.index("late reader")


def test_shared_holder_that_captures_gives_its_hold_back():
    """A thread inside a run (shared) whose runner captures waits for the
    other holders without deadlocking on its own hold, and holds the gate
    shared again after the capture."""
    with GATE.shared():
        with GATE.shared():
            with GATE.exclusive():
                assert GATE._writer == threading.get_ident()
                assert GATE._readers == 0
                with GATE.shared():   # nested inside the capture
                    pass
            assert GATE._writer is None and GATE._readers == 1
    assert GATE._readers == 0


def _engine(scope, **kw):
    return serving.ServingEngine(TT.TransformerConfig(**_CFG), scope,
                                 slots=2, src_len=8, max_len=10, bos_id=0,
                                 end_id=1, place=CPU, **kw)


@pytest.fixture(scope="module")
def weights():
    cfg = TT.TransformerConfig(**_CFG)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        TT.build(cfg, is_test=True)
    startup.random_seed = 5
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        tfluid.Executor(CPU).run(startup)
    return scope


def _srcs(k, seed=0):
    r = np.random.RandomState(seed)
    return [r.randint(2, 37, (n,)).astype(np.int64)
            for n in (5, 3, 7, 4, 6, 2, 8, 5)[:k]]


def test_waiting_engine_is_not_wedge_armed(weights):
    eng = _engine(weights)
    for s in _srcs(2):
        eng.submit(s, max_new_tokens=3)
    eng.run_until_idle()            # every program lowered and captured
    eng.submit(_srcs(1, seed=1)[0], max_new_tokens=6)
    eng.step()                      # admitted, its decode step dispatched
    assert eng._wedge_armed()
    holding, free = threading.Event(), threading.Event()

    def capture():                  # another executor's capture
        with GATE.exclusive():
            holding.set()
            assert free.wait(30)

    cap = threading.Thread(target=capture)
    cap.start()
    assert holding.wait(30)
    stepper = threading.Thread(target=eng.step)
    stepper.start()
    _wait_for(lambda: GATE.waiting(stepper.ident))
    time.sleep(0.2)
    assert not eng._wedge_armed()   # waiting: not a wedge
    assert eng.heartbeat_age_s() >= 0.2
    free.set()
    cap.join(30)
    stepper.join(30)
    assert not cap.is_alive() and not stepper.is_alive()
    assert eng._wedge_armed()
    # the heartbeat counts from the end of the wait
    assert eng.heartbeat_age_s() < 0.2
    eng.run_until_idle()
    eng.close()


def test_held_back_replica_is_not_restarted(weights):
    """A warm supervised replica held back by another's capture for five
    times its watchdog's timeout is not declared wedged, and its tokens
    equal an engine's alone."""
    srcs = _srcs(4, seed=3)
    eng = _engine(weights)
    hs = [eng.submit(s, max_new_tokens=6) for s in srcs]
    eng.run_until_idle()
    eng.close()
    clean = [list(h.tokens) for h in hs]
    sup = serving.EngineSupervisor(
        TT.TransformerConfig(**_CFG), weights, slots=2, src_len=8,
        max_len=10, bos_id=0, end_id=1, place=CPU, wedge_timeout_ms=100,
        poll_s=0.005)
    try:
        warm = [sup.submit(s, max_new_tokens=3) for s in srcs[:2]]
        for h in warm:
            h.result(timeout=60)
        assert sup.engine._wedge_armed()
        with GATE.exclusive():      # hold the replica back for 0.5 s
            hs = [sup.submit(s, max_new_tokens=6) for s in srcs]
            time.sleep(0.5)
        tokens = [h.result(timeout=60) for h in hs]
        assert sup.restarts == 0
        assert tokens == clean
    finally:
        sup.close()


def test_two_threads_build_one_source_once(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a source\n")
    monkeypatch.setattr(kernels, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(build))
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels, "_loaded", {})
    calls, outs = [], []

    class _Proc:
        returncode, stdout = 0, "ptxas info"

    def fake_run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        calls.append(out)
        time.sleep(0.2)             # a build both threads overlap
        with open(out, "w") as f:
            f.write("lib")
        return _Proc()

    monkeypatch.setattr(kernels.subprocess, "run", fake_run)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: ("lib", path))
    go = threading.Barrier(3)

    def build_it():
        go.wait(30)
        outs.append(kernels.build("k"))

    def loader():
        go.wait(30)
        outs.append(kernels.load("k"))

    ts = [threading.Thread(target=f) for f in (build_it, build_it, loader)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
        assert not t.is_alive()
    assert len(calls) == 1, calls
    # the temporary name carries the process and the building thread
    assert calls[0].endswith(".tmp") and calls[0].count(".") >= 4
    # a build call that found the library built returns None
    builds = [o for o in outs if isinstance(o, tuple) and len(o) == 2
              and isinstance(o[1], float)]
    assert len(builds) <= 1 and outs.count(None) >= 1
    assert kernels.load("k") == ("lib", kernels.library_path("k"))
    assert len(calls) == 1


def test_launch_delta_leaves_out_another_threads_launches():
    main, y, exe, scope = _program()
    _run(main, y, exe, scope)       # eager first call
    kernels.reset_counts()
    entered, release = _blocking(exe, before=lambda: kernels.count("mine"))
    capture = threading.Thread(target=_run, args=(main, y, exe, scope))
    capture.start()
    assert entered.wait(30)
    others = [threading.Thread(target=kernels.count, args=("other",))
              for _ in range(3)]
    for t in others:
        t.start()
    for t in others:
        t.join(30)
    release.set()
    capture.join(30)
    assert not capture.is_alive()
    (runner,) = [r for r in exe._runners[scope].values()
                 if r.lowered.fetch_names]
    assert runner.launch_delta == {"mine": 1}
    assert kernels.launch_counts["other"] == 3
    assert kernels.launch_counts["mine"] == 1     # the CPU ran the step
    _run(main, y, exe, scope)       # a later call runs the step again
    assert kernels.launch_counts["mine"] == 2
    kernels.reset_counts()


def test_launch_counts_from_many_threads_add_up():
    kernels.reset_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                kernels.count("k")
            kernels.add_counts({"k": 5})

        ts = [threading.Thread(target=work) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert kernels.launch_counts["k"] == 16 * 2005
    kernels.reset_counts()


def test_recording_nests_and_restores():
    kernels.reset_counts()
    with kernels.recording() as outer:
        kernels.count("a")
        with kernels.recording() as inner:
            kernels.count("b")
        kernels.count("a")
    kernels.count("c")
    assert outer == {"a": 2} and inner == {"b": 1}
    assert kernels.launch_counts == {"c": 1}
    kernels.reset_counts()
    assert lowering.GATE is GATE
