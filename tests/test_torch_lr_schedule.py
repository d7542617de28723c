"""The port's learning-rate schedules (layers/learning_rate_scheduler.py)
and the ops they need (``pow``, ``exp``, ``floor``, ``cos``,
``elementwise_min``, ``elementwise_floordiv``) against the JAX package's,
on the CPU.

Tolerances: each op's output rtol 1e-6 (f32 elementwise functions of two
libraries, which may round their transcendental functions differently
in the last place; ``floor``, ``min`` and ``floordiv`` are exact); each
schedule's learning rate over 10 steps rtol 1e-6 (the same f32 ops in
the same order). The step counter of a schedule is state: a captured
step (the CPU's stand-in for one) writes it in place, and it is equal
to the steps run.
"""

import numpy as np
import pytest

import paddle_tpu as pfluid
from paddle_tpu import layers as players
from paddle_tpu.core.registry import get_op_def as jax_op_def

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core.registry import get_op_def

_NEW_OPS = ["pow", "exp", "floor", "cos", "elementwise_min",
            "elementwise_floordiv"]


@pytest.mark.parametrize("op_type", _NEW_OPS)
def test_registries_agree(op_type):
    j, t = jax_op_def(op_type), get_op_def(op_type)
    assert (t.diff_inputs, t.no_grad, t.needs_rng) == (
        j.diff_inputs, j.no_grad, j.needs_rng)
    assert (t.grad_maker is None) == (j.grad_maker is None)


def _run_both(build, feed, steps=1):
    """``build(fluid, layers)`` -> fetch vars, in each package; run
    ``steps`` times from a fresh startup; the last run's fetches."""
    out = []
    for fluid, layers in ((pfluid, players), (tfluid, tlayers)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            fetch = build(fluid, layers)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            rows = [exe.run(main, feed=feed, fetch_list=fetch)
                    for _ in range(steps)]
        out.append([[np.asarray(v) for v in r] for r in rows])
    return out


_R = np.random.RandomState(0)
_X = np.abs(_R.randn(4, 5)).astype(np.float32) + 0.1
_Y = (_R.randn(4, 5) * 3).astype(np.float32)
_Y[_Y == 0] = 1.0


@pytest.mark.parametrize("name", ["pow", "exp", "elementwise_min",
                                  "elementwise_floordiv"])
def test_op_layers_match_jax(name):
    def build(fluid, layers):
        x = layers.data("x", shape=[5], dtype="float32")
        y = layers.data("y", shape=[5], dtype="float32")
        if name == "pow":
            return [layers.pow(x, factor=-0.5), layers.pow(y, factor=2.0)]
        if name == "exp":
            return [layers.exp(y)]
        return [getattr(layers, name)(layers.scale(x, scale=7.0), y)]

    (want,), (got,) = _run_both(build, {"x": _X, "y": _Y})
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


_SCHEDULES = {
    "noam_decay": lambda s: s.noam_decay(16, 4),
    "exponential_decay": lambda s: s.exponential_decay(0.1, 3, 0.5),
    "exponential_decay_staircase":
        lambda s: s.exponential_decay(0.1, 3, 0.5, staircase=True),
    "natural_exp_decay": lambda s: s.natural_exp_decay(0.1, 3, 0.5),
    "natural_exp_decay_staircase":
        lambda s: s.natural_exp_decay(0.1, 3, 0.5, staircase=True),
    "inverse_time_decay": lambda s: s.inverse_time_decay(0.1, 3, 0.5),
    "inverse_time_decay_staircase":
        lambda s: s.inverse_time_decay(0.1, 3, 0.5, staircase=True),
    "polynomial_decay": lambda s: s.polynomial_decay(0.1, 6, 0.001, 2.0),
    "piecewise_decay":
        lambda s: s.piecewise_decay([2, 5, 7], [0.1, 0.05, 0.01, 0.001]),
    "cosine_decay": lambda s: s.cosine_decay(0.1, 2, 5),
    "linear_lr_warmup": lambda s: s.linear_lr_warmup(0.1, 4, 0.0, 0.1),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_schedule_matches_jax_over_ten_steps(name):
    def build(fluid, layers):
        return [_SCHEDULES[name](layers.learning_rate_scheduler)]

    want, got = (np.concatenate([r[0] for r in rows])
                 for rows in _run_both(build, {}, steps=10))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_schedules_exported_as_in_jax():
    for name in ("noam_decay", "exponential_decay", "natural_exp_decay",
                 "inverse_time_decay", "polynomial_decay",
                 "piecewise_decay", "cosine_decay"):
        assert callable(getattr(tlayers, name))
        assert hasattr(players, name)


def test_step_counter_is_state_written_in_place():
    """The schedule's counter is a persistable of the captured step: the
    runner commits it into the Scope's own tensor, which keeps its
    identity across runs and counts the steps."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tlayers.data("x", shape=[3], dtype="float32")
        loss = tlayers.mean(tlayers.fc(x, 2))
        lr = tlayers.noam_decay(16, 4)
        tfluid.optimizer.Adam(lr).minimize(loss)
    step_name = next(v.name for v in main.list_vars()
                     if v.name.startswith("learning_rate_sched_step"))
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    feed = {"x": np.ones((2, 3), np.float32)}
    with tfluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[lr])   # eager warm-up
        exe.run(main, feed=feed, fetch_list=[lr])   # the capture
        held = scope.find_var(step_name)
        for _ in range(3):
            (got,) = exe.run(main, feed=feed, fetch_list=[lr])
    assert scope.find_var(step_name) is held
    assert float(held.reshape(-1)[0]) == 5.0
    want = 16 ** -0.5 * min(5 ** -0.5, 5 * 4 ** -1.5)
    np.testing.assert_allclose(got, [want], rtol=1e-6)


@pytest.mark.parametrize("op_type", ["floor", "cos"])
def test_op_compute_matches_jax(op_type):
    """The two ops no layer function builds (a schedule appends them)."""
    import torch

    x = _Y * 1.7
    want = np.asarray(jax_op_def(op_type).compute({"X": [x]}, {})["Out"][0])
    got = get_op_def(op_type).compute({"X": [torch.from_numpy(x)]}, {},
                                      torch.device("cpu"))["Out"][0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
