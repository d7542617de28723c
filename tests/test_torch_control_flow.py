"""The port's ``while`` op, its layers and the tensor and decode ops of the
beam-search path, against the JAX package on the CPU.

- ``While`` / ``while_loop`` programs built alike in both packages (under
  ``unique_name.guard()``, the JAX package's weights carried across by
  name) give the same carried values, ``Steps`` and ``CondOut``: a counter
  loop, several carries, a body that reads captured weights; each run
  uncached (the eager loop) and cached twice (the loop runner: its first
  call runs the warm-up iteration and the iteration that stands for the
  capture, its second replays). f32 within atol 1e-5, integers and bools
  exact.
- A body with ``dropout`` draws a new mask every iteration, the same masks
  again from a fresh executor, and the same masks eagerly and through the
  runner (the two packages' streams differ, so the masks are held to
  their own keep rate, not to the JAX package's).
- A block that holds ``while`` is not capturable; the loop runner commits
  the carries into its buffers in place and keeps them across loops.
- A program with a sub-block survives ``clone`` and the wire codec: the
  port's bytes are the JAX package's (``framework_pb2``) bytes.
- ``beam_search_step`` orders hand-made ties as ``jax.lax.top_k`` does;
  ``slice``, ``dynamic_slice`` (an out-of-range index clamps), ``range``,
  ``increment``, ``transpose2``, ``squeeze2``, ``expand`` and
  ``beam_gather`` equal the JAX ops; the registries agree on the new op
  types' gradient and seed flags."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pfluid
from paddle_tpu.core.registry import get_op_def as jax_op_def
from paddle_tpu.proto import framework_pb2 as pb

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.proto import framework_wire as wire

# the op types of the beam-search path (tests/test_torch_ops.py counts
# them among the registered ones)
DECODE_OP_TYPES = ["beam_gather", "beam_search_step", "dynamic_slice",
                   "expand", "increment", "range", "slice", "squeeze2",
                   "transpose2", "while"]


# --- while programs, built alike in both packages ---------------------------


def _counter(fluid, L):
    i = L.fill_constant(shape=[1], dtype="int32", value=0)
    limit = L.fill_constant(shape=[1], dtype="int32", value=10)
    total = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    cond = L.less_than(i, limit)
    w = L.While(cond)
    with w.block():
        L.assign(L.scale(total, bias=2.0), output=total)
        L.increment(i, value=1.0, in_place=True)
        L.less_than(i, limit, cond=cond)
    return {}, [total, i, w._steps_var, cond]


def _carries(fluid, L):
    """Three carries of three dtypes, one of them swapped with another
    each iteration, over a fed trip count."""
    n = L.data("n", shape=[1], dtype="int64", append_batch_size=False)
    x = L.data("x", shape=[3], dtype="float32")
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    y = L.scale(x, scale=-1.0)
    flag = L.less_than(i, n)
    cond = L.less_than(i, n)
    w = L.While(cond)
    with w.block():
        nx = L.elementwise_add(L.scale(x, scale=0.5), y)
        L.assign(x, output=y)
        L.assign(nx, output=x)
        L.assign(L.logical_not(flag), output=flag)
        L.increment(i, value=1.0, in_place=True)
        L.less_than(i, n, cond=cond)
    feed = {"n": np.array([5], np.int64),
            "x": np.random.RandomState(0).randn(2, 3).astype(np.float32)}
    return feed, [x, y, flag, i, w._steps_var, cond]


def _captured_weights(fluid, L):
    """A sigmoid recurrence through an fc layer whose weights the body
    reads (captured), summed into an accumulator, while the sum stays
    small."""
    x = L.data("x", shape=[4], dtype="float32")
    lim = L.fill_constant(shape=[1], dtype="float32", value=20.0)
    acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    cond = L.less_than(acc, lim)
    w = L.While(cond)
    with w.block():
        h = L.fc(x, 4, act="sigmoid",
                 param_attr=fluid.ParamAttr(name="loop_fc.w"),
                 bias_attr=fluid.ParamAttr(name="loop_fc.b"))
        L.assign(h, output=x)
        L.assign(L.elementwise_add(acc, L.reduce_sum(L.abs(h))),
                 output=acc)
        L.less_than(acc, lim, cond=cond)
    feed = {"x": np.random.RandomState(1).randn(2, 4).astype(np.float32)}
    return feed, [x, acc, w._steps_var, cond]


def _functional(fluid, L):
    i = L.fill_constant(shape=[1], dtype="int32", value=0)
    x = L.fill_constant(shape=[4], dtype="float32", value=1.0)

    def cond_fn(i, x):
        return L.less_than(i, L.fill_constant(shape=[1], dtype="int32",
                                              value=5))

    def body_fn(i, x):
        return [L.increment(i, in_place=False), L.scale(x, scale=2.0)]

    i, x = L.while_loop(cond_fn, body_fn, [i, x])
    return {}, [i, x]


def _never(fluid, L):
    """A loop whose condition is false at the start: no iteration."""
    i = L.fill_constant(shape=[1], dtype="int64", value=3)
    lim = L.fill_constant(shape=[1], dtype="int64", value=2)
    cond = L.less_than(i, lim)
    w = L.While(cond)
    with w.block():
        L.increment(i, value=1.0, in_place=True)
        L.less_than(i, lim, cond=cond)
    return {}, [i, w._steps_var, cond]


_PROGRAMS = {"counter": _counter, "carries": _carries,
             "captured_weights": _captured_weights, "functional": _functional,
             "never": _never}


def _build(fluid, name):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feed, fetch = _PROGRAMS[name](fluid, fluid.layers)
    return main, startup, feed, fetch


def _run_jax(name):
    main, startup, feed, fetch = _build(pfluid, name)
    scope = pfluid.Scope()
    with pfluid.scope_guard(scope):
        exe = pfluid.Executor(pfluid.CPUPlace())
        exe.run(startup)
        got = exe.run(main, feed=feed, fetch_list=fetch)
    weights = {p.name: np.asarray(scope.find_var(p.name))
               for p in main.all_parameters()}
    return [np.asarray(g) for g in got], weights


def _run_port(name, weights, cached, runs=1):
    main, startup, feed, fetch = _build(tfluid, name)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        exe.run(startup)
        for n, v in weights.items():
            scope.set(n, v)
        outs = [exe.run(main, feed=feed, fetch_list=fetch,
                        use_program_cache=cached) for _ in range(runs)]
    return outs, exe


def _same(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name", sorted(_PROGRAMS))
def test_while_matches_jax(name):
    want, weights = _run_jax(name)
    eager, _ = _run_port(name, weights, cached=False)
    cached, exe = _run_port(name, weights, cached=True, runs=2)
    for mode, outs in (("eager", eager), ("runner", cached)):
        for k, got in enumerate(outs):
            for j, (g, w) in enumerate(zip(got, want)):
                _same(g, w, f"{name} {mode} run {k} fetch {j}")
    (runner,) = exe._loop_runners.values()
    assert runner.loops == 2
    assert runner.captured == (runner.iterations > 1)


def test_steps_and_condout_are_scalars():
    """Steps is a 0-d int32 count of the iterations, CondOut the 0-d
    final condition, in both packages."""
    want, _ = _run_jax("counter")
    (got,), _ = _run_port("counter", {}, cached=False)
    assert want[2].shape == got[2].shape == () and int(got[2]) == 10
    assert got[2].dtype == want[2].dtype == np.int32
    assert got[3].shape == want[3].shape == () and not bool(got[3])


# --- dropout in a loop body --------------------------------------------------


def _dropout_masks(fluid, n_iter=6, width=256):
    """Each iteration writes dropout(ones) into row i of a carried
    [n_iter, width] array."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        lim = L.fill_constant(shape=[1], dtype="int64", value=n_iter)
        rows = L.fill_constant(shape=[n_iter, width], dtype="float32",
                               value=0.0)
        ones = L.fill_constant(shape=[width], dtype="float32", value=1.0)
        cond = L.less_than(i, lim)
        with L.While(cond).block():
            d = L.dropout(ones, 0.5,
                          dropout_implementation="upscale_in_train")
            out = main.current_block().create_var(name="rows_next",
                                                  dtype="float32")
            main.current_block().append_op(
                "dynamic_update", inputs={"X": rows, "Index": i, "Value": d},
                outputs={"Out": out})
            L.assign(out, output=rows)
            L.increment(i, value=1.0, in_place=True)
            L.less_than(i, lim, cond=cond)
    main.random_seed = 7
    return main, rows


def test_dropout_masks_differ_by_iteration_and_repeat_by_run():
    got = {}
    for cached in (False, True):
        for rerun in range(2):
            main, rows = _dropout_masks(tfluid)
            exe = tfluid.Executor(tfluid.CPUPlace())
            with tfluid.scope_guard(tfluid.Scope()):
                outs = [exe.run(main, fetch_list=[rows],
                                use_program_cache=cached)[0]
                        for _ in range(3)]
            got[cached, rerun] = outs
    base = got[False, 0]
    for key, outs in got.items():
        for a, b in zip(base, outs):
            np.testing.assert_array_equal(a, b, err_msg=str(key))
    masks = base[0]
    assert set(np.unique(masks)) <= {0.0, 2.0}
    for r in range(1, masks.shape[0]):
        assert not np.array_equal(masks[r], masks[0]), r
    keep = (masks > 0).mean()
    assert abs(keep - 0.5) < 5 * np.sqrt(0.25 / masks.size)
    # the executor's next step draws other masks
    assert not np.array_equal(base[0], base[1])


# --- capture rules and the runner's bookkeeping ------------------------------


def test_block_with_while_is_not_capturable_and_runner_commits_in_place():
    main, startup, feed, fetch = _build(tfluid, "carries")
    lw = lowering.lower_block(main, 0, sorted(feed), [v.name for v in fetch],
                              torch.device("cpu"))
    assert not lw.capturable
    plain, _, pfeed, pfetch = _build(tfluid, "never")
    lw = lowering.lower_block(plain, 0, [], [v.name for v in pfetch],
                              torch.device("cpu"))
    assert not lw.capturable

    exe = tfluid.Executor(tfluid.CPUPlace())
    lowering.GATE.reset_stats()
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        first = exe.run(main, feed=feed, fetch_list=fetch)
        (runner,) = exe._loop_runners.values()
        bufs = dict(runner.bufs)
        ptrs = {n: b.data_ptr() for n, b in bufs.items()}
        second = exe.run(main, feed=feed, fetch_list=fetch)
    assert runner.loops == 2 and runner.iterations == 10
    assert runner.warm and runner.captured and runner.graph is None
    # the iteration that stands for the capture held the gate alone
    assert lowering.GATE.stats()["captures"] == 1
    for n, b in runner.bufs.items():
        assert b is bufs[n] and b.data_ptr() == ptrs[n], n
    # the buffers hold the last loop's carries; the fetches are copies
    np.testing.assert_array_equal(runner.bufs["x"].numpy(), second[0])
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    exe.close()
    assert exe._loop_runners == {} and runner.bufs == {}


def test_while_layer_errors():
    main, startup = tfluid.Program(), tfluid.Program()
    L = tfluid.layers
    with tfluid.program_guard(main, startup):
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        lim = L.fill_constant(shape=[1], dtype="int64", value=3)
        cond = L.less_than(i, lim)
        # a bound makes the loop the differentiable bounded_while
        with L.While(cond, max_trip_count=4).block():
            L.increment(i, value=1.0, in_place=True)
            L.less_than(i, lim, cond=cond)
        op = main.global_block().ops[-1]
        assert (op.type, op.attrs["max_trip_count"]) == ("bounded_while", 4)
        with pytest.raises(ValueError, match="condition"):
            with L.While(cond).block():
                L.increment(i, value=1.0, in_place=True)
        assert main.current_block_idx == 0


def test_backprop_through_while_raises():
    """A loss that reaches a ``while`` output raises when the backward is
    built, as in the JAX package, instead of dropping the gradient."""
    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = L.data("x", shape=[4], dtype="float32")
        acc = L.fc(x, 4, bias_attr=False)
        i = L.fill_constant([1], "int64", 0)
        lim = L.fill_constant([1], "int64", 3)
        cond = L.less_than(i, lim)
        with L.While(cond).block():
            L.assign(L.scale(acc, scale=2.0), output=acc)
            L.increment(i)
            L.less_than(i, lim, cond=cond)
        loss = L.mean(acc)
        with pytest.raises(RuntimeError, match="max_trip_count"):
            tfluid.optimizer.SGD(0.1).minimize(loss)


# --- a sub-block through clone and the wire codec ----------------------------


@pytest.mark.parametrize("name", ["captured_weights", "carries"])
def test_sub_block_program_bytes_and_clone(name):
    jmain = _build(pfluid, name)[0]
    tmain, _, feed, fetch = _build(tfluid, name)
    jb = jmain.desc_str()
    assert tmain.desc_str() == jb
    d = pb.ProgramDesc.FromString(jb)
    assert len(d.blocks) == 2 and d.blocks[1].parent_idx == 0
    assert wire.ProgramDesc.FromString(jb).SerializeToString() == jb
    parsed = tfluid.Program.parse_from_string(jb)
    assert parsed.desc_str() == jb
    assert parsed.content_digest() == pfluid.Program.parse_from_string(
        jb).content_digest()
    (wop,) = [op for op in parsed.global_block().ops if op.type == "while"]
    assert wop.attrs["sub_block"] is parsed.blocks[1]
    assert parsed.blocks[1].parent_block is parsed.global_block()
    clone = tmain.clone()
    assert clone.desc_str() == pfluid.Program.parse_from_string(
        jb).clone().desc_str()
    # the clone runs and gives the same values
    weights = _run_jax(name)[1]
    outs = []
    for prog in (tmain, clone):
        scope = tfluid.Scope()
        for n, v in weights.items():
            scope.set(n, v)
        exe = tfluid.Executor(tfluid.CPUPlace())
        outs.append(exe.run(prog, feed=feed, fetch_list=[v.name for v in
                                                         fetch],
                            scope=scope))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# --- the ops, one by one, against the JAX ops --------------------------------


def _jax(op_type, ins, attrs):
    jins = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}
    return jax_op_def(op_type).compute(jins, dict(attrs))


def _port(op_type, ins, attrs):
    tins = {k: [torch.from_numpy(np.array(v)) for v in vs]
            for k, vs in ins.items()}
    return get_op_def(op_type).compute(tins, dict(attrs),
                                       device=torch.device("cpu"))


_R = np.random.RandomState(3)
_X = _R.randn(2, 3, 4).astype(np.float32)
_IDS = _R.randint(0, 9, (2, 3, 5)).astype(np.int64)
_OP_CASES = [
    ("slice", {"X": [_X]}, {"axes": [1], "starts": [1], "ends": [3]}),
    ("slice", {"X": [_X]}, {"axes": [0, 2], "starts": [-1, 0],
                            "ends": [2, 100]}),
    ("dynamic_slice", {"X": [_X], "Index": [np.array([1], np.int64)]}, {}),
    ("dynamic_slice", {"X": [_X], "Index": [np.array([7], np.int64)]}, {}),
    ("dynamic_slice", {"X": [_X], "Index": [np.array([-3], np.int64)]},
     {}),
    ("range", {}, {"start": 0, "end": 7, "dtype": "int64"}),
    ("range", {}, {"start": 2, "end": 11, "step": 3, "dtype": "int64"}),
    ("increment", {"X": [np.array([4], np.int64)]}, {"step": -1.0}),
    ("increment", {"X": [np.array([1.5], np.float32)]}, {"step": 0.25}),
    ("increment", {"X": [np.array([3], np.int32)]}, {"step": 1.0}),
    ("transpose2", {"X": [_X]}, {"axis": [1, 0, 2]}),
    ("transpose2", {"X": [_X]}, {"axis": [2, 0, 1]}),
    ("squeeze2", {"X": [_X[:, :1]]}, {"axes": [1]}),
    ("squeeze2", {"X": [_X[:1, :, :1]]}, {"axes": []}),
    ("expand", {"X": [_X[:, None]]}, {"expand_times": [1, 4, 1, 1]}),
    ("expand", {"X": [_X[:, :1]]}, {"expand_times": [2, 3, 1]}),
    ("beam_gather", {"X": [_IDS], "Index": [np.array([2, 0], np.int64)]},
     {}),
    ("beam_gather", {"X": [_X], "Index": [np.array([1, 2], np.int64)]},
     {}),
]


def _step_ins(scores, logp, finished, step):
    b, k, _ = logp.shape
    ids = np.arange(b * k * 6, dtype=np.int64).reshape(b, k, 6) % 7
    return {"Ids": [ids], "Scores": [np.asarray(scores, np.float32)],
            "LogProbs": [np.asarray(logp, np.float32)],
            "Finished": [np.asarray(finished, bool)],
            "StepIdx": [np.array([step], np.int64)]}


# hand-made ties: equal totals across beams and tokens, finished rows
# (whose only legal token is end_id), and all-equal rows
_TIED_LOGP = np.log(np.array([[[0.25, 0.25, 0.25, 0.25],
                               [0.5, 0.25, 0.125, 0.125],
                               [0.25, 0.25, 0.25, 0.25]],
                              [[0.1, 0.2, 0.3, 0.4],
                               [0.4, 0.3, 0.2, 0.1],
                               [0.25, 0.25, 0.25, 0.25]]]))
_STEP_CASES = {
    "ties across beams": _step_ins([[0.0, 0.0, 0.0], [-1.0, -1.0, -1.0]],
                                   _TIED_LOGP, np.zeros((2, 3)), 2),
    "finished rows": _step_ins([[0.0, -0.5, -1e9], [-2.0, -2.0, -2.0]],
                               _TIED_LOGP, [[True, False, False],
                                            [False, True, True]], 1),
    "all equal": _step_ins(np.zeros((2, 3)), np.zeros((2, 3, 4)),
                           np.zeros((2, 3)), 5),
    "step past the end": _step_ins([[0.0, -1.0, -2.0], [0.0, 0.0, -1e9]],
                                   _TIED_LOGP, np.zeros((2, 3)), 9),
}


@pytest.mark.parametrize("case", sorted(_STEP_CASES))
@pytest.mark.parametrize("end_id", [1, 3])
def test_beam_search_step_ties_as_jax(case, end_id):
    ins = _STEP_CASES[case]
    want = _jax("beam_search_step", ins, {"end_id": end_id})
    got = _port("beam_search_step", ins, {"end_id": end_id})
    for slot in ("Ids", "Scores", "Finished", "Parent"):
        _same(got[slot][0].numpy(), np.asarray(want[slot][0]), slot)


@pytest.mark.parametrize("case", _OP_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(_OP_CASES)])
def test_op_matches_jax(case):
    op_type, ins, attrs = case
    want, got = _jax(op_type, ins, attrs), _port(op_type, ins, attrs)
    for slot, vals in want.items():
        assert len(got[slot]) == len(vals), slot
        for w, g in zip(vals, got[slot]):
            _same(g.contiguous().numpy(), np.asarray(w), slot)


@pytest.mark.parametrize("op_type", DECODE_OP_TYPES)
def test_registries_agree(op_type):
    j, t = jax_op_def(op_type), get_op_def(op_type)
    assert (t.diff_inputs, t.no_grad, t.needs_rng) == (
        j.diff_inputs, j.no_grad, j.needs_rng)
    assert t.host_loop == (op_type == "while")
