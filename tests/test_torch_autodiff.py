"""Gradients of the port (paddle_tpu_torch.backward.append_backward) against
the JAX package's, op by op, on the CPU.

Each case is a one-op program built in both packages from the same numpy
inputs; the loss is sum(out * cot) over the op's weighted output(s) with
a fixed random cotangent ``cot``, and ``<input>@GRAD`` is fetched by name
for every differentiable input. Both packages derive the op's grad from
its forward (jax.vjp / torch.autograd) or run its registered grad op.
f32, atol 1e-5 (the two frameworks sum in different orders)."""

import numpy as np
import pytest

import paddle_tpu as pfluid
from paddle_tpu import backward as pbackward
from paddle_tpu import layers as players

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import backward as tbackward
from paddle_tpu_torch import layers as tlayers

_R = np.random.RandomState(0)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


def _pos(*shape):
    return (np.abs(_R.randn(*shape)) + 0.5).astype(np.float32)


def _soft(*shape):
    x = np.exp(_R.randn(*shape)).astype(np.float32)
    return x / x.sum(-1, keepdims=True)


def _distinct(*shape):
    """Values at least 0.01 apart and away from 0 (no ties for max / relu
    kinks)."""
    n = int(np.prod(shape))
    v = (_R.permutation(n) - n // 2 + 0.5) * 0.07
    return v.reshape(shape).astype(np.float32)


_IDS = np.array([[1, 3, 0, 3, 9], [4, 4, 3, 7, 2]], np.int64)

# (op type, {slot: [(var name, array, differentiable)]}, attrs, the
# output slots weighted into the loss)
CASES = [
    ("mul", {"X": [("x", _f(2, 3, 4), True)], "Y": [("y", _f(4, 5), True)]},
     {"x_num_col_dims": 2, "y_num_col_dims": 1}, ["Out"]),
    ("elementwise_add", {"X": [("x", _f(2, 3, 4), True)],
                         "Y": [("y", _f(3), True)]}, {"axis": 1}, ["Out"]),
    ("elementwise_add", {"X": [("x", _f(2, 3, 4), True)],
                         "Y": [("y", _f(4), True)]}, {"axis": -1}, ["Out"]),
    ("elementwise_mul", {"X": [("x", _f(2, 3, 4), True)],
                         "Y": [("y", _f(3, 4), True)]}, {"axis": 1}, ["Out"]),
    ("elementwise_div", {"X": [("x", _f(2, 3), True)],
                         "Y": [("y", _pos(3), True)]}, {"axis": -1}, ["Out"]),
    ("elementwise_max", {"X": [("x", _distinct(3, 4), True)],
                         "Y": [("y", _distinct(3, 4)[::-1].copy(), True)]},
     {"axis": -1}, ["Out"]),
    ("layer_norm", {"X": [("x", _f(2, 3, 8), True)],
                    "Scale": [("s", _f(8), True)],
                    "Bias": [("b", _f(8), True)]},
     {"begin_norm_axis": 2, "epsilon": 1e-5}, ["Y"]),
    ("lookup_table", {"W": [("w", _f(10, 4), True)],
                      "Ids": [("ids", _IDS, False)]},
     {"squeeze_last": False, "padding_idx": 3}, ["Out"]),
    ("softmax_with_cross_entropy",
     {"Logits": [("logits", _f(2, 3, 6), True)],
      "Label": [("label", _soft(2, 3, 6), False)]},
     {"soft_label": True, "ignore_index": -100}, ["Loss"]),
    ("label_smooth", {"X": [("x", _soft(2, 3, 5), True)]},
     {"epsilon": 0.1}, ["Out"]),
    ("reduce_sum", {"X": [("x", _f(3, 5), True)]},
     {"dim": [1], "keep_dim": False}, ["Out"]),
    ("reshape2", {"X": [("x", _f(2, 3, 8), True)]},
     {"shape": [0, 0, 2, 4]}, ["Out"]),
    ("split", {"X": [("x", _f(2, 3, 12), True)]}, {"num": 3, "axis": -1},
     ["Out"]),
    ("scale", {"X": [("x", _f(3, 4), True)]},
     {"scale": 2.5, "bias": 0.5, "bias_after_scale": True}, ["Out"]),
    ("relu", {"X": [("x", _distinct(3, 4), True)]}, {}, ["Out"]),
    ("sum", {"X": [("a", _f(3, 4), True), ("b", _f(3, 4), True),
                   ("c", _f(3, 4), True)]}, {}, ["Out"]),
]


def _grads(fluid, layers, backward, case, cots):
    """Build the case's program in one package, run it once; returns
    (loss, {input name: gradient}, output shapes)."""
    op_type, ins, attrs, weighted = case
    main, startup = fluid.Program(), fluid.Program()
    feed, diff = {}, []
    with fluid.program_guard(main, startup):
        block = main.global_block()
        inputs = {}
        for slot, items in ins.items():
            inputs[slot] = []
            for name, arr, differentiable in items:
                block.create_var(name=name, shape=list(arr.shape),
                                 dtype=arr.dtype.name,
                                 stop_gradient=not differentiable)
                inputs[slot].append(name)
                feed[name] = arr
                if differentiable:
                    diff.append(name)
        n_out = 3 if op_type == "split" else 1
        outputs = {slot: [f"{slot.lower()}_{i}" for i in range(n_out)]
                   for slot in weighted}
        if op_type == "layer_norm":
            outputs.update(Mean=["mean_0"], Variance=["var_0"])
        if op_type == "softmax_with_cross_entropy":
            outputs.update(Softmax=["softmax_0"])
        block.append_op(op_type, inputs=inputs, outputs=outputs, attrs=attrs)
        terms, shapes = [], []
        for slot in weighted:
            for i, name in enumerate(outputs[slot]):
                out = block.var(name)
                shapes.append(tuple(out.shape))
                cot = layers.data(f"cot_{slot}_{i}", shape=list(out.shape),
                                  dtype="float32", append_batch_size=False)
                terms.append(layers.reduce_sum(
                    layers.elementwise_mul(out, cot)))
        loss = terms[0]
        for t in terms[1:]:
            loss = layers.elementwise_add(loss, t)
        backward.append_backward(loss)
    if cots is None:
        return None, None, shapes
    for (slot, i), c in cots.items():
        feed[f"cot_{slot}_{i}"] = c
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        vals = exe.run(main, feed=feed,
                       fetch_list=[loss] + [n + "@GRAD" for n in diff])
    return vals[0], dict(zip(diff, vals[1:])), shapes


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_grad_matches_jax(case):
    _, _, shapes = _grads(pfluid, players, pbackward, case, None)
    r = np.random.RandomState(1)
    keys = [(slot, i) for slot in case[3]
            for i in range(3 if case[0] == "split" else 1)]
    cots = {k: r.randn(*s).astype(np.float32) for k, s in zip(keys, shapes)}
    j_loss, j_grads, _ = _grads(pfluid, players, pbackward, case, cots)
    t_loss, t_grads, _ = _grads(tfluid, tlayers, tbackward, case, cots)
    np.testing.assert_allclose(t_loss, np.asarray(j_loss), atol=1e-5, rtol=0)
    assert sorted(t_grads) == sorted(j_grads) and t_grads
    for name, j in j_grads.items():
        t = t_grads[name]
        assert t.shape == np.asarray(j).shape, name
        np.testing.assert_allclose(t, np.asarray(j), atol=1e-5, rtol=0,
                                   err_msg=name)


def test_gradients_matches_jax():
    """backward.gradients (calc_gradient) of a target w.r.t. a feed,
    through an op the target reaches twice (a ``sum`` of partials)."""
    x_val = _distinct(3, 4)
    out = []
    for fluid, layers, backward in ((pfluid, players, pbackward),
                                    (tfluid, tlayers, tbackward)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = layers.data("x", shape=[3, 4], append_batch_size=False,
                            stop_gradient=False)
            y = layers.relu(layers.scale(x, scale=1.5))
            loss = layers.reduce_sum(layers.elementwise_mul(y, x))
            (gx,) = backward.gradients(loss, [x])
        with fluid.scope_guard(fluid.Scope()):
            out.append(fluid.Executor(fluid.CPUPlace()).run(
                main, feed={"x": x_val}, fetch_list=[gx])[0])
    np.testing.assert_allclose(out[1], np.asarray(out[0]), atol=1e-5,
                               rtol=0)
    ref = np.where(x_val > 0, 3.0 * x_val, 0.0)  # d/dx (relu(1.5 x) * x)
    np.testing.assert_allclose(out[1], ref, atol=1e-5, rtol=0)
