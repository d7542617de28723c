"""The ops the vision path added, the port's compute against the JAX
package's on the same numpy inputs (made from a seed), on the CPU.

Forward cases call both packages' registered compute functions directly.
f32 results agree within atol 1e-5 (the frameworks sum in other orders);
integer results are exact; bf16 results (``conv2d``, ``batch_norm``)
within one bf16 ulp of the largest output, because the two CPU backends
round their f32 sums to bf16 at the same place but sum in other orders.
Gradient cases build a small program with each package's layers and
fetch ``<name>@GRAD``: both packages derive the grad op from the forward.
``top_k``'s inputs are random f32 values, which have no ties; the two
libraries may order tied entries differently."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pfluid
from paddle_tpu import backward as pbackward
from paddle_tpu import layers as players
from paddle_tpu.core.registry import get_op_def as jax_op_def

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import backward as tbackward
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core.registry import get_op_def

VISION_OP_TYPES = sorted({
    "conv2d", "depthwise_conv2d", "pool2d", "batch_norm", "mean", "sigmoid",
    "top_k", "accuracy", "momentum",
})

_R = np.random.RandomState(0)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


def _bf(*shape):
    """bf16-representable f32 values (both packages then see equal bf16)."""
    return torch.from_numpy(_f(*shape)).to(torch.bfloat16).float().numpy()


def _conv(op, x, w, bf16=False, **attrs):
    a = {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
         "groups": 1}
    a.update(attrs)
    return (op, {"Input": [x], "Filter": [w]}, a, bf16)


def _bn(x, c, bf16=False, **attrs):
    a = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
         "data_layout": "NCHW"}
    a.update(attrs)
    return ("batch_norm",
            {"X": [x], "Scale": [_f(c) * 0.5 + 1.0], "Bias": [_f(c)],
             "Mean": [_f(c) * 0.1], "Variance": [np.abs(_f(c)) + 0.5]}, a,
            bf16)


def _pool(x, **attrs):
    a = {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
         "paddings": [0, 0], "global_pooling": False, "exclusive": True}
    a.update(attrs)
    return ("pool2d", {"X": [x]}, a, False)


def _momentum(nesterov):
    return ("momentum",
            {"Param": [_f(3, 4)], "Grad": [_f(3, 4)], "Velocity": [_f(3, 4)],
             "LearningRate": [np.array([0.1], np.float32)]},
            {"mu": 0.9, "use_nesterov": nesterov}, False)


_LOGITS = _f(6, 10)
_TOPK = np.argsort(-_LOGITS, axis=-1)[:, :3].astype(np.int64)

# (op type, inputs, attrs, run in bf16)
CASES = [
    _conv("conv2d", _f(2, 3, 9, 9), _f(4, 3, 3, 3), paddings=[1, 1]),
    _conv("conv2d", _f(2, 3, 16, 16), _f(8, 3, 7, 7), strides=[2, 2],
          paddings=[3, 3]),
    _conv("conv2d", _f(2, 8, 7, 7), _f(8, 2, 3, 3), paddings=[1, 1],
          groups=4),
    _conv("conv2d", _f(2, 4, 8, 8), _f(6, 4, 1, 1), strides=[2, 2]),
    _conv("conv2d", _f(2, 4, 9, 9), _f(4, 4, 3, 3), paddings=[2, 2],
          dilations=[2, 2]),
    _conv("conv2d", _bf(2, 8, 7, 7), _bf(8, 8, 3, 3), bf16=True,
          paddings=[1, 1]),
    _conv("depthwise_conv2d", _f(2, 6, 8, 8), _f(6, 1, 3, 3),
          paddings=[1, 1], groups=6),
    _pool(_f(2, 3, 9, 9), ksize=[3, 3], paddings=[1, 1]),
    _pool(_f(2, 3, 8, 8), pooling_type="avg", ksize=[3, 3], strides=[2, 2],
          paddings=[1, 1]),
    _pool(_f(2, 3, 8, 8), pooling_type="avg", ksize=[3, 3], strides=[2, 2],
          paddings=[1, 1], exclusive=False),
    _pool(_f(2, 3, 8, 8), pooling_type="avg", ksize=[2, 2], strides=[1, 1]),
    _pool(_f(2, 3, 5, 7), pooling_type="avg", ksize=[7, 7],
          global_pooling=True),
    _pool(_f(2, 3, 5, 7), pooling_type="max", global_pooling=True),
    _bn(_f(4, 5, 6, 6) * 2.0 + 0.5, 5),
    _bn(_f(4, 5, 6, 6), 5, is_test=True),
    _bn(_f(4, 6, 6, 5), 5, data_layout="NHWC"),
    _bn(_f(8, 5), 5),
    _bn(_bf(4, 5, 6, 6) * 2.0, 5, bf16=True),
    ("mean", {"X": [_f(3, 4, 5)]}, {}, False),
    ("sigmoid", {"X": [_f(3, 4) * 3.0]}, {}, False),
    ("top_k", {"X": [_LOGITS]}, {"k": 1}, False),
    ("top_k", {"X": [_f(2, 3, 12)]}, {"k": 4}, False),
    ("accuracy", {"Out": [np.take_along_axis(_LOGITS, _TOPK, -1)],
                  "Indices": [_TOPK],
                  "Label": [np.array([[_TOPK[0, 0]], [_TOPK[1, 2]], [11],
                                      [_TOPK[3, 1]], [12], [13]],
                                     np.int64)]}, {}, False),
    _momentum(False),
    _momentum(True),
]


def test_cases_cover_exactly_the_vision_op_types():
    assert sorted({c[0] for c in CASES}) == VISION_OP_TYPES


def _run_jax(op_type, ins, attrs, bf16):
    def arr(v):
        a = jnp.asarray(v)
        return a.astype(jnp.bfloat16) if bf16 and a.dtype == jnp.float32 \
            else a

    return jax_op_def(op_type).compute(
        {k: [arr(v) for v in vs] for k, vs in ins.items()}, dict(attrs))


def _run_torch(op_type, ins, attrs, bf16):
    def ten(v):
        t = torch.from_numpy(np.array(v))
        return t.to(torch.bfloat16) if bf16 and t.dtype == torch.float32 \
            else t

    return get_op_def(op_type).compute(
        {k: [ten(v) for v in vs] for k, vs in ins.items()}, dict(attrs),
        device=torch.device("cpu"))


def _np(v):
    if isinstance(v, torch.Tensor):
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    a = np.asarray(v)
    return np.asarray(v.astype(jnp.float32)) if a.dtype.name == "bfloat16" \
        else a


def _dtype_name(v):
    return str(v.dtype).replace("torch.", "")


@pytest.mark.parametrize(
    "case", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_op_matches_jax(case):
    op_type, ins, attrs, bf16 = case
    if bf16 and op_type == "batch_norm":
        # only the stream is bf16 under AMP; the statistics stay f32
        j_outs = jax_op_def(op_type).compute(
            {k: [jnp.asarray(v).astype(jnp.bfloat16) if k == "X"
                 else jnp.asarray(v) for v in vs] for k, vs in ins.items()},
            dict(attrs))
        t_outs = get_op_def(op_type).compute(
            {k: [torch.from_numpy(v).to(torch.bfloat16) if k == "X"
                 else torch.from_numpy(v) for v in vs]
             for k, vs in ins.items()}, dict(attrs),
            device=torch.device("cpu"))
    else:
        j_outs = _run_jax(op_type, ins, attrs, bf16)
        t_outs = _run_torch(op_type, ins, attrs, bf16)
    assert sorted(t_outs) == sorted(j_outs)
    for slot, j_vals in j_outs.items():
        t_vals = t_outs[slot]
        assert len(t_vals) == len(j_vals), slot
        for jv, tv in zip(j_vals, t_vals):
            assert _dtype_name(tv) == _dtype_name(jv), slot
            j, t = _np(jv), _np(tv)
            assert t.shape == j.shape, (slot, t.shape, j.shape)
            if _dtype_name(tv) == "bfloat16":
                # one bf16 ulp (2^-7 relative) of the largest output
                tol = 2.0 ** -7 * np.abs(j).max()
                np.testing.assert_allclose(t, j, atol=tol, rtol=0)
            elif np.issubdtype(t.dtype, np.floating):
                np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)
            else:
                np.testing.assert_array_equal(t, j)


def test_batch_norm_statistics_are_detached():
    """Y carries the graph; MeanOut, VarianceOut, SavedMean, SavedVariance
    do not (stop_gradient in the JAX op)."""
    _, ins, attrs, _ = _bn(_f(4, 5, 6, 6), 5)
    tins = {k: [torch.from_numpy(v).requires_grad_(k in ("X", "Scale"))
                for v in vs] for k, vs in ins.items()}
    with torch.enable_grad():
        outs = get_op_def("batch_norm").compute(tins, attrs,
                                                device=torch.device("cpu"))
    assert outs["Y"][0].requires_grad
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        assert not outs[slot][0].requires_grad, slot


# --- gradients through the derived grad ops, program against program ---


def _build_conv(layers, x, groups, stride):
    return layers.conv2d(x, 8, 3, stride=stride, padding=1, groups=groups,
                         param_attr="w", bias_attr="b")


GRAD_CASES = {
    "conv2d": ((2, 4, 8, 8),
               lambda L, x: _build_conv(L, x, 1, 1), ["w", "b"]),
    "conv2d_grouped_stride2": ((2, 4, 8, 8),
                               lambda L, x: _build_conv(L, x, 2, 2),
                               ["w", "b"]),
    "depthwise_conv2d": ((2, 8, 6, 6),
                         lambda L, x: _build_conv(L, x, 8, 1), ["w", "b"]),
    "pool2d_max_pad": ((2, 3, 9, 9),
                       lambda L, x: L.pool2d(x, 3, "max", 2, 1), []),
    "pool2d_avg_exclusive": ((2, 3, 8, 8),
                             lambda L, x: L.pool2d(x, 3, "avg", 2, 1), []),
    "pool2d_avg_global": ((2, 3, 5, 7),
                          lambda L, x: L.pool2d(x, 7, "avg",
                                                global_pooling=True), []),
    "batch_norm": ((4, 5, 6, 6),
                   lambda L, x: L.batch_norm(
                       x, param_attr="scale", bias_attr="offset",
                       moving_mean_name="mm", moving_variance_name="mv"),
                   ["scale", "offset"]),
    "batch_norm_relu": ((4, 5, 6, 6),
                        lambda L, x: L.batch_norm(
                            x, act="relu", param_attr="scale",
                            bias_attr="offset", moving_mean_name="mm",
                            moving_variance_name="mv"),
                        ["scale", "offset"]),
    "sigmoid": ((3, 7), lambda L, x: L.sigmoid(x), []),
    "fc_4d_sigmoid": ((3, 2, 4, 4),
                      lambda L, x: L.fc(x, 5, act="sigmoid", param_attr="w",
                                        bias_attr="b"), ["w", "b"]),
    "mean": ((3, 4, 5), lambda L, x: L.mean(x), []),
}


def _program_grads(fluid, layers, backward, shape, build, params, values):
    """Build x -> layer -> sum(out * cot) in one package, set the named
    parameters, run once; returns (loss, grads by name, final scope
    values of the non-trainable parameters, op types)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=list(shape), append_batch_size=False,
                        stop_gradient=False)
        out = build(layers, x)
        oshape = [d for d in out.shape] or [1]
        cot = layers.data("cot", shape=oshape, append_batch_size=False)
        loss = layers.reduce_sum(layers.elementwise_mul(out, cot))
        backward.append_backward(loss)
    if values is None:
        return tuple(oshape), {p.name: tuple(p.shape)
                               for p in main.all_parameters()}
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        for n, v in values["params"].items():
            scope.set(n, v.copy())
        names = ["x"] + list(params)
        vals = exe.run(main, feed={"x": values["x"], "cot": values["cot"]},
                       fetch_list=[loss] + [n + "@GRAD" for n in names])
        frozen = {p.name: np.asarray(scope.find_var(p.name))
                  for p in main.all_parameters() if not p.trainable}
    return (np.asarray(vals[0]),
            {n: np.asarray(v) for n, v in zip(names, vals[1:])}, frozen,
            [op.type for op in main.global_block().ops])


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_layer_grad_matches_jax(name):
    shape, build, params = GRAD_CASES[name]
    oshape, pshapes = _program_grads(tfluid, tlayers, tbackward, shape,
                                     build, params, None)
    r = np.random.RandomState(3)
    values = {"x": r.randn(*shape).astype(np.float32) + 0.25,
              "cot": r.randn(*oshape).astype(np.float32),
              "params": {n: (np.abs(r.randn(*s)) + 0.5 if n == "mv"
                             else r.randn(*s) * 0.5).astype(np.float32)
                         for n, s in pshapes.items()}}
    j_loss, j_grads, j_frozen, j_ops = _program_grads(
        pfluid, players, pbackward, shape, build, params, values)
    t_loss, t_grads, t_frozen, t_ops = _program_grads(
        tfluid, tlayers, tbackward, shape, build, params, values)
    assert t_ops == j_ops
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5, atol=1e-5)
    for n, j in j_grads.items():
        assert t_grads[n].shape == j.shape, n
        np.testing.assert_allclose(t_grads[n], j, atol=2e-5, rtol=1e-5,
                                   err_msg=n)
    # moving statistics: written once by the forward op, not again by the
    # grad op's re-run of the forward
    assert sorted(t_frozen) == sorted(j_frozen)
    for n, j in j_frozen.items():
        np.testing.assert_allclose(t_frozen[n], j, atol=1e-6, rtol=0,
                                   err_msg=n)
    if name == "batch_norm":
        x = values["x"]
        want = 0.9 * values["params"]["mm"] + 0.1 * x.mean(axis=(0, 2, 3))
        np.testing.assert_allclose(t_frozen["mm"], want, atol=1e-6, rtol=0)


def test_momentum_optimizer_program_matches_jax():
    """Momentum.minimize emits the same ops and slots in both packages,
    and three steps on a tiny conv net give the same losses (Nesterov
    too)."""
    r = np.random.RandomState(5)
    feed = {"x": r.randn(4, 3, 8, 8).astype(np.float32),
            "label": r.randint(0, 5, (4, 1)).astype(np.int64)}
    for nesterov in (False, True):
        runs = []
        for fluid, layers in ((pfluid, players), (tfluid, tlayers)):
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                x = layers.data("x", shape=[3, 8, 8])
                label = layers.data("label", shape=[1], dtype="int64")
                h = layers.batch_norm(
                    layers.conv2d(x, 4, 3, padding=1, param_attr="cw",
                                  bias_attr=False),
                    act="relu", param_attr="s", bias_attr="o",
                    moving_mean_name="mm", moving_variance_name="mv")
                logits = layers.fc(layers.pool2d(h, 2, "max", 2), 5,
                                   param_attr="fw", bias_attr="fb")
                loss = layers.mean(
                    layers.softmax_with_cross_entropy(logits, label))
                opt = fluid.optimizer.Momentum(0.1, 0.9,
                                               use_nesterov=nesterov)
                opt.minimize(loss)
            runs.append((fluid, main, startup, loss, opt))
        (jf, jm, js, jl, jo), (tf, tm, ts, tl, to) = runs
        assert [o.type for o in tm.global_block().ops] == \
            [o.type for o in jm.global_block().ops]
        kinds = lambda o: sorted((d["param"], d["slot"])  # noqa: E731
                                 for d in o.slot_descriptor().values())
        assert kinds(to) == kinds(jo)
        jscope = jf.Scope()
        with jf.scope_guard(jscope):
            jexe = jf.Executor(jf.CPUPlace())
            jexe.run(js)
            state = {n: np.array(jscope.find_var(n))
                     for n in jscope.var_names()}
            j_losses = [float(jexe.run(jm, feed=feed, fetch_list=[jl])[0])
                        for _ in range(3)]
        from paddle_tpu_torch import io as tio

        state = tio.rekey_optimizer_state(state, jo.slot_descriptor(),
                                          to.slot_descriptor())
        tscope = tio.scope_from_numpy(state, tf.CPUPlace())
        with tf.scope_guard(tscope):
            texe = tf.Executor(tf.CPUPlace())
            t_losses = [float(texe.run(tm, feed=feed, fetch_list=[tl])[0])
                        for _ in range(3)]
        np.testing.assert_allclose(t_losses, j_losses, rtol=2e-5, atol=0)
        assert t_losses[-1] < t_losses[0]
