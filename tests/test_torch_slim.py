"""The port's model compression (``ops/quant_ops.py``, ``slim/``) against
the JAX package, on the CPU, at toy widths. Tolerances:

- every quant op's outputs, and the straight-through gradients of the
  differentiable ones through the port's derived grad op (against
  ``jax.vjp``), within atol 1e-6; int8 outputs exactly, as int8;
- the QAT pass writes the JAX package's program (same bytes); three SGD
  steps of the quantized tiny Transformer at dropout 0 from the JAX
  startup's weights give losses within 1e-5 of the JAX package's;
- calibration: abs_max scales within 1e-6 relative; the KL sweep equal on
  equal activations (the same numpy code), and within one coarse bin
  (amax / 2048) end to end; ``freeze`` inserts the same ops;
- the int8 artifact written by either package loads in the other with
  the dequantized weights bit for bit equal, its ``__model__`` the same
  bytes; a conv + batch-norm net keeps its batch-norm statistics in f32
  (bit for bit) and stays within 0.2 relative of f32
  (``tests/test_calibration.py:155``);
- the distillation loss within 1e-6; uniform and sensitive pruning
  masks, ratios and masked weights equal on equal weights;
- a JAX-written int8 artifact served by the port's ``ServingEngine``
  gives the JAX engine's greedy tokens, token for token.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pfluid
from paddle_tpu import serving as pserving
from paddle_tpu import slim as pslim
from paddle_tpu.core.registry import get_op_def as jax_op
from paddle_tpu.models import resnet as PR
from paddle_tpu.models import transformer as PT
from paddle_tpu.slim import calibration as pcal

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import slim as tslim
from paddle_tpu_torch.core.interp import resolve_op_def
from paddle_tpu_torch.core.registry import get_op_def as port_op
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.slim import calibration as tcal

_CPU = torch.device("cpu")
_PKG = {"jax": (pfluid, PT, PR, pslim, pcal),
        "torch": (tfluid, TT, TR, tslim, tcal)}
_CFG = dict(src_vocab_size=37, trg_vocab_size=41, max_length=64, d_model=16,
            d_inner=32, n_head=2, n_layer=2, dropout=0.0,
            label_smooth_eps=0.0)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# --- the quant ops -------------------------------------------------------

_X = _rand(4, 3, 3, 3, seed=1)
_CASES = {
    "fake_quantize_abs_max": ({"X": [_X]}, {"bit_length": 8}),
    "fake_quantize_abs_max 4 bits": ({"X": [_X]}, {"bit_length": 4}),
    "fake_channel_wise_quantize_abs_max": ({"X": [_X]}, {}),
    "fake_quantize_range_abs_max": (
        {"X": [_X], "InScales": [np.array([0.5, 4.0, 1.0], np.float32)],
         "Iter": [np.array([4], np.int64)]}, {}),
    "fake_quantize_range_abs_max is_test": (
        {"X": [_X], "InScales": [np.array([0.5, 4.0, 1.0], np.float32)],
         "Iter": [np.array([4], np.int64)]}, {"is_test": True}),
    "fake_quantize_moving_average_abs_max": (
        {"X": [_X], "InState": [np.array([2.0], np.float32)],
         "InAccum": [np.array([3.0], np.float32)]}, {"moving_rate": 0.8}),
    "fake_quantize_moving_average_abs_max is_test": (
        {"X": [_X], "InState": [np.array([2.0], np.float32)],
         "InAccum": [np.array([3.0], np.float32)]}, {"is_test": True}),
    "moving_average_abs_max_scale": (
        {"X": [_X], "InState": [np.array([1.0], np.float32)],
         "InAccum": [np.array([2.5], np.float32)]}, {}),
    "fake_dequantize_max_abs": (
        {"X": [np.round(_X * 40)], "Scale": [np.array([2.5], np.float32)]},
        {"max_range": 127.0}),
    "fake_channel_wise_dequantize_max_abs": (
        {"X": [np.round(_X * 40)],
         "Scales": [np.array([1.5, 2.0, 0.7, 3.0], np.float32),
                    np.array([1.25], np.float32)]}, {}),
    "quantize": ({"Input": [_X]}, {"Scale": 37.5}),
    "dequantize": ({"Input": [np.round(_X * 40)]}, {"Scale": 37.5}),
    "requantize": ({"Input": [np.round(_X * 40)]},
                   {"Scale_in": 37.5, "Scale_out": 21.0}),
    "fake_quantize_dequantize_moving_average_abs_max": (
        {"X": [_X], "InState": [np.array([2.0], np.float32)],
         "InAccum": [np.array([3.0], np.float32)]}, {}),
    "quantize_dequantize_static": ({"X": [_X]}, {"scale": 1.7, "bits": 8}),
    "fake_quantize_dequantize": ({"X": [_X]}, {"bits": 8}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_quant_op_matches_jax(case):
    op_type = case.split(" ")[0]
    ins, attrs = _CASES[case]
    jouts = jax_op(op_type).compute(
        {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))
    touts = port_op(op_type).compute(
        {k: [torch.from_numpy(v) for v in vs] for k, vs in ins.items()},
        dict(attrs), device=_CPU)
    assert set(touts) == set(jouts)
    for slot in jouts:
        for j, t in zip(jouts[slot], touts[slot]):
            j = np.asarray(j)
            t = t.numpy()
            assert t.shape == j.shape, slot
            if op_type in ("quantize", "requantize"):
                assert t.dtype == np.int8 and j.dtype == np.int8
                np.testing.assert_array_equal(t, j)
            else:
                np.testing.assert_allclose(t, j, atol=1e-6, rtol=0,
                                           err_msg=f"{case} {slot}")


@pytest.mark.parametrize("case", sorted(
    c for c in _CASES if not port_op(c.split(" ")[0]).no_grad))
def test_quant_op_gradient_is_the_jax_straight_through(case):
    """The derived grad op of the port against ``jax.vjp`` of the JAX op,
    on a random cotangent of Out."""
    op_type = case.split(" ")[0]
    ins, attrs = _CASES[case]
    g = _rand(*_X.shape, seed=9)

    def jfwd(x):
        j_ins = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}
        j_ins["X"] = [x]
        return jax_op(op_type).compute(j_ins, dict(attrs))["Out"][0]

    _, vjp = jax.vjp(jfwd, jnp.asarray(ins["X"][0]))
    (want,) = vjp(jnp.asarray(g, dtype=jnp.float32))
    grad_op = resolve_op_def(op_type + "_grad")
    t_ins = {k: [torch.from_numpy(v) for v in vs] for k, vs in ins.items()}
    t_ins["GRAD::Out"] = [torch.from_numpy(g)]
    out = grad_op.compute(t_ins, dict(attrs, fwd_input_slots=sorted(ins),
                                      fwd_output_slots=["Out"]),
                          device=_CPU)
    got = out["GRAD::X"][0].numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
    if op_type != "fake_dequantize_max_abs" and "channel_wise_dequant" \
            not in op_type and op_type != "moving_average_abs_max_scale":
        # inside the clip range the estimator passes the cotangent through
        np.testing.assert_array_equal(got, g)


# --- QAT ------------------------------------------------------------------


def _qat_program(pkg):
    fluid, T, _, slim, _ = _PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        m = T.build(T.TransformerConfig(**_CFG))
        n = slim.QuantizationTransformPass().apply(main)
        fluid.optimizer.SGD(0.5).minimize(m["loss"])
    return main, startup, m["loss"], n


def test_qat_pass_and_three_steps_match_jax():
    (jm, js, jloss, jn), (tm, ts, tloss, tn) = (_qat_program("jax"),
                                                 _qat_program("torch"))
    assert tn == jn > 0
    assert tm.desc_str() == jm.desc_str()
    types = [op.type for op in tm.global_block().ops]
    assert types.count("fake_quantize_dequantize") == tn
    # one batch three times: the loss falls
    feeds = [TT.make_batch(TT.TransformerConfig(**_CFG), 3, 10, 7, seed=0)
             ] * 3
    jscope, tscope = pfluid.Scope(), tfluid.Scope()
    jexe, texe = (pfluid.Executor(pfluid.CPUPlace()),
                  tfluid.Executor(tfluid.CPUPlace()))
    with pfluid.scope_guard(jscope):
        jexe.run(js)
        start = {p.name: np.array(jscope.find_var(p.name))
                 for p in jm.all_parameters()}
        jl = [float(np.asarray(jexe.run(jm, feed=f, fetch_list=[jloss])[0]))
              for f in feeds]
    with tfluid.scope_guard(tscope):
        texe.run(ts)
        for n, v in start.items():
            tscope.set(n, torch.tensor(v))
        tl = [float(texe.run(tm, feed=f, fetch_list=[tloss])[0])
              for f in feeds]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    assert tl[2] < tl[0]


# --- calibration and the int8 artifact ------------------------------------


def _mlp(pkg, scope_weights=None):
    """An is_test MLP (two fc, softmax) with the JAX startup's weights in
    both packages."""
    fluid = _PKG[pkg][0]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("img", shape=[24], dtype="float32")
        h = fluid.layers.fc(x, 32, act="relu")
        out = fluid.layers.softmax(fluid.layers.fc(h, 5))
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
    if scope_weights is not None:
        for n, v in scope_weights.items():
            scope.set(n, torch.tensor(v) if pkg == "torch" else v)
    return main, out, scope, exe


def _calibrate(pkg, algo, weights=None, batches=3):
    main, out, scope, exe = _mlp(pkg, weights)
    cal = _PKG[pkg][4]
    c = cal.Calibrator(main, exe, scope=scope, algo=algo)
    for s in range(batches):
        c.sample({"img": _rand(16, 24, seed=40 + s, scale=2.0)})
    return c, c.compute_scales(), main, out, scope, exe


def _jax_weights():
    main, _, scope, _ = _mlp("jax")
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.list_vars() if v.persistable}


@pytest.mark.parametrize("algo", ["abs_max", "KL"])
def test_calibrator_scales_and_freeze_match_jax(algo):
    w = _jax_weights()
    jc, js, *_ = _calibrate("jax", algo, w)
    tc, ts, *_ = _calibrate("torch", algo, w)
    assert tc.activation_names == jc.activation_names
    assert tc.weight_names == jc.weight_names
    assert set(ts) == set(js)
    for n in js:
        if algo == "abs_max":
            assert abs(ts[n] - js[n]) <= 1e-6 * js[n], n
        else:
            assert abs(ts[n] - js[n]) <= tc._amax[n] / 2048, n
    jf, tf = jc.freeze(), tc.freeze()
    jops = [(o.type, o.inputs, o.outputs) for o in jf.global_block().ops]
    tops = [(o.type, o.inputs, o.outputs) for o in tf.global_block().ops]
    assert tops == jops
    assert [o.type for o in tf.global_block().ops].count(
        "quantize_dequantize_static") == len(js)


def test_kl_sweep_is_the_jax_sweep_on_equal_activations():
    r = np.random.RandomState(3)
    samples = [np.abs(r.standard_t(3, size=(64, 40))).astype(np.float32)
               for _ in range(3)]
    assert tcal._kl_scale(samples) == pcal._kl_scale(samples)
    assert tcal._abs_max_scale(samples) == pcal._abs_max_scale(samples)
    hist = r.poisson(5.0, 2048).astype(np.float64)
    assert tcal._kl_from_hist(hist, 3.5) == pcal._kl_from_hist(hist, 3.5)


def _scope_arrays(scope, names):
    return {n: np.asarray(scope.find_var(n)) for n in names}


def _load_int8(pkg, d):
    fluid, cal = _PKG[pkg][0], _PKG[pkg][4]
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        prog, feeds, fetches = cal.load_int8_inference_model(d, exe,
                                                              scope=scope)
        outs = exe.run(prog, feed={"img": _rand(6, 24, seed=77, scale=2.0)},
                       fetch_list=fetches)
    return prog, scope, np.asarray(outs[0])


def test_int8_artifact_loads_across_packages_bit_for_bit(tmp_path):
    w = _jax_weights()
    dirs = {}
    for pkg in ("jax", "torch"):
        c, _, main, out, scope, exe = _calibrate(pkg, "abs_max", w)
        d = dirs[pkg] = str(tmp_path / pkg)
        with _PKG[pkg][0].scope_guard(scope):
            _PKG[pkg][4].save_int8_inference_model(
                d, ["img"], [out], exe, main, c, scope=scope)
    for name in ("__params_int8__.npz", "__params__.npz"):
        a, b = (np.load(os.path.join(dirs[p], name)) for p in dirs)
        assert sorted(a.files) == sorted(b.files)
        for n in a.files:
            np.testing.assert_array_equal(a[n], b[n])
    with open(os.path.join(dirs["jax"], "__int8_scales__.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(dirs["torch"], "__int8_scales__.json")) as f:
        tmeta = json.load(f)
    assert tmeta["weight_scales"] == jmeta["weight_scales"]
    # each package's artifact in the other: the same dequantized weights
    for src in ("jax", "torch"):
        jprog, jscope, jout = _load_int8("jax", dirs[src])
        tprog, tscope, tout = _load_int8("torch", dirs[src])
        names = [v.name for v in tprog.list_vars() if v.persistable]
        jw, tw = _scope_arrays(jscope, names), _scope_arrays(tscope, names)
        for n in names:
            assert tw[n].dtype == jw[n].dtype == np.float32
            np.testing.assert_array_equal(tw[n], jw[n], err_msg=n)
        np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
        assert [(o.type, o.inputs, o.outputs) for o in
                tprog.global_block().ops] == [
            (o.type, o.inputs, o.outputs) for o in jprog.global_block().ops]


def test_conv_bn_int8_round_trip_keeps_the_variance_f32(tmp_path):
    """resnet_cifar10 (depth 8): batch-norm statistics stay in the f32
    file, the int8 file holds the conv filters and the classifier
    weight alone, and the frozen program stays within 0.2 of f32."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        img = tfluid.layers.data("img", shape=[3, 16, 16], dtype="float32")
        logits = TR.resnet_cifar10(img, class_dim=10, depth=8, is_test=True)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    d = str(tmp_path / "i8")
    with tfluid.scope_guard(scope):
        exe.run(startup)
        var = [n for n in scope.var_names() if "batch_norm" in n
               and n.endswith(".w_2")][0]
        v = scope.find_var(var).clone()
        v[: len(v) // 2] = 1e-4
        v[len(v) // 2:] = 5.0
        scope.set(var, v)
        c = tcal.Calibrator(main, exe, scope=scope, algo="abs_max")
        for s in range(2):
            c.sample({"img": _rand(4, 3, 16, 16, seed=s)})
        tcal.save_int8_inference_model(d, ["img"], [logits], exe, main, c,
                                       scope=scope)
        x = _rand(6, 3, 16, 16, seed=9)
        (ref,) = exe.run(main, feed={"img": x}, fetch_list=[logits])
    qs = np.load(os.path.join(d, "__params_int8__.npz"))
    assert var not in qs.files
    assert all("conv2d" in n or "fc" in n for n in qs.files), qs.files
    assert np.load(os.path.join(d, "__params__.npz"))[var].dtype == \
        np.float32
    scope2, exe2 = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope2):
        prog, _, fetches = tcal.load_int8_inference_model(d, exe2,
                                                          scope=scope2)
        np.testing.assert_array_equal(scope2.find_var(var).numpy(),
                                      v.numpy())
        (q_out,) = exe2.run(prog, feed={"img": x}, fetch_list=fetches)
    err = np.abs(ref - q_out).max() / max(np.abs(ref).max(), 1e-6)
    assert err < 0.2, err


# --- distillation and pruning --------------------------------------------


def test_soft_label_distill_loss_matches_jax():
    s, t = _rand(6, 9, seed=1, scale=3.0), _rand(6, 9, seed=2, scale=3.0)
    losses = []
    for pkg in ("jax", "torch"):
        fluid, slim = _PKG[pkg][0], _PKG[pkg][3]
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            sv = fluid.layers.data("s", shape=[9], dtype="float32")
            tv = fluid.layers.data("t", shape=[9], dtype="float32")
            loss = slim.soft_label_distill_loss(sv, tv, temperature=3.0)
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            losses.append(float(np.asarray(exe.run(
                main, feed={"s": s, "t": t}, fetch_list=[loss])[0])))
    assert abs(losses[1] - losses[0]) <= 1e-6
    assert losses[0] > 0


def _prune_scopes():
    r = np.random.RandomState(5)
    w = {"conv1_weights": r.randn(8, 3, 3, 3).astype(np.float32),
         "conv2_weights": r.randn(6, 8, 1, 1).astype(np.float32),
         "fc_w": r.randn(4, 4).astype(np.float32)}
    js, ts = pfluid.Scope(), tfluid.Scope()
    for n, v in w.items():
        js.set(n, jnp.asarray(v))
        ts.set(n, torch.tensor(v))
    return js, ts


def _eval(scope):
    """A metric of the live weights, the same arithmetic in both."""
    a = np.asarray(scope.find_var("conv1_weights"))
    b = np.asarray(scope.find_var("conv2_weights"))
    return -float(np.abs(a).sum() * 0.01 + np.abs(b).sum() * 0.02) * 0.1


def test_uniform_pruning_matches_jax():
    js, ts = _prune_scopes()
    jstrat = pslim.UniformPruneStrategy(target_ratio=0.5,
                                        pruned_params="conv.*_weights")
    tstrat = tslim.UniformPruneStrategy(target_ratio=0.5,
                                        pruned_params="conv.*_weights")
    jm, tm = jstrat.on_compression_begin(js), tstrat.on_compression_begin(ts)
    assert sorted(tm) == sorted(jm) == ["conv1_weights", "conv2_weights"]
    for n in jm:
        np.testing.assert_array_equal(tm[n], jm[n])
        np.testing.assert_array_equal(ts.find_var(n).numpy(),
                                      np.asarray(js.find_var(n)))
    assert tslim.pruned_ratio(ts, tm) == pslim.pruned_ratio(js, jm) == 0.5
    # a tensor the training step would write: on_batch_end re-zeroes it
    # in place, so a captured step's buffer keeps its identity
    t = ts.find_var("conv1_weights")
    t += 1.0
    tstrat.on_batch_end(ts)
    assert ts.find_var("conv1_weights") is t
    zero = np.where(tm["conv1_weights"] == 0)[0]
    assert not t[zero].any() and t[np.where(tm["conv1_weights"])[0]].all()


def test_sensitive_pruning_matches_jax():
    js, ts = _prune_scopes()
    kw = dict(delta_rate=0.25, target_ratio=0.5,
              pruned_params="conv.*_weights", max_metric_loss=0.05)
    jstrat = pslim.SensitivePruneStrategy(**kw)
    tstrat = tslim.SensitivePruneStrategy(**kw)
    jr = jstrat.prune(js, lambda: _eval(js))
    tr = tstrat.prune(ts, lambda: _eval(ts))
    assert tr == jr
    assert tstrat.sensitivities == jstrat.sensitivities
    for n in jstrat.masks:
        np.testing.assert_array_equal(tstrat.masks[n], jstrat.masks[n])
        np.testing.assert_array_equal(ts.find_var(n).numpy(),
                                      np.asarray(js.find_var(n)))


# --- the int8 artifact served ---------------------------------------------


def test_jax_int8_artifact_served_by_the_port_gives_the_jax_tokens(
        tmp_path):
    cfg = PT.TransformerConfig(**_CFG)
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        model = PT.build(cfg, is_test=True)
    exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
    d = str(tmp_path / "int8")
    with pfluid.scope_guard(scope):
        exe.run(startup)
        calib = pcal.Calibrator(main, exe, scope=scope, algo="abs_max")
        for s in range(2):
            calib.sample(PT.make_batch(cfg, 2, 5, 5, seed=s))
        calib.compute_scales()
        pcal.save_int8_inference_model(
            d, ["src_ids", "trg_ids", "lbl_ids", "src_pad_mask",
                "trg_pad_mask"], [model["logits"]], exe, main, calib,
            scope=scope)
    r = np.random.RandomState(10)
    srcs = [r.randint(2, 37, (n,)).astype(np.int64) for n in (5, 3, 7, 2)]
    out = []
    for mod, c, place in ((pserving, cfg, pfluid.CPUPlace()),
                          (tserving, TT.TransformerConfig(**_CFG),
                           tfluid.CPUPlace())):
        eng = mod.ServingEngine(c, d, slots=2, src_len=8, max_len=8,
                                place=place)
        assert eng.int8 and eng.stats()["int8"]
        hs = [eng.submit(s) for s in srcs]
        eng.run_until_idle()
        out.append([list(h.tokens) for h in hs])
        eng.close()
    assert out[1] == out[0]
    assert all(len(t) > 0 for t in out[1])
