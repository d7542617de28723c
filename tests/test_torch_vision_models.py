"""ResNet and SE-ResNeXt built by the port against the JAX package's, on
the CPU at small sizes.

Both packages build the model from the same code, so the two Programs
must hold the same op types in the same order and the same parameter
names and shapes. The JAX package's startup weights are carried across by
name (``io.scope_from_numpy``; optimizer slots by (param, kind) through
``io.rekey_optimizer_state``), the same numpy batch goes through both,
and losses, accuracy, logits, gradients, moving statistics and velocities
are compared in f32.

Tolerances. Forward quantities (loss, logits, moving statistics) agree
within a few f32 ulps times the depth. Gradients of a freshly initialized
batch-normalized ReLU net amplify rounding differences layer by layer
(at 50 layers a 1e-6 relative change of the input moves the first layers'
gradients by percents, in either package), so the multi-step and
all-gradient checks run on shallow models (ResNet-18, a two-block
SE-ResNeXt) and ResNet-50 holds the forward quantities and the
classifier head's gradients. SE-ResNeXt's head has a dropout whose bits
differ between the packages: the full model is held with ``is_test=True``
and a training step on a program built from the model's public pieces
with a head without dropout."""

import numpy as np
import pytest

import paddle_tpu as pfluid
from paddle_tpu.dataset import imagenet as pimagenet
from paddle_tpu.models import resnet as presnet
from paddle_tpu.models import se_resnext as pse

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.dataset import imagenet as timagenet
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import se_resnext as tse


def _se_pieces(fluid, S, data_shape, class_dim, blocks):
    """A short SE-ResNeXt from the model's public pieces (stem, the given
    (filters, stride) bottleneck blocks with cardinality 4, pool, fc), with
    no dropout in the head."""
    layers = fluid.layers
    img = layers.data("data", shape=list(data_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    x = S.conv_bn_layer(img, 16, 3, act="relu", prefix="stem")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    for i, (filters, stride) in enumerate(blocks):
        x = S.bottleneck_block(x, filters, stride, cardinality=4,
                               reduction_ratio=4, is_test=False,
                               prefix=f"b{i}")
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    pool = layers.reshape(pool, [-1, pool.shape[1]])
    logits = layers.fc(pool, class_dim,
                       param_attr=fluid.ParamAttr(name="fc_out.w"),
                       bias_attr=fluid.ParamAttr(name="fc_out.b"))
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return {"feeds": [img, label], "loss": loss, "acc": acc,
            "logits": logits}


_SE_BLOCKS = [(16, 1), (32, 2)]

# name -> (build function given (fluid, resnet module, se module), trains)
MODELS = {
    "resnet18": (lambda f, R, S: R.get_model(
        data_shape=(3, 64, 64), class_dim=10, depth=18), True),
    "resnet_cifar10": (lambda f, R, S: R.get_model(
        data_shape=(3, 32, 32), class_dim=10), True),
    "resnet50": (lambda f, R, S: R.get_model(
        data_shape=(3, 64, 64), class_dim=10, depth=50), True),
    "se_resnext50_train": (lambda f, R, S: S.get_model(
        data_shape=(3, 64, 64), class_dim=10, depth=50), True),
    "se_resnext50_test": (lambda f, R, S: S.get_model(
        data_shape=(3, 64, 64), class_dim=10, depth=50, is_test=True),
        False),
    "se_pieces": (lambda f, R, S: _se_pieces(
        f, S, (3, 32, 32), 10, _SE_BLOCKS), True),
}


def _build(fluid, R, S, name, lr=0.1):
    build, trains = MODELS[name]
    main, startup = fluid.Program(), fluid.Program()
    opt = None
    with fluid.program_guard(main, startup):
        with fluid.unique_name.guard():
            model = build(fluid, R, S)
            if trains:
                opt = fluid.optimizer.Momentum(lr, momentum=0.9)
                opt.minimize(model["loss"])
    return main, startup, model, opt


def _both(name, lr=0.1):
    return (_build(pfluid, presnet, pse, name, lr),
            _build(tfluid, tresnet, tse, name, lr))


def _batch(image, classes, n=4, seed=0):
    r = np.random.RandomState(seed)
    return {"data": r.uniform(-1, 1, (n, 3, image, image)).astype(np.float32),
            "label": r.randint(0, classes, (n, 1)).astype(np.int64)}


def _jax_startup(startup):
    scope = pfluid.Scope()
    exe = pfluid.Executor(pfluid.CPUPlace())
    with pfluid.scope_guard(scope):
        exe.run(startup)
    return scope, exe


def _values(scope):
    return {n: np.array(scope.find_var(n)) for n in scope.var_names()}


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_programs_have_the_same_ops_and_parameters(name):
    (jm, js, _, jo), (tm, ts, _, to) = _both(name)
    for jp, tp in ((jm, tm), (js, ts)):
        assert [o.type for o in tp.global_block().ops] == \
            [o.type for o in jp.global_block().ops]
    jparams = {p.name: (tuple(p.shape), p.trainable)
               for p in jm.all_parameters()}
    tparams = {p.name: (tuple(p.shape), p.trainable)
               for p in tm.all_parameters()}
    assert tparams == jparams and tparams
    # every batch_norm's moving statistics are non-trainable parameters
    # written back under their own names
    for op in tm.global_block().ops:
        if op.type == "batch_norm":
            assert op.outputs["MeanOut"] == op.inputs["Mean"]
            assert op.outputs["VarianceOut"] == op.inputs["Variance"]
            assert not tparams[op.inputs["Mean"][0]][1]
    if jo is not None:
        kinds = lambda o: sorted((d["param"], d["slot"])  # noqa: E731
                                 for d in o.slot_descriptor().values())
        assert kinds(to) == kinds(jo)
        assert {k for _, k in kinds(to)} == {"velocity", "learning_rate"}


def _train_both(name, image, classes, steps, grad_names, lr=0.1):
    """Run ``steps`` Momentum steps of model ``name`` in both packages from
    the JAX package's startup state; returns per package the per-step
    [loss, acc, logits, *grads] and the final scope values, with the
    port's slot names mapped back by (param, kind)."""
    (jm, js, jmodel, jo), (tm, _, tmodel, to) = _both(name, lr)
    feed = _batch(image, classes)
    jscope, jexe = _jax_startup(js)
    state = _values(jscope)

    def fetches(model):
        return [model["loss"], model["acc"], model["logits"]] + \
            [n + "@GRAD" for n in grad_names]

    with pfluid.scope_guard(jscope):
        j_steps = [[np.asarray(v) for v in
                    jexe.run(jm, feed=feed, fetch_list=fetches(jmodel))]
                   for _ in range(steps)]
    tstate = tio.rekey_optimizer_state(state, jo.slot_descriptor(),
                                       to.slot_descriptor())
    tscope = tio.scope_from_numpy(tstate, tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tscope):
        t_steps = [texe.run(tm, feed=feed, fetch_list=fetches(tmodel))
                   for _ in range(steps)]
    t_final = {n: tscope.find_var(n).numpy() for n in tscope.var_names()}
    # back onto the JAX package's slot names
    t_final = tio.rekey_optimizer_state(t_final, to.slot_descriptor(),
                                        jo.slot_descriptor())
    return jm, j_steps, _values(jscope), t_steps, t_final


def _moving_stats(program):
    return [n for op in program.global_block().ops if op.type == "batch_norm"
            for n in (op.inputs["Mean"][0], op.inputs["Variance"][0])]


@pytest.mark.parametrize("name,image,lr,state_tol,grad_names", [
    ("resnet18", 64, 0.01, 1e-2,
     ["conv2d_0.w_0", "conv2d_7.w_0", "conv2d_19.w_0", "batch_norm_0.w_0",
      "batch_norm_19.b_0", "fc_0.w_0", "fc_0.b_0"]),
    ("se_pieces", 32, 0.1, 1e-4,
     ["stem_conv.w", "b0_c1_conv.w", "b0_se_sqz.w", "b0_se_exc.b",
      "b1_sc_conv.w", "b1_c2_bn.scale", "fc_out.w", "fc_out.b"]),
])
def test_three_momentum_steps_match_jax(name, image, lr, state_tol,
                                        grad_names):
    """First step: loss, accuracy, logits, named gradients; then the loss
    of each of three steps, and after them every parameter, moving
    statistic and velocity (carried across by (param, kind)). f32; limits
    are 5-10x what was read here: first-step loss within 1.1e-6
    (relative), logits 1.6e-5, gradients 1.9e-5 of their largest element;
    three-step losses within 7.8e-6; final state within 1.8e-3 for
    ResNet-18 (17 layers feed each step's differences to the next; at the
    benchmark's rate 0.1 they reach 9e-2, so this run uses 0.01) and
    9.3e-6 for the two-block SE-ResNeXt at rate 0.1."""
    jm, j_steps, j_final, t_steps, t_final = _train_both(
        name, image, 10, 3, grad_names, lr)
    j0, t0 = j_steps[0], t_steps[0]
    np.testing.assert_allclose(t0[0], j0[0], rtol=1e-5)
    assert float(t0[1]) == float(j0[1])
    np.testing.assert_allclose(t0[2], j0[2], atol=1e-4, rtol=0)
    for n, j, t in zip(grad_names, j0[3:], t0[3:]):
        assert t.shape == j.shape, n
        assert _rel(t, j) <= 2e-4, (n, _rel(t, j))
    for step, (j, t) in enumerate(zip(j_steps, t_steps)):
        np.testing.assert_allclose(t[0], j[0], rtol=5e-5, err_msg=str(step))
    assert t_steps[-1][0] < t_steps[0][0]
    assert sorted(t_final) == sorted(j_final)
    assert any("velocity" in n for n in j_final)
    for n, j in j_final.items():
        assert t_final[n].shape == j.shape, n
        assert _rel(t_final[n], j) <= state_tol, (n, _rel(t_final[n], j))
    # the moving statistics moved off their initial 0 / 1
    mean0, var0 = _moving_stats(jm)[:2]
    assert np.abs(t_final[mean0]).max() > 0
    assert np.abs(t_final[var0] - 1).max() > 0


def test_resnet50_first_step_matches_jax():
    """One Momentum step of ResNet-50 at a small image: the forward
    quantities (loss, accuracy, logits, updated moving statistics) and the
    classifier head's gradients are held, at 4-6x what was read here (loss
    8.5e-5 relative, logits 1.2e-3, head gradients 4.7e-4, moving
    statistics 1.8e-4); the other named gradients (read 5e-2 to 3.2e-1 of
    their largest element) only stay below it (see the module
    docstring)."""
    head = ["fc_0.w_0", "fc_0.b_0"]
    deep = ["conv2d_0.w_0", "conv2d_26.w_0", "conv2d_52.w_0",
            "batch_norm_0.w_0"]
    jm, j_steps, j_final, t_steps, t_final = _train_both(
        "resnet50", 64, 10, 1, head + deep)
    j, t = j_steps[0], t_steps[0]
    np.testing.assert_allclose(t[0], j[0], rtol=5e-4)
    assert float(t[1]) == float(j[1])
    np.testing.assert_allclose(t[2], j[2], atol=5e-3, rtol=0)
    for n, jg, tg in zip(head + deep, j[3:], t[3:]):
        assert tg.shape == jg.shape and np.isfinite(tg).all(), n
        assert _rel(tg, jg) <= (2e-3 if n in head else 1.0), (n, _rel(tg, jg))
    for n in _moving_stats(jm):
        assert _rel(t_final[n], j_final[n]) <= 1e-3, n
    velocities = [n for n in j_final if "velocity" in n]
    assert len(velocities) == len([p for p in jm.all_parameters()
                                   if p.trainable])
    assert all(n in t_final for n in velocities)


def test_resnet_cifar10_first_step_matches_jax():
    """The CIFAR-10 ResNet-32 (31 layers) at rate 0.1: read loss 1.7e-7
    relative, logits 1.7e-5, head gradient 4.5e-6, first-layer gradient
    2.9e-3, moving statistics 5.3e-6."""
    jm, j_steps, j_final, t_steps, t_final = _train_both(
        "resnet_cifar10", 32, 10, 1, ["fc_0.w_0", "conv2d_0.w_0"])
    j, t = j_steps[0], t_steps[0]
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
    np.testing.assert_allclose(t[2], j[2], atol=1e-4, rtol=0)
    assert _rel(t[3], j[3]) <= 5e-5 and _rel(t[4], j[4]) <= 2e-2
    for n in _moving_stats(jm):
        assert _rel(t_final[n], j_final[n]) <= 5e-5, n


def test_se_resnext50_logits_match_jax_in_test_mode():
    """The whole SE-ResNeXt-50 with ``is_test=True`` (moving statistics,
    dropout scaled): loss, accuracy and logits."""
    (jm, js, jmodel, _), (tm, _, tmodel, _) = _both("se_resnext50_test")
    feed = _batch(64, 10)
    jscope, jexe = _jax_startup(js)
    state = _values(jscope)
    with pfluid.scope_guard(jscope):
        j = jexe.run(jm, feed=feed, fetch_list=[
            jmodel["loss"], jmodel["acc"], jmodel["logits"]])
    with tfluid.scope_guard(tio.scope_from_numpy(state, tfluid.CPUPlace())):
        t = tfluid.Executor(tfluid.CPUPlace()).run(tm, feed=feed, fetch_list=[
            tmodel["loss"], tmodel["acc"], tmodel["logits"]])
    np.testing.assert_allclose(t[0], np.asarray(j[0]), rtol=1e-5)
    assert float(t[1]) == float(np.asarray(j[1]))
    np.testing.assert_allclose(t[2], np.asarray(j[2]), atol=1e-4, rtol=0)
    assert t[2].shape == (4, 10) and np.isfinite(t[2]).all()


def test_se_resnext50_trains_on_the_cpu():
    """The port's full training program (dropout in the head, its own
    mask) takes two finite Momentum steps and updates its moving
    statistics."""
    tm, ts, tmodel, _ = _build(tfluid, tresnet, tse, "se_resnext50_train")
    tm.random_seed = ts.random_seed = 7
    feed = _batch(64, 10)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(ts)
        (loss,) = exe.run_steps(tm, [feed], 2, [tmodel["loss"]])
    assert np.isfinite(loss)
    assert float(scope.find_var("stem_bn.mean").abs().max()) > 0
    assert float((scope.find_var("stem_bn.var") - 1).abs().max()) > 0


def test_amp_runs_the_vision_stream_in_bf16():
    """Under ``amp.enable_amp`` the convolutions and what follows them run
    in bf16, the loss, the statistics and the master weights stay f32."""
    tm, ts, tmodel, _ = _build(tfluid, tresnet, tse, "se_pieces")
    tfluid.amp.enable_amp(tm)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(ts)
        loss, logits = exe.run(tm, feed=_batch(32, 10),
                               fetch_list=[tmodel["loss"], tmodel["logits"]],
                               async_fetch=True)
    import torch

    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    assert torch.isfinite(loss)
    assert scope.find_var("stem_conv.w").dtype == torch.float32
    assert scope.find_var("stem_bn.mean").dtype == torch.float32


def test_imagenet_reader_gives_the_jax_packages_batches():
    for seed in (22, 5):
        jb = list(pimagenet.batched(3, 2, seed=seed, data_shape=(3, 8, 8),
                                    class_dim=7)())
        tb = list(timagenet.batched(3, 2, seed=seed, data_shape=(3, 8, 8),
                                    class_dim=7)())
        assert len(jb) == len(tb) == 2
        for j, t in zip(jb, tb):
            assert sorted(j) == sorted(t) == ["data", "label"]
            for k in j:
                assert t[k].dtype == j[k].dtype
                np.testing.assert_array_equal(t[k], j[k])
    assert timagenet.SHAPE == pimagenet.SHAPE
    assert timagenet.NUM_CLASSES == pimagenet.NUM_CLASSES
    (ji, jl), (ti, tl) = (next(m.train(2, seed=3)()) for m in (pimagenet,
                                                               timagenet))
    np.testing.assert_array_equal(ti, ji)
    assert tl == jl
