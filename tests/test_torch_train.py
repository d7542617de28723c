"""The port's training path (paddle_tpu_torch) against the JAX package's, on
the CPU: transformer.build + optimizer.minimize + Executor.run /
run_steps, with the JAX package's weights carried across by name.

The config is tests/test_torch_serving.py's tiny transformer (two
layers, d_model 16) with label smoothing 0.1 and dropout 0 (dropout bits
differ between the packages by design; dropout itself is held to
properties in tests/test_torch_dropout.py). Tolerances:

- first-step loss and every parameter gradient, and 5 SGD steps: atol
  1e-5 (f32; the two frameworks sum in different orders, read <= 1e-6);
- 3 Adam steps: atol 1e-5 on the loss. Adam divides each gradient by
  the root of its own running square, so f32 summation-order noise in a
  near-zero gradient element moves its update by up to the learning
  rate; over three steps at lr 1e-3 the losses read within 1e-6;
- bf16 AMP on both sides: the first-step loss within 1e-2, below one
  bf16 ulp of a loss near 4 (2^-6): the frameworks round the bf16 stream
  at different places (read 1.3e-3).
"""

import numpy as np
import pytest

import paddle_tpu as pfluid
from paddle_tpu import amp as pamp
from paddle_tpu import unique_name as punique
from paddle_tpu.models import transformer as PT

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import unique_name as tunique
from paddle_tpu_torch.models import transformer as TT

from tests.test_torch_serving import (
    _op_signature,
    _persistables,
    assert_infer_gaps_within_jax,
)

_CFG = dict(src_vocab_size=37, trg_vocab_size=41, max_length=64, d_model=16,
            d_inner=32, n_head=2, n_layer=2, dropout=0.0,
            label_smooth_eps=0.1)
_PKGS = {"jax": (pfluid, PT, pamp, punique),
         "torch": (tfluid, TT, tamp, tunique)}


def _feed(seed=2, batch=3, src_len=10, trg_len=7, cfg=_CFG):
    return PT.make_batch(PT.TransformerConfig(**cfg), batch, src_len,
                         trg_len, seed=seed)


def _build(pkg, make_opt, amp=False, cfg=_CFG):
    fluid, T, amp_mod, unique = _PKGS[pkg]
    main, startup = fluid.Program(), fluid.Program()
    with unique.guard(), fluid.program_guard(main, startup):
        model = T.build(T.TransformerConfig(**cfg))
        opt = make_opt(fluid)
        opt.minimize(model["loss"])
    if amp:
        amp_mod.enable_amp(main)
    return main, startup, model, opt


def _pair(make_opt, amp=False):
    """Both packages' programs; the port's scope holds the JAX package's
    initial state (parameters by name, the rest from its startup)."""
    pmain, pstart, pm, _ = _build("jax", make_opt, amp)
    tmain, tstart, tm, _ = _build("torch", make_opt, amp)
    pscope, tscope = pfluid.Scope(), tfluid.Scope()
    pexe, texe = pfluid.Executor(pfluid.CPUPlace()), tfluid.Executor(
        tfluid.CPUPlace())
    with pfluid.scope_guard(pscope):
        pexe.run(pstart)
    with tfluid.scope_guard(tscope):
        texe.run(tstart)
    for p in tmain.all_parameters():
        tscope.set(p.name, np.array(pscope.find_var(p.name)))

    def step(fetch_p, fetch_t, feed):
        with pfluid.scope_guard(pscope):
            j = pexe.run(pmain, feed=feed, fetch_list=fetch_p)
        with tfluid.scope_guard(tscope):
            t = texe.run(tmain, feed=feed, fetch_list=fetch_t)
        return [np.asarray(x) for x in j], t

    return pmain, pm, tmain, tm, step


def test_first_step_loss_and_every_gradient_match_jax():
    pmain, pm, tmain, tm, step = _pair(lambda f: f.optimizer.SGD(0.5))
    params = sorted(p.name for p in pmain.all_parameters() if p.trainable)
    assert params == sorted(p.name for p in tmain.all_parameters()
                            if p.trainable)
    assert tmain._param_grad_map == pmain._param_grad_map
    grads = [n + "@GRAD" for n in params]
    j, t = step([pm["loss"]] + grads, [tm["loss"]] + grads, _feed())
    for name, jv, tv in zip(["loss"] + grads, j, t):
        assert tv.shape == jv.shape, name
        np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0, err_msg=name)
    assert len(params) == 83


def test_five_sgd_steps_match_jax():
    _, pm, _, tm, step = _pair(lambda f: f.optimizer.SGD(0.5))
    losses = []
    for i in range(5):
        (jl,), (tl,) = step([pm["loss"]], [tm["loss"]], _feed(seed=i % 2))
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0, err_msg=i)
        losses.append(float(tl))
    assert losses[4] < losses[0]


def test_three_adam_steps_match_jax():
    _, pm, _, tm, step = _pair(lambda f: f.optimizer.Adam(1e-3))
    for i in range(3):
        (jl,), (tl,) = step([pm["loss"]], [tm["loss"]], _feed())
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0, err_msg=i)


def test_amp_first_step_loss_matches_jax():
    _, pm, _, tm, step = _pair(lambda f: f.optimizer.SGD(0.5), amp=True)
    (jl,), (tl,) = step([pm["loss"]], [tm["loss"]], _feed())
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, atol=1e-2, rtol=0)


def test_training_program_structure_matches_jax():
    """build + Adam.minimize: the same op sequence (forward, grad ops,
    sum ops, updates) with the same inferred shapes and dtypes, the same
    persistable names (parameters and Adam's accumulators), in the main
    and the startup program, and the same slot descriptors."""
    make = lambda f: f.optimizer.Adam(1e-3)  # noqa: E731
    pmain, pstart, _, popt = _build("jax", make)
    tmain, tstart, _, topt = _build("torch", make)
    for p, t in ((pmain, tmain), (pstart, tstart)):
        assert _op_signature(t.global_block()) == \
            _op_signature(p.global_block())
        assert _persistables(t) == _persistables(p)
        assert_infer_gaps_within_jax(p, t)
    assert topt.slot_descriptor() == popt.slot_descriptor()


def test_dropout_training_lowers_the_loss_on_a_repeated_batch():
    cfg = {**_CFG, "dropout": 0.1}
    main, startup, model, _ = _build("torch",
                                     lambda f: f.optimizer.Adam(1e-2),
                                     cfg=cfg)
    types = [op.type for op in main.global_block().ops]
    assert types.count("dropout") == 2 + 3 * 2 + 4 * 2
    assert types.count("dropout_grad") == types.count("dropout")
    feed = _feed(cfg=cfg)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        losses = [float(exe.run(main, feed=feed,
                                fetch_list=[model["loss"]])[0])
                  for _ in range(8)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.3, losses


def test_run_steps_equals_successive_runs():
    """run_steps(steps=3) over two feeds equals three run calls: the same
    last loss and the same parameters, dropout streams included."""
    cfg = {**_CFG, "dropout": 0.1}
    main, startup, model, _ = _build("torch",
                                     lambda f: f.optimizer.Adam(1e-2),
                                     cfg=cfg)
    main.random_seed = startup.random_seed = 3
    feeds = [_feed(seed=0, cfg=cfg), _feed(seed=1, cfg=cfg)]
    results = []
    for use_run_steps in (True, False):
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(scope):
            exe.run(startup)
            if use_run_steps:
                (loss,) = exe.run_steps(main, feeds, 3, [model["loss"]])
            else:
                for i in range(3):
                    (loss,) = exe.run(main, feed=feeds[i % 2],
                                      fetch_list=[model["loss"]])
        results.append((loss, {p.name: scope.find_var(p.name).numpy()
                               for p in main.all_parameters()}))
    (l1, p1), (l2, p2) = results
    assert l1 == l2
    for n in p1:
        np.testing.assert_array_equal(p1[n], p2[n], err_msg=n)
    with pytest.raises(ValueError):
        tfluid.Executor(tfluid.CPUPlace()).run_steps(main, [], 1)


def test_adam_state_carries_over_from_jax_by_param_and_kind():
    """Two Adam steps in the JAX package, then the whole scope (weights,
    moments, beta powers, learning rate) moves into a port program whose
    slot names differ: its next step equals the JAX package's third."""
    make = lambda f: f.optimizer.Adam(1e-3)  # noqa: E731
    pmain, pstart, pm, popt = _build("jax", make)
    pscope, pexe = pfluid.Scope(), pfluid.Executor(pfluid.CPUPlace())
    with pfluid.scope_guard(pscope):
        pexe.run(pstart)
        for _ in range(2):
            pexe.run(pmain, feed=_feed(), fetch_list=[pm["loss"]])
    values = {n: np.array(pscope.find_var(n)) for n in pscope.var_names()}
    with pfluid.scope_guard(pscope):
        (j3,) = pexe.run(pmain, feed=_feed(), fetch_list=[pm["loss"]])

    # the second of two builds in one name scope: every slot name differs
    with tunique.guard():
        for _ in range(2):
            main, startup = tfluid.Program(), tfluid.Program()
            with tfluid.program_guard(main, startup):
                model = TT.build(TT.TransformerConfig(**_CFG))
                topt = tfluid.optimizer.Adam(1e-3)
                topt.minimize(model["loss"])
    slots = topt.slot_descriptor()
    assert not set(slots) & set(popt.slot_descriptor())
    state = tio.rekey_optimizer_state(values, popt.slot_descriptor(), slots)
    assert set(slots) <= set(state)
    scope = tio.scope_from_numpy(state, tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        (t3,) = tfluid.Executor(tfluid.CPUPlace()).run(
            main, feed=_feed(), fetch_list=[model["loss"]])
    np.testing.assert_allclose(t3, np.asarray(j3), atol=1e-5, rtol=0)


def test_clip_and_regularization_hooks_reach_the_update():
    """apply_gradients passes the (param, grad) pairs through the installed
    clip and the optimizer's regularization before the update: a clip
    that zeroes every gradient leaves an SGD step's parameters unchanged
    except for the decay term the regularizer adds (p -= lr * p)."""
    from paddle_tpu_torch import clip, layers

    class _ZeroClip:
        def process(self, params_grads):
            return [(p, layers.scale(g, scale=0.0)) for p, g in params_grads]

    def decay(param, grad, block):
        return layers.elementwise_add(grad, param)

    clip.set_gradient_clip(_ZeroClip())
    try:
        main, startup, model, _ = _build(
            "torch", lambda f: f.optimizer.SGD(0.25, regularization=decay))
    finally:
        clip.set_gradient_clip(None)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        exe.run(startup)
        before = {p.name: scope.find_var(p.name).numpy().copy()
                  for p in main.all_parameters() if p.trainable}
        exe.run(main, feed=_feed(), fetch_list=[model["loss"]])
    for name, p0 in before.items():
        np.testing.assert_allclose(scope.find_var(name).numpy(), 0.75 * p0,
                                   rtol=1e-6, atol=0, err_msg=name)
