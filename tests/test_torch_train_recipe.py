"""The port's training recipe against the JAX package's, on the CPU: the
optimizers beyond SGD / Momentum / Adam, the gradient clips and weight
decays, the dynamic loss-scaling state machine of ``amp.decorate``, and
the exponential moving average of the parameters.

Both packages build the same program under ``unique_name.guard()``, so
every variable has the same name in both; the port's scope starts from
the JAX package's startup state (every persistable, carried by name).
Tolerances:

- optimizers, clips and decays (a two-layer ``fc`` net, f32, 3 steps):
  the loss of each step and every persistable (parameters and
  accumulators) after them within 1e-6 of the JAX value, relative to the
  variable's largest |element| (the frameworks sum in different orders);
- the loss-scaling state machine: the scale, its two counters and the
  skip count equal the JAX package's exactly, step for step (sums and
  products of powers of two); parameters bit-unchanged on an overflow
  step;
- a Transformer (2 layers, d_model 32, dropout 0) trained 3 steps with
  ``decorate`` (dynamic loss scaling), a global-norm clip and AdamW:
  losses within 1e-5. ``decorate`` marks the program for bf16; the
  parity run turns bf16 off again in both packages (``disable_amp``), so
  the recipe's arithmetic is compared in f32;
- EMA: the shadows, and the losses of steps run under ``apply`` and
  after ``restore``, within 1e-6 relative.
"""

import types

import numpy as np
import pytest

import paddle_tpu as pfluid
from paddle_tpu import amp as pamp
from paddle_tpu import clip as pclip
from paddle_tpu import regularizer as preg
from paddle_tpu import unique_name as punique
from paddle_tpu.models import transformer as PT

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import clip as tclip
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch import unique_name as tunique
from paddle_tpu_torch.models import transformer as TT

_PKGS = {
    "jax": types.SimpleNamespace(fluid=pfluid, amp=pamp, clip=pclip,
                                 reg=preg, unique=punique, T=PT),
    "torch": types.SimpleNamespace(fluid=tfluid, amp=tamp, clip=tclip,
                                   reg=treg, unique=tunique, T=TT),
}

_X = np.random.RandomState(0).randn(8, 6).astype(np.float32)
_Y = np.random.RandomState(1).randint(0, 3, (8, 1)).astype(np.int64)
_FEED = {"x": _X, "y": _Y}


def _rel_err(got, want):
    """max |got - want| over max |want|, over the finite elements; inf
    where the two differ in which elements are NaN or infinite."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    if not np.array_equal(fin, np.isfinite(got)) or not np.array_equal(
            got[~fin], want[~fin], equal_nan=True):
        return np.inf
    if not fin.any():
        return 0.0
    diff = np.abs(got[fin] - want[fin]).max()
    return float(diff / max(np.abs(want[fin]).max(), 1e-30))


def _fc_net(m, param_reg=None):
    """Two fc layers over x [6] and a softmax cross-entropy loss."""
    layers = m.fluid.layers
    x = layers.data("x", shape=[6], dtype="float32")
    y = layers.data("y", shape=[1], dtype="int64")
    h = layers.fc(x, 8, act="relu",
                  param_attr=m.fluid.ParamAttr(regularizer=param_reg))
    logits = layers.fc(h, 3)
    return layers.mean(layers.softmax_with_cross_entropy(logits, y))


def _build(pkg, make_opt, net=_fc_net, clip=None, param_list=None,
           param_reg=None, ema=False):
    """``pkg``'s program: ``net(m)``'s loss minimized by ``make_opt(m)``,
    through the clip ``clip(m)`` (scoped to ``param_list``) installed
    while it is built; with ``ema``, an ExponentialMovingAverage(0.9)."""
    m = _PKGS[pkg]
    fluid = m.fluid
    main, startup = fluid.Program(), fluid.Program()
    b = types.SimpleNamespace(main=main, startup=startup, clip=None,
                              ema=None)
    with m.unique.guard(), fluid.program_guard(main, startup):
        b.loss = net(m, param_reg=param_reg and param_reg(m))
        if clip is not None:
            b.clip = clip(m)
            m.clip.set_gradient_clip(b.clip, param_list=param_list)
        try:
            b.opt = make_opt(m)
            b.opt.minimize(b.loss)
        finally:
            m.clip.set_gradient_clip(None)
        if ema:
            b.ema = fluid.optimizer.ExponentialMovingAverage(0.9)
            b.ema.update()
    return b


class _Pair:
    """One program built in both packages; the port's scope holds the
    JAX package's startup state, every persistable by name."""

    def __init__(self, f32=False, **kw):
        """``f32``: unmark the programs for bf16 (``decorate`` marks
        them)."""
        self.j, self.t = _build("jax", **kw), _build("torch", **kw)
        if f32:
            for pkg, b in (("jax", self.j), ("torch", self.t)):
                _PKGS[pkg].amp.disable_amp(b.main)
        self.names = sorted(v.name for v in self.j.main.list_vars()
                            if v.persistable)
        assert sorted(v.name for v in self.t.main.list_vars()
                      if v.persistable) == self.names
        self.pscope, self.tscope = pfluid.Scope(), tfluid.Scope()
        self.pexe = pfluid.Executor(pfluid.CPUPlace())
        self.texe = tfluid.Executor(tfluid.CPUPlace())
        with pfluid.scope_guard(self.pscope):
            self.pexe.run(self.j.startup)
        with tfluid.scope_guard(self.tscope):
            self.texe.run(self.t.startup)
        for n in self.names:
            self.tscope.set(n, np.array(self.pscope.find_var(n)))

    def step(self, feed, fetch=()):
        """One step in each package: (JAX fetches, port fetches), the
        loss first."""
        with pfluid.scope_guard(self.pscope):
            j = self.pexe.run(self.j.main, feed=feed,
                              fetch_list=[self.j.loss, *fetch])
        with tfluid.scope_guard(self.tscope):
            t = self.texe.run(self.t.main, feed=feed,
                              fetch_list=[self.t.loss, *fetch])
        return [np.asarray(a) for a in j], list(t)

    def value(self, name):
        """(JAX value, port value) of a scope var, as numpy copies."""
        return (np.array(self.pscope.find_var(name)),
                np.array(self.tscope.find_var(name)))


# --- the optimizers ---------------------------------------------------------

# the nine optimizers the port adds (RMSProp also centered)
_OPTIMIZERS = {
    "LarsMomentum": lambda m: m.fluid.optimizer.LarsMomentum(
        0.1, momentum=0.9, lars_coeff=0.01, lars_weight_decay=0.001),
    "AdamW": lambda m: m.fluid.optimizer.AdamW(0.01, weight_decay=0.05),
    "Lamb": lambda m: m.fluid.optimizer.Lamb(0.01, lamb_weight_decay=0.02),
    "Adagrad": lambda m: m.fluid.optimizer.Adagrad(
        0.1, initial_accumulator_value=0.1),
    "DecayedAdagrad": lambda m: m.fluid.optimizer.DecayedAdagrad(0.1),
    "RMSProp": lambda m: m.fluid.optimizer.RMSProp(0.01, momentum=0.9),
    "RMSProp centered": lambda m: m.fluid.optimizer.RMSProp(
        0.01, momentum=0.9, centered=True),
    "Ftrl": lambda m: m.fluid.optimizer.Ftrl(0.1, l1=0.01, l2=0.01),
    "Adamax": lambda m: m.fluid.optimizer.Adamax(0.01),
    "Adadelta": lambda m: m.fluid.optimizer.Adadelta(1.0),
}


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_optimizer_three_steps_match_jax(name):
    """3 steps: each step's loss, and every parameter and accumulator
    after them, within 1e-6 relative, in the JAX dtype and shape; the
    accumulators carry the JAX package's names and kinds
    (slot_descriptor), and every one of them moved off its fill.

    Lamb, one step: the JAX op bias-corrects with the beta powers of
    before the step, whose accumulators start at 1 (Adam's), so its first
    step divides by 1 - 1 = 0 and sets every parameter to NaN; the port
    does the same arithmetic (the NaNs must sit where the JAX package's
    do). Later steps would compare how each framework's ReLU derivative
    treats a NaN input, which differs."""
    pair = _Pair(make_opt=_OPTIMIZERS[name])
    slots = pair.t.opt.slot_descriptor()
    assert slots == pair.j.opt.slot_descriptor()
    start = {n: pair.value(n)[1] for n in pair.names}
    for i in range(1 if name == "Lamb" else 3):
        (jl,), (tl,) = pair.step(_FEED)
        assert _rel_err(tl, jl) <= 1e-6, (i, tl, jl)
    for n in pair.names:
        j, t = pair.value(n)
        assert t.dtype == j.dtype and t.shape == j.shape, n
        assert _rel_err(t, j) <= 1e-6, (n, _rel_err(t, j))
    still = [n for n, d in slots.items() if d["slot"] != "learning_rate"
             and np.array_equal(pair.value(n)[1], start[n])]
    assert not still, still


# --- the clips and decays ---------------------------------------------------

_MOMENTUM = lambda m: m.fluid.optimizer.Momentum(  # noqa: E731
    0.5, momentum=0.9)

_CLIPS = {
    "by value": dict(clip=lambda m: m.clip.GradientClipByValue(0.01)),
    "by norm, triggered": dict(
        clip=lambda m: m.clip.GradientClipByNorm(0.01)),
    "by norm, not triggered": dict(
        clip=lambda m: m.clip.GradientClipByNorm(100.0)),
    "by global norm, triggered": dict(
        clip=lambda m: m.clip.GradientClipByGlobalNorm(0.01)),
    "by global norm, not triggered": dict(
        clip=lambda m: m.clip.GradientClipByGlobalNorm(100.0)),
    "by global norm, one parameter": dict(
        clip=lambda m: m.clip.GradientClipByGlobalNorm(0.01),
        param_list=["fc_0.w_0"]),
    "L1Decay, the optimizer's": dict(
        make_opt=lambda m: m.fluid.optimizer.Momentum(
            0.5, momentum=0.9, regularization=m.reg.L1Decay(0.1))),
    "L2Decay, a parameter's": dict(param_reg=lambda m: m.reg.L2Decay(0.1)),
}


# the parameters whose first step a clip or decay changes
_CHANGED = {"by norm, not triggered": set(),
            "by global norm, not triggered": set(),
            "by global norm, one parameter": {"fc_0.w_0"},
            "L2Decay, a parameter's": {"fc_0.w_0"},
            # the biases start at 0, whose sign is 0
            "L1Decay, the optimizer's": {"fc_0.w_0", "fc_1.w_0"}}


@pytest.mark.parametrize("case", sorted(_CLIPS))
def test_clip_and_decay_match_jax(case):
    """Momentum through a clip or a decay, 3 steps: each loss, the
    global norm clip's norm and scale vars, and every persistable within
    1e-6 relative. Against the same first step with neither, a clip that
    is not triggered changes no parameter, one scoped to fc_0.w_0 (and
    fc_0.w_0's own L2Decay) changes that parameter alone, L1Decay the
    weights, and the others all four parameters."""
    kw = {"make_opt": _MOMENTUM, **_CLIPS[case]}
    pair, plain = _Pair(**kw), _Pair(make_opt=_MOMENTUM)
    fetch = ([pair.t.clip.global_norm_name, pair.t.clip.scale_name]
             if "global" in case else [])
    if fetch:
        assert fetch == [pair.j.clip.global_norm_name,
                         pair.j.clip.scale_name]
    params = [p.name for p in pair.t.main.all_parameters()]
    for i in range(3):
        j, t = pair.step(_FEED, fetch)
        for jv, tv in zip(j, t):
            assert _rel_err(tv, jv) <= 1e-6, (i, tv, jv)
        if i == 0:
            plain.step(_FEED)
            changed = {n for n in params if not np.array_equal(
                pair.value(n)[1], plain.value(n)[1])}
            assert changed == _CHANGED.get(case, set(params)), changed
            if fetch:
                assert (t[2][0] < 1.0) == ("not triggered" not in case)
    for n in pair.names:
        jv, tv = pair.value(n)
        assert _rel_err(tv, jv) <= 1e-6, (n, _rel_err(tv, jv))


# --- the dynamic loss-scaling state machine ---------------------------------


def _scaler_net(m, param_reg=None):
    """tests/test_amp.py's net: one fc of x [4] onto 2, no bias."""
    layers = m.fluid.layers
    x = layers.data("x", shape=[4], dtype="float32")
    return layers.mean(layers.fc(x, 2, bias_attr=False))


def _scaler_pair(init_scale, incr_every_n=1000, decr_every_n=1):
    return _Pair(net=_scaler_net, make_opt=lambda m: m.amp.decorate(
        m.fluid.optimizer.SGD(0.1), init_loss_scaling=init_scale,
        use_dynamic_loss_scaling=True, incr_every_n_steps=incr_every_n,
        decr_every_n_nan_or_inf=decr_every_n))


_OK = {"x": np.ones((2, 4), np.float32)}
# scaled by >= 1e30 the fc gradients overflow f32
_HUGE = {"x": np.full((2, 4), 1e10, np.float32)}
# small activations keep the scaled loss and gradients finite at 1e38
_TINY = {"x": np.full((2, 4), 1e-3, np.float32)}


def _drive(pair, feeds):
    """Run ``feeds`` in both packages; after each step the port's
    (scale, good count, bad count, skip count), asserted equal to the JAX
    package's exactly, the port's parameter, and the loss."""
    opt = pair.t.opt
    assert (opt.loss_scaling_name, opt.skip_count_name) == (
        pair.j.opt.loss_scaling_name, pair.j.opt.skip_count_name)
    assert pair.t.main._amp_scale_vars == pair.j.main._amp_scale_vars
    scale, good, bad, _ = pair.t.main._amp_scale_vars
    w = pair.t.main.all_parameters()[0].name
    out = []
    for feed in feeds:
        (jl,), (tl,) = pair.step(feed)
        state = []
        for n in (scale, good, bad, opt.skip_count_name):
            jv, tv = pair.value(n)
            assert tv.dtype == np.float32 and np.array_equal(tv, jv), (
                n, tv, jv)
            state.append(float(tv[0]))
        out.append((tuple(state), pair.value(w)[1], float(tl)))
    return out


def test_loss_scale_grows_after_n_good_steps():
    steps = _drive(_scaler_pair(4.0, incr_every_n=2), [_OK] * 5)
    # 2x on every 2nd clean step; the counter resets after each growth
    assert [s[0][0] for s in steps] == [4.0, 8.0, 8.0, 16.0, 16.0]
    assert [s[0][1] for s in steps] == [1.0, 0.0, 1.0, 0.0, 1.0]


def test_overflow_skips_update_and_shrinks_scale():
    pair = _scaler_pair(1e30)
    w = pair.t.main.all_parameters()[0].name
    before = pair.value(w)[1]
    (skip, w1, loss), (clean, w2, _) = _drive(pair, [_HUGE, _OK])
    # parameters bit-unchanged on the overflow step, the (unscaled) loss
    # finite; the next finite step updates them
    np.testing.assert_array_equal(w1, before)
    assert np.isfinite(loss)
    assert skip[0] == np.float32(5e29) and skip[3] == 1.0
    assert not np.array_equal(w2, w1) and clean[3] == 1.0


def test_overflow_resets_growth_counter():
    steps = _drive(_scaler_pair(1e30, incr_every_n=2),
                   [_OK, _HUGE, _OK, _OK])
    scales = [np.float32(s[0][0]) for s in steps]
    assert scales[:3] == [np.float32(1e30), np.float32(5e29),
                          np.float32(5e29)]
    assert scales[3] == scales[2] * 2
    assert [s[0][1] for s in steps] == [1.0, 0.0, 1.0, 0.0]


def test_decr_every_n_requires_consecutive_overflows():
    steps = _drive(_scaler_pair(1e30, decr_every_n=2), [_HUGE, _HUGE])
    assert steps[0][0][0] == np.float32(1e30)  # not yet
    assert steps[1][0][0] == np.float32(5e29)
    assert [s[0][3] for s in steps] == [1.0, 2.0]


def test_scale_growth_guarded_against_f32_overflow():
    """A scale whose next doubling would overflow f32 stays put, and
    training still updates the parameters at the clamped scale."""
    steps = _drive(_scaler_pair(1e38, incr_every_n=1), [_TINY] * 5)
    assert steps[3][0][0] == steps[4][0][0] == np.float32(2e38)
    assert np.isfinite(steps[4][0][0])
    assert not np.array_equal(steps[3][1], steps[4][1])


def test_dynamic_decorate_rejects_split_apply_gradients():
    opt = tamp.decorate(tfluid.optimizer.SGD(0.1),
                        use_dynamic_loss_scaling=True)
    with pytest.raises(RuntimeError, match="minimize"):
        opt.apply_gradients([])


# --- the recipe on a Transformer --------------------------------------------

_CFG = dict(src_vocab_size=37, trg_vocab_size=41, max_length=64, d_model=32,
            d_inner=64, n_head=2, n_layer=2, dropout=0.0,
            label_smooth_eps=0.1)


def _transformer(m, param_reg=None):
    return m.T.build(m.T.TransformerConfig(**_CFG))["loss"]


def test_transformer_recipe_three_steps_match_jax():
    """decorate(AdamW, dynamic loss scaling, growth every 2 steps) with a
    global-norm clip of 1.0 on a 2-layer Transformer: the same program
    (op types in order, persistable names), losses within 1e-5, and the
    scale (doubled at step 2) and the clip's norm the JAX package's."""
    pair = _Pair(net=_transformer, f32=True, make_opt=lambda m:
                 m.amp.decorate(m.fluid.optimizer.AdamW(
                     1e-3, weight_decay=0.01), init_loss_scaling=2.0 ** 15,
                     use_dynamic_loss_scaling=True, incr_every_n_steps=2),
                 clip=lambda m: m.clip.GradientClipByGlobalNorm(1.0))
    assert [op.type for op in pair.t.main.global_block().ops] == [
        op.type for op in pair.j.main.global_block().ops]
    feed = PT.make_batch(PT.TransformerConfig(**_CFG), 3, 10, 7, seed=2)
    norm = [pair.t.clip.global_norm_name]
    for i in range(3):
        (jl, jn), (tl, tn) = pair.step(feed, norm)
        assert abs(float(tl) - float(jl)) <= 1e-5, (i, tl, jl)
        assert _rel_err(tn, jn) <= 1e-5, (i, tn, jn)
    assert float(tn[0]) > 1.0  # the clip scaled the gradients down
    jv, tv = pair.value(pair.t.opt.loss_scaling_name)
    assert float(tv[0]) == float(jv[0]) == 2.0 ** 16


# --- the exponential moving average -----------------------------------------


def test_ema_update_apply_restore_match_jax():
    """SGD with an EMA(0.9) of the parameters, 3 steps: the shadows and
    the step count within 1e-6 relative; a step under ``apply`` computes
    its loss from the debiased shadows, and one after ``restore`` from
    the parameters as they were, in both packages (losses within 1e-6
    relative; the port's later steps replay its step with the values set
    in the Scope copied in first)."""
    pair = _Pair(make_opt=lambda m: m.fluid.optimizer.SGD(0.5), ema=True)
    for _ in range(3):
        pair.step(_FEED)
    shadows = [s.name for _, s in pair.t.ema._shadows]
    assert shadows == [s.name for _, s in pair.j.ema._shadows]
    assert len(shadows) == 4
    for n in shadows + [pair.t.ema._step_var.name]:
        jv, tv = pair.value(n)
        assert _rel_err(tv, jv) <= 1e-6, n
    w = pair.t.main.all_parameters()[0].name
    live = pair.value(w)[1]
    with pfluid.scope_guard(pair.pscope), \
            tfluid.scope_guard(pair.tscope):
        pguard = pair.j.ema.apply()
        tguard = pair.t.ema.apply()
        jv, tv = pair.value(w)
        assert _rel_err(tv, jv) <= 1e-6
        assert not np.array_equal(tv, live)
        (jl,), (tl,) = pair.step(_FEED)
        assert _rel_err(tl, jl) <= 1e-6
        with pguard, tguard:
            pass  # leaving the guards restores
    np.testing.assert_array_equal(pair.value(w)[1], live)
    (jl,), (tl,) = pair.step(_FEED)
    assert _rel_err(tl, jl) <= 1e-6
