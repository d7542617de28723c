"""The port's structured control flow against the JAX package on the CPU:
the ``scan``, ``cond`` (with its registered ``cond_grad``) and
``bounded_while`` ops, the layers built on them (``StaticRNN``,
``DynamicRNN``, ``IfElse``, ``Switch``, ``cond``, ``While(max_trip_count=
...)``, the dense arrays, ``Print``), ``py_func``, and
``transformer.build_scan``.

- Programs built alike in both packages (under ``unique_name.guard()``,
  the JAX package's startup state carried across by name) give the same
  fetches and gradients: f32 within 1e-5 of the largest |JAX value|
  (forward) and 1e-4 (gradients, Adam / SGD states), integers and bools
  exactly.
- ``cond`` at a non-finite untaken branch: ``cond(False, log(x), x)`` at
  x = 0 has the finite gradient JAX gives, where the derived grad of the
  port's select would give NaN.
- The kernels' outputs are opaque to autograd on the card. With the
  attention and dropout kernels' wrappers patched to return detached
  tensors (how they look to autograd there), a derived grad through a
  ``scan`` whose body holds attention and dropout still equals the
  unpatched gradient, bit for bit.
- A scan body's dropout draws a new mask each step, the same masks again
  on a fresh executor, eagerly and through the step runner, and the
  derived grad replays them.
- A block holding ``print`` or ``py_func`` (at any depth) is not
  captured; the executor counts its steps as uncaptured and prints every
  step.
- ``build_scan`` equals ``build()`` on stacked weights, and the JAX
  package's ``build_scan`` over Adam steps."""

import numpy as np
import pytest
import torch
from torch_model_parity import rel, train_both

import paddle_tpu as pfluid
from paddle_tpu.core.registry import get_op_def as jax_op_def
from paddle_tpu.models import transformer as JT

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import autodiff, lowering
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.parallel import flash_attention as fa

TOL_FWD, TOL_GRAD = 1e-5, 1e-4
CPU = tfluid.CPUPlace()

# the op types this slice adds (tests/test_torch_ops.py counts them among
# the registered ones); cond_grad is the port's registered grad of cond
CONTROL_OP_TYPES = ["bounded_while", "cond", "scan",
                    "fill_constant_batch_size_like"]
MISC_OP_TYPES = ["hash", "print", "py_func", "tree_conv"]


def _same(steps_j, steps_t, tol=TOL_FWD):
    for sj, st in zip(steps_j, steps_t):
        assert len(sj) == len(st)
        for j, t in zip(sj, st):
            j, t = np.asarray(j), np.asarray(t)
            assert j.shape == t.shape, (j.shape, t.shape)
            if np.issubdtype(j.dtype, np.floating):
                assert rel(t, j) <= tol, rel(t, j)
            else:
                np.testing.assert_array_equal(t, j)


def _both(model_fn, feeds, names, opt_fn=None, tol=TOL_FWD):
    """``model_fn(fluid)`` run in both packages on ``feeds`` (one step a
    feed) from the JAX package's startup state; ``names(model)`` the
    fetches. Returns the port's steps."""
    j, t, _, _, _ = train_both(model_fn, opt_fn, feeds, names)
    _same(j, t, tol)
    return t


# --- cond --------------------------------------------------------------------


def _cond_model(fluid):
    L = fluid.layers
    blk = fluid.default_main_program().global_block()
    x = blk.create_var(name="x", shape=(3,), dtype="float32",
                       stop_gradient=False)
    flag = blk.create_var(name="flag", shape=(1,), dtype="bool")
    out = L.cond(flag, lambda: L.scale(x, scale=3.0),
                 lambda: L.elementwise_mul(x, x))
    loss = L.reduce_sum(out)
    return {"out": out, "dx": fluid.gradients(loss, x)[0]}


@pytest.mark.parametrize("flag", [True, False])
def test_cond_selects_and_differentiates(flag):
    xv = np.array([1.0, -2.0, 3.0], np.float32)
    (out, dx), = _both(_cond_model, [{"x": xv, "flag": np.array([flag])}],
                       lambda m: [m["out"], m["dx"]])
    np.testing.assert_allclose(out, xv * 3.0 if flag else xv * xv)
    np.testing.assert_allclose(dx, np.full(3, 3.0) if flag else 2 * xv)


def _log_or_identity(fluid):
    L = fluid.layers
    blk = fluid.default_main_program().global_block()
    x = blk.create_var(name="x", shape=(3,), dtype="float32",
                       stop_gradient=False)
    flag = blk.create_var(name="flag", shape=(1,), dtype="bool")
    out = L.cond(flag, lambda: L.log(x), lambda: L.scale(x, scale=1.0))
    return {"out": out, "dx": fluid.gradients(L.reduce_sum(out), x)[0]}


def test_cond_untaken_non_finite_branch_has_a_finite_gradient():
    """cond(False, log(x), x) at x = 0: JAX's gradient (ones), finite; the
    derived grad of the forward's select would leak 0 * inf = NaN out of
    the untaken branch, which is why cond_grad is registered."""
    xv = np.array([0.0, 1.0, 2.0], np.float32)
    (out, dx), = _both(_log_or_identity,
                       [{"x": xv, "flag": np.array([False])}],
                       lambda m: [m["out"], m["dx"]])
    np.testing.assert_array_equal(dx, np.ones(3, np.float32))
    # the same op through the derived grad (the select's vjp)
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        _log_or_identity(tfluid)
    op = next(o for o in main.global_block().ops if o.type == "cond")
    x = torch.tensor(xv)
    ins = {"Cond": [torch.tensor([False])], "Captured": [x]}
    attrs = dict(op.attrs, fwd_input_slots=["Cond", "Captured"],
                 fwd_output_slots=["Out"])
    outs = get_op_def("cond").compute(ins, dict(op.attrs),
                                      torch.device("cpu"))
    g_ins = dict(ins, Out=outs["Out"], **{"GRAD::Out": [torch.ones(3)]})
    derived = autodiff.make_grad_compute(get_op_def("cond"))(
        g_ins, attrs, torch.device("cpu"))["GRAD::Captured"][0]
    assert torch.isnan(derived).any(), derived
    registered = get_op_def("cond_grad").compute(
        g_ins, attrs, torch.device("cpu"))["GRAD::Captured"][0]
    np.testing.assert_array_equal(registered.numpy(), dx)


def test_cond_branch_arity_mismatch_raises():
    main = tfluid.Program()
    L = tfluid.layers
    with tfluid.program_guard(main, tfluid.Program()):
        flag = main.global_block().create_var(name="flag", shape=(1,),
                                              dtype="bool")
        x = L.fill_constant(shape=[2], dtype="float32", value=1.0)
        with pytest.raises(ValueError, match="arit"):
            L.cond(flag, lambda: [x, x], lambda: x)


# --- StaticRNN / scan --------------------------------------------------------

B, T, D = 2, 5, 3


def _static_rnn(fluid, batch_ref=False):
    L = fluid.layers
    blk = fluid.default_main_program().global_block()
    x = blk.create_var(name="x", shape=(B, T, D), dtype="float32",
                       stop_gradient=False)
    w = L.create_parameter([D, D], "float32", name="rnn_w")
    c0 = L.scale(L.reduce_sum(x, dim=1), 0.1)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        if batch_ref:
            h_prev = rnn.memory(shape=[D], batch_ref=x, init_value=0.5,
                                ref_batch_dim_idx=0)
        else:
            h_prev = rnn.memory(shape=(B, D), init_value=0.0)
        c_prev = rnn.memory(init=c0)
        h = L.tanh(L.matmul(L.elementwise_add(x_t, h_prev), w))
        c = L.elementwise_add(c_prev, h)
        rnn.update_memory(h_prev, h)
        rnn.update_memory(c_prev, c)
        rnn.step_output(h)
        rnn.step_output(c)
    out, cs = rnn()
    loss = L.reduce_sum(L.elementwise_add(out, L.square(cs)))
    dx, dw = fluid.gradients(loss, [x, w])
    return {"out": out, "cs": cs, "finals": rnn.final_states, "dx": dx,
            "dw": dw}


@pytest.mark.parametrize("batch_ref", [False, True])
def test_static_rnn_outputs_and_gradients_equal_jax(batch_ref):
    xv = np.random.RandomState(0).randn(B, T, D).astype(np.float32)
    (out, cs, f0, f1, dx, dw), = _both(
        lambda fluid: _static_rnn(fluid, batch_ref), [{"x": xv}],
        lambda m: [m["out"], m["cs"], *m["finals"], m["dx"], m["dw"]],
        tol=TOL_GRAD)
    assert out.shape == (B, T, D) and np.abs(dw).sum() > 0
    np.testing.assert_array_equal(out[:, -1], f0)


def _scan_regression(fluid):
    L = fluid.layers
    blk = fluid.default_main_program().global_block()
    x = blk.create_var(name="x", shape=(4, 6, 8), dtype="float32",
                       stop_gradient=True)
    y = blk.create_var(name="y", shape=(4, 1), dtype="float32",
                       stop_gradient=True)
    w = L.create_parameter([8, 8], "float32", name="srnn_w")
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(shape=(4, 8), init_value=0.0)
        h = L.tanh(L.elementwise_add(L.matmul(x_t, w), h_prev))
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    pred = L.fc(L.reduce_mean(rnn(), dim=1), size=1)
    return {"loss": L.reduce_mean(L.square(L.elementwise_sub(pred, y)))}


def test_scan_trains_with_sgd_as_jax():
    r = np.random.RandomState(2)
    xv = r.randn(4, 6, 8).astype(np.float32)
    feed = {"x": xv, "y": xv.sum(axis=(1, 2)).reshape(4, 1) * 0.1}
    steps = _both(_scan_regression, [feed] * 6,
                  lambda m: [m["loss"], "srnn_w@GRAD"],
                  opt_fn=lambda fluid: fluid.optimizer.SGD(0.1),
                  tol=TOL_GRAD)
    losses = [float(s[0]) for s in steps]
    assert losses[-1] < losses[0], losses


# --- DynamicRNN, IfElse, Switch, arrays ------------------------------------


def _drnn(fluid):
    L = fluid.layers
    x = L.data("x", shape=[5, 3], dtype="float32")
    x.stop_gradient = False
    length = L.data("length", shape=[1], dtype="int64")
    drnn = L.DynamicRNN()
    with drnn.block():
        xt = drnn.step_input(x, length=length)
        acc = drnn.memory(shape=[3])
        new = L.fc([xt, acc], 3, act="tanh")
        drnn.update_memory(acc, new)
        drnn.output(new)
    out = drnn()
    last = L.sequence_pool(out, "last", length=length)
    return {"out": out, "last": last,
            "dx": fluid.gradients(L.reduce_sum(last), x)[0]}


def test_dynamic_rnn_masks_and_freezes_as_jax():
    r = np.random.RandomState(3)
    feed = {"x": r.randn(3, 5, 3).astype(np.float32),
            "length": np.array([[2], [5], [0]], np.int64)}
    (out, last, dx), = _both(_drnn, [feed],
                             lambda m: [m["out"], m["last"], m["dx"]],
                             tol=TOL_GRAD)
    assert (out[0, 2:] == 0).all() and (out[2] == 0).all()
    np.testing.assert_array_equal(last[0], out[0, 1])
    assert (dx[0, 2:] == 0).all() and (dx[0, :2] != 0).any()


def _ifelse(fluid):
    L = fluid.layers
    x = L.data("x", shape=[4], dtype="float32")
    x.stop_gradient = False
    limit = L.data("limit", shape=[1], dtype="float32")
    cond = L.less_than(L.reduce_sum(x, dim=1, keep_dim=True), limit)
    ie = L.IfElse(cond)
    with ie.true_block():
        ie.output(L.fc(ie.input(x), 2, act="relu"))
    with ie.false_block():
        ie.output(L.scale(L.fc(ie.input(x), 2), -1.0))
    out = ie()
    return {"out": out, "dx": fluid.gradients(L.reduce_sum(out), x)[0]}


def test_if_else_merges_rows_as_jax():
    feed = {"x": np.array([[1, 1, 1, 1], [9, 9, 9, 9], [-1, 2, 0, 1]],
                          np.float32),
            "limit": np.full((3, 1), 10.0, np.float32)}
    _both(_ifelse, [feed], lambda m: [m["out"], m["dx"]], tol=TOL_GRAD)


def _switch(fluid):
    L = fluid.layers
    step = L.data("step", shape=[1], dtype="float32",
                  append_batch_size=False)
    lr = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    b1 = L.fill_constant(shape=[1], dtype="float32", value=10.0)
    b2 = L.fill_constant(shape=[1], dtype="float32", value=20.0)
    with L.Switch() as sw:
        with sw.case(L.less_than(step, b1)):
            L.assign(L.scale(step, scale=0.01), output=lr)
        with sw.case(L.less_than(step, b2)):
            L.assign(L.fill_constant(shape=[1], dtype="float32",
                                     value=0.1), output=lr)
        with sw.default():
            L.assign(L.fill_constant(shape=[1], dtype="float32",
                                     value=0.01), output=lr)
    return {"lr": lr}


def test_switch_lr_warmup_as_jax():
    steps = _both(_switch, [{"step": np.array([v], np.float32)}
                            for v in (3.0, 15.0, 30.0)],
                  lambda m: [m["lr"]])
    np.testing.assert_allclose([float(s[0][0]) for s in steps],
                               [0.03, 0.1, 0.01], rtol=1e-6)


def _arrays(fluid):
    L = fluid.layers
    x = L.fill_constant(shape=[3], dtype="float32", value=5.0)
    arr = L.array_fill(4, x, value=0.0)
    idx = L.fill_constant(shape=[1], dtype="int32", value=2)
    arr2 = L.array_write_step(arr, idx, x)
    a3 = L.create_array("float32", 3, template=x, value=1.0)
    i1 = L.fill_constant(shape=[1], dtype="int64", value=1)
    a3 = L.array_write(L.scale(x, scale=2.0), i1, a3)
    return {"arr": arr2, "a3": a3, "read": L.array_read(a3, i1)}


def test_dense_arrays_as_jax():
    (arr, a3, read), = _both(_arrays, [{}],
                             lambda m: [m["arr"], m["a3"], m["read"]])
    assert arr[2].tolist() == [5.0] * 3 and read.tolist() == [10.0] * 3


# --- bounded_while -----------------------------------------------------------


def _bounded(fluid, lim_v=3, bound=5):
    L = fluid.layers
    x = L.data("x", shape=[4], dtype="float32")
    acc = L.fc(x, 4, bias_attr=False, param_attr=fluid.ParamAttr(
        name="w", initializer=fluid.initializer.ConstantInitializer(0.5)))
    i = L.fill_constant([1], "int64", 0)
    lim = L.fill_constant([1], "int64", lim_v)
    cond = L.less_than(i, lim)
    w = L.While(cond, max_trip_count=bound)
    with w.block():
        L.assign(L.tanh(L.fc(acc, 4, bias_attr=False,
                             param_attr=fluid.ParamAttr(name="w2"))),
                 output=acc)
        L.increment(i)
        L.less_than(i, lim, cond=cond)
    return {"loss": L.mean(acc), "acc": acc, "steps": w._steps_var,
            "cond": cond}


@pytest.mark.parametrize("lim_v", [3, 7])
def test_bounded_while_trains_and_truncates_as_jax(lim_v):
    """A trip count under the bound (3 live steps of 5) and a truncated
    loop (7 wanted, 5 run: CondOut still true), SGD through the loop."""
    r = np.random.RandomState(4)
    feeds = [{"x": r.randn(2, 4).astype(np.float32)} for _ in range(3)]
    steps = _both(lambda fluid: _bounded(fluid, lim_v),
                  feeds, lambda m: [m["loss"], m["steps"], m["cond"],
                                    "w2@GRAD", "w@GRAD"],
                  opt_fn=lambda fluid: fluid.optimizer.SGD(0.5),
                  tol=TOL_GRAD)
    assert int(steps[0][1]) == min(lim_v, 5)
    assert bool(np.asarray(steps[0][2]).reshape(-1)[0]) == (lim_v > 5)
    assert np.abs(steps[0][4]).sum() > 0


def test_bounded_while_grad_reruns_from_the_final_carries_as_jax():
    """A known reference behaviour, kept: the While layer writes the
    carries and the condition in place (X and Out share names), so the
    derived bounded_while_grad re-runs the loop from the FINAL carries
    and condition. Here the condition is false by then, every re-run
    iteration is dead, and the weight read inside the loop gets a zero
    gradient in both packages, where a central difference is not zero."""
    xv = np.random.RandomState(4).randn(2, 4).astype(np.float32)
    (loss, dw2), = _both(lambda fluid: _bounded(fluid, 3), [{"x": xv}],
                         lambda m: [m["loss"], "w2@GRAD"],
                         opt_fn=lambda fluid: fluid.optimizer.SGD(0.0))
    assert not np.abs(dw2).any()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        m = _bounded(tfluid, 3)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        w2 = scope.find_var("w2").clone()
        losses = []
        for eps in (1e-2, -1e-2):
            w = w2.clone()
            w[0, 0] += eps
            scope.set("w2", w)
            losses.append(float(exe.run(main, feed={"x": xv},
                                        fetch_list=[m["loss"]])[0]))
    assert abs(losses[0] - losses[1]) / 2e-2 > 1e-3, losses


# --- dropout in a scan body: seeds -------------------------------------------


def _drop_scan(fluid):
    L = fluid.layers
    blk = fluid.default_main_program().global_block()
    x = blk.create_var(name="x", shape=(4, 6, 32), dtype="float32",
                       stop_gradient=False)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        rnn.step_output(L.dropout(x_t, 0.5, dropout_implementation=
                                  "upscale_in_train"))
    out = rnn()
    dx = fluid.gradients(L.reduce_sum(out), x)[0]
    return {"out": out, "dx": dx}


def test_scan_dropout_draws_each_step_and_the_grad_replays():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        m = _drop_scan(tfluid)
    main.random_seed = 7
    feed = {"x": np.ones((4, 6, 32), np.float32)}
    runs = []
    for cached in (False, True, True):
        exe = tfluid.Executor(CPU)
        with tfluid.scope_guard(tfluid.Scope()):
            runs.append([exe.run(main, feed=feed, fetch_list=[m["out"],
                                                              m["dx"]],
                                 use_program_cache=cached)
                         for _ in range(2)])
    out, dx = runs[0][0]
    keep = out != 0
    # each step's mask is its own; the grad op replays the forward's
    assert not all(np.array_equal(keep[:, 0], keep[:, s]) for s in range(6))
    np.testing.assert_array_equal(dx, keep * np.float32(2.0))
    assert abs(keep.mean() - 0.5) < 0.1
    # a new executor step draws anew; a fresh executor, eager or through
    # the step runner, replays the same steps' masks
    assert not np.array_equal(runs[0][0][0], runs[0][1][0])
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)


# --- the kernels' wrappers opaque to autograd --------------------------------


def _tiny_cfg(mod, **kw):
    base = dict(src_vocab_size=37, trg_vocab_size=41, max_length=32,
                d_model=16, d_inner=32, n_head=2, n_layer=2, dropout=0.1,
                label_smooth_eps=0.1)
    base.update(kw)
    return mod.TransformerConfig(**base)


def _scan_grads(fetch):
    """One build_scan step (dropout 0.1 in attention and in the body)
    from a seeded startup: the fetches."""
    cfg = _tiny_cfg(TT)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        model = TT.build_scan(cfg)
        tfluid.append_backward(model["loss"])
    main.random_seed = startup.random_seed = 11
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        return exe.run(main, feed=TT.make_batch(cfg, 3, 10, 7, seed=0),
                       fetch_list=[model["loss"]] + fetch)


def test_kernel_outputs_opaque_to_autograd_keep_the_scan_gradient(
        monkeypatch):
    """The derived grad of scan re-runs the body's attention and dropout
    under autograd. On the card their kernels return tensors autograd
    cannot see through: patched here to return detached outputs, the
    gradients must not change (on the parent they went to zero)."""
    fetch = ["enc_stack_qkv.w_stacked@GRAD", "dec_stack_ffn1.w_stacked@GRAD",
             "dec_stack_q.w_stacked@GRAD", "src_emb.w@GRAD"]
    want = _scan_grads(fetch)
    fwd, drop = fa.flash_attention_bthd_fwd, nn_ops.dropout_fwd

    def opaque_fwd(*a, **k):
        return tuple(t.detach() for t in fwd(*a, **k))

    def opaque_drop(*a, **k):
        return tuple(t.detach() for t in drop(*a, **k))

    monkeypatch.setattr(fa, "flash_attention_bthd_fwd", opaque_fwd)
    monkeypatch.setattr(nn_ops, "dropout_fwd", opaque_drop)
    got = _scan_grads(fetch)
    for name, w, g in zip(["loss"] + fetch, want, got):
        assert np.abs(w).sum() > 0, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("op_type", ["scaled_dot_product_attention",
                                     "dropout"])
def test_derived_grad_of_a_kernel_op_sees_through_the_kernel(monkeypatch,
                                                             op_type):
    """The op alone: its derived grad (what a scan's re-run takes) with
    the kernel's outputs detached equals its registered grad."""
    from paddle_tpu_torch.core.rng import SeedHandle

    r = np.random.RandomState(5)
    fwd, drop = fa.flash_attention_bthd_fwd, nn_ops.dropout_fwd
    monkeypatch.setattr(fa, "flash_attention_bthd_fwd", lambda *a, **k: tuple(
        t.detach() for t in fwd(*a, **k)))
    monkeypatch.setattr(nn_ops, "dropout_fwd", lambda *a, **k: tuple(
        t.detach() for t in drop(*a, **k)))
    seed = SeedHandle(torch.tensor(123, dtype=torch.int64), 3)
    if op_type == "dropout":
        ins = {"X": [torch.tensor(r.randn(4, 64).astype(np.float32))]}
        attrs = {"dropout_prob": 0.3,
                 "dropout_implementation": "upscale_in_train"}
        out_slots = ["Out", "Mask"]
    else:
        ins = {s: [torch.tensor(r.randn(2, 8, 2, 4).astype(np.float32))]
               for s in ("Q", "K", "V")}
        attrs = {"scale": 0.5, "dropout_prob": 0.2, "layout": "bthd",
                 "causal": True}
        out_slots = ["Out", "Lse"]
    fdef = get_op_def(op_type)
    with torch.no_grad():
        outs = fdef.compute(ins, dict(attrs), torch.device("cpu"), seed=seed)
    cot = torch.tensor(r.randn(*outs["Out"][0].shape).astype(np.float32))
    g_ins = dict(ins, **outs, **{"GRAD::Out": [cot]})
    g_attrs = dict(attrs, fwd_input_slots=list(ins),
                   fwd_output_slots=out_slots)
    derived = autodiff.make_grad_compute(fdef)(g_ins, g_attrs,
                                               torch.device("cpu"), seed=seed)
    gdef = get_op_def(op_type + "_grad")
    registered = gdef.compute(g_ins, g_attrs, torch.device("cpu"),
                              **({"seed": seed} if gdef.needs_rng else {}))
    for k, v in registered.items():
        assert derived[k][0].abs().sum() > 0, k
        torch.testing.assert_close(derived[k][0], v[0], rtol=1e-5, atol=1e-6)


# --- host callbacks ---------------------------------------------------------


def _printed(fluid, in_scan=False):
    L = fluid.layers
    x = L.data("x", shape=[3], dtype="float32")
    h = L.fc(x, 3, param_attr=fluid.ParamAttr(name="pw"))
    if in_scan:
        blk = fluid.default_main_program().global_block()
        xs = blk.create_var(name="xs", shape=(2, 2, 3), dtype="float32")
        rnn = L.StaticRNN()
        with rnn.step():
            rnn.step_output(L.Print(rnn.step_input(xs), message="in-scan"))
        h = L.elementwise_add(h, L.reduce_sum(rnn(), dim=1))
    h = L.Print(h, message="fwd-h", summarize=3, print_phase="both")
    return {"loss": L.mean(h)}


def test_print_in_a_training_step_runs_uncaptured_and_prints(capfd):
    r = np.random.RandomState(6)
    feeds = [{"x": r.randn(2, 3).astype(np.float32)} for _ in range(3)]
    lowering.uncaptured_steps.clear()
    _both(_printed, feeds, lambda m: [m["loss"], "pw@GRAD"],
          opt_fn=lambda fluid: fluid.optimizer.SGD(0.1), tol=TOL_GRAD)
    err = capfd.readouterr().err
    # both packages print the forward and the gradient at every step
    assert err.count("fwd-h") == 2 * 2 * len(feeds), err
    assert err.count("Tensor[") >= 4 * len(feeds)
    reasons = dict(lowering.uncaptured_steps)
    assert reasons == {"host_callback op 'print'": len(feeds)}, reasons


def test_host_callback_in_a_sub_block_keeps_the_block_uncaptured(capfd):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        m = _printed(tfluid, in_scan=True)
    lw = lowering.lower_block(main, 0, ["x", "xs"], [m["loss"].name],
                              torch.device("cpu"))
    assert not lw.capturable
    assert lw.uncaptured.startswith("host_callback op 'print' in block"), \
        lw.uncaptured
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed={"x": np.ones((2, 3), np.float32),
                                "xs": np.ones((2, 2, 3), np.float32)},
                    fetch_list=[m["loss"]])
    # two scan steps a run, three runs
    assert capfd.readouterr().err.count("in-scan") == 6


def _py_func_model(fluid):
    L = fluid.layers
    blk = fluid.default_main_program().global_block()
    x = blk.create_var(name="x", shape=(2, 3), dtype="float32",
                       stop_gradient=False)
    out = blk.create_var(name="y", shape=(2, 3), dtype="float32")
    L.py_func(lambda a: np.tanh(a), x, out,
              backward_func=lambda y, dy: dy * (1.0 - np.square(y)),
              skip_vars_in_backward_input=x)
    return {"y": out, "dx": fluid.gradients(L.reduce_sum(
        L.elementwise_mul(out, out)), x)[0]}


def test_py_func_forward_and_backward_as_jax():
    xv = np.linspace(-1, 1, 6).astype(np.float32).reshape(2, 3)
    (y, dx), = _both(_py_func_model, [{"x": xv}],
                     lambda m: [m["y"], m["dx"]])
    np.testing.assert_allclose(y, np.tanh(xv), rtol=1e-6)
    np.testing.assert_allclose(dx, 2 * np.tanh(xv) * (1 - np.tanh(xv) ** 2),
                               rtol=1e-5)


# --- build_scan --------------------------------------------------------------


def _run_build(mod, fluid, scan, cfg, feed, fetch, state=None):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        model = (mod.build_scan(cfg) if scan else mod.build(cfg))
        fluid.append_backward(model["loss"])
    return main, startup, model


def test_build_scan_equals_build_on_stacked_weights():
    """2 + 2 layers, dropout 0: build_scan's loss and gradients on the
    stacked weights of a build() scope equal build()'s (each stacked
    gradient's layer slices against the per-layer ones)."""
    cfg = _tiny_cfg(TT, dropout=0.0)
    feed = TT.make_batch(cfg, 3, 10, 7, seed=1)
    main_a, start_a, model_a = _run_build(TT, tfluid, False, cfg, feed, [])
    scope_a, exe = tfluid.Scope(), tfluid.Executor(CPU)
    per_layer = [f"enc{i}_attn_qkv_colp.w@GRAD" for i in range(2)] + \
        [f"dec{i}_ffn2_rowp.w@GRAD" for i in range(2)]
    with tfluid.scope_guard(scope_a):
        exe.run(start_a)
        ref = exe.run(main_a, feed=feed, fetch_list=[model_a["loss"],
                                                     "src_emb.w@GRAD",
                                                     *per_layer])
    main_b, start_b, model_b = _run_build(TT, tfluid, True, cfg, feed, [])
    scope_b = tfluid.Scope()
    with tfluid.scope_guard(scope_b):
        exe.run(start_b)
        for name in scope_a.var_names():
            if scope_b.find_var(name) is not None:
                scope_b.set(name, scope_a.find_var(name))
        TT.stack_weights_from_layers(cfg, scope_a, scope_b)
        got = exe.run(main_b, feed=feed, fetch_list=[
            model_b["loss"], "src_emb.w@GRAD", "enc_stack_qkv.w_stacked@GRAD",
            "dec_stack_ffn2.w_stacked@GRAD"])
    assert rel(got[0], ref[0]) <= 2e-6
    assert rel(got[1], ref[1]) <= TOL_GRAD
    for i in range(2):
        assert rel(got[2][i], ref[2 + i]) <= TOL_GRAD
        assert rel(got[3][i], ref[4 + i]) <= TOL_GRAD


def test_build_scan_free_running_steps_equal_build_in_f64():
    """2 + 2 layers in f64 (build()'s startup state cast), two SGD steps
    of build() and of build_scan() from one state: every gradient of
    both steps, every parameter after the first, and build_scan's
    free-running second step against build()'s own (``chip_smoke.
    scan_vs_build``, which phase 16b runs on the card in f32). In f64 no
    rounding of the first step flips a ReLU gate of the second, so the
    free-running steps are held as tightly as those from one state:
    1e-12 on losses and gradients, 1e-10 on the update."""
    from chip_smoke import hold_scan_vs_build, scan_vs_build

    row = scan_vs_build(torch, np, tfluid, TT, CPU,
                        _tiny_cfg(TT, dropout=0.0), (3, 10), "float64")
    assert row["params"] > row["scan_params"] > 0, row
    hold_scan_vs_build(row, 1e-12, 1e-12, 1e-10)
    for k in ("step_2_free_running", "build_at_the_two_states"):
        assert row[k]["loss_rel_err"] <= 1e-12, (k, row)
        assert row[k]["grad_rel_err_max"] <= 1e-12, (k, row)


def test_build_scan_trains_as_the_jax_build_scan():
    """The port's build_scan against the JAX package's, weights carried by
    name: three Adam steps' losses and stacked gradients (dropout 0)."""
    kw = dict(dropout=0.0)
    feeds = [TT.make_batch(_tiny_cfg(TT, **kw), 3, 10, 7, seed=s)
             for s in range(3)]

    def model_fn(fluid):
        mod = JT if fluid is pfluid else TT
        return mod.build_scan(_tiny_cfg(mod, **kw))

    steps = _both(model_fn, feeds,
                  lambda m: [m["loss"], "enc_stack_ffn1.w_stacked@GRAD",
                             "dec_stack_self_q.w_stacked@GRAD"],
                  opt_fn=lambda fluid: fluid.optimizer.Adam(1e-3),
                  tol=TOL_GRAD)
    assert np.abs(steps[0][1]).reshape(2, -1).max(1).min() > 0


def test_build_scan_under_amp_keeps_its_carries_and_equals_eager():
    """bf16 AMP: the scan's carry comes back f32 each layer; the cached
    step runner's steps equal the eager ones bit for bit (dropout 0.1)."""
    cfg = _tiny_cfg(TT)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        model = TT.build_scan(cfg)
        tfluid.optimizer.Adam(1e-3).minimize(model["loss"])
    tfluid.amp.enable_amp(main)
    main.random_seed = 3
    final = next(o for o in main.global_block().ops
                 if o.type == "scan").output("FinalState")[0]
    feeds = [TT.make_batch(cfg, 3, 10, 7, seed=s) for s in range(2)]
    runs = []
    for cached in (False, True):
        exe = tfluid.Executor(CPU)
        with tfluid.scope_guard(tfluid.Scope()):
            exe.run(startup)
            runs.append([exe.run(main, feed=feeds[i % 2],
                                 fetch_list=[model["loss"], final],
                                 use_program_cache=cached)
                         for i in range(3)])
    assert runs[0][0][1].dtype == np.float32
    for a, b in zip(*runs):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    assert np.isfinite([float(s[0]) for s in runs[0]]).all()


# --- the registries -----------------------------------------------------------


@pytest.mark.parametrize("op_type", CONTROL_OP_TYPES + MISC_OP_TYPES)
def test_registries_agree(op_type):
    j, t = jax_op_def(op_type), get_op_def(op_type)
    assert (t.diff_inputs, t.no_grad, t.needs_rng) == (
        j.diff_inputs, j.no_grad, j.needs_rng)
    assert (t.grad_maker is None) == (j.grad_maker is None)
    # by design: print and py_func call back to the host; the three
    # control-flow ops run sub-blocks
    assert t.host_callback == (op_type in ("print", "py_func"))
    assert t.sub_blocks == (op_type in ("bounded_while", "cond", "scan"))
    assert not (t.host_rng or t.host_loop)


def test_cond_grad_is_registered_by_design():
    """The JAX package derives cond's grad (jax.vjp of lax.cond); the
    port registers it (see the cond NaN test)."""
    with pytest.raises(KeyError):
        jax_op_def("cond_grad")
    g = get_op_def("cond_grad")
    assert g.no_grad and g.needs_rng and g.sub_blocks
