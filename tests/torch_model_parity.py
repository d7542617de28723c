"""A model built and trained in both packages on the CPU, for the port's
parity tests: the same build function, the JAX package's startup state
carried across by name (optimizer slots by (param, kind)), the same numpy
feeds, and the fetches of every step from each package; and one op run in
both packages with its derived gradients (``run_both``)."""

import numpy as np
import torch

import jax.numpy as jnp

import paddle_tpu as pfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import autodiff as jautodiff
from paddle_tpu.core.registry import get_op_def as jax_op_def
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import autodiff as tautodiff
from paddle_tpu_torch.core.registry import get_op_def


def build(fluid, model_fn, opt_fn):
    """(main, startup, model dict, optimizer) of ``model_fn(fluid)`` under
    ``unique_name.guard()``, minimized by ``opt_fn(fluid)`` (None: no
    optimizer)."""
    main, startup = fluid.Program(), fluid.Program()
    opt = None
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        model = model_fn(fluid)
        if opt_fn is not None:
            opt = opt_fn(fluid)
            opt.minimize(model["loss"])
    return main, startup, model, opt


def train_both(model_fn, opt_fn, feeds, fetch_fn):
    """Run one step a feed in each package from the JAX package's startup
    state. ``fetch_fn(model)`` names the fetches. Returns (JAX steps, port
    steps, JAX final state, port final state on the JAX slot names, the
    port's main program)."""
    jm, js, jmodel, jo = build(pfluid, model_fn, opt_fn)
    tm, _, tmodel, to = build(tfluid, model_fn, opt_fn)
    jscope = pfluid.Scope()
    jexe = pfluid.Executor(pfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    state = {n: np.array(jscope.find_var(n)) for n in jscope.var_names()}
    j_steps = [[np.asarray(v) for v in jexe.run(
        jm, feed=f, fetch_list=fetch_fn(jmodel), scope=jscope)]
        for f in feeds]
    if jo is not None:
        state = tio.rekey_optimizer_state(state, jo.slot_descriptor(),
                                          to.slot_descriptor())
    tscope = tio.scope_from_numpy(state, tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tscope):
        t_steps = [texe.run(tm, feed=f, fetch_list=fetch_fn(tmodel))
                   for f in feeds]
    j_final = {n: np.array(jscope.find_var(n)) for n in jscope.var_names()}
    t_final = {n: tscope.find_var(n).numpy() for n in tscope.var_names()}
    if jo is not None:
        t_final = tio.rekey_optimizer_state(t_final, to.slot_descriptor(),
                                            jo.slot_descriptor())
    return j_steps, t_steps, j_final, t_final, tm


def rel(got, want):
    """Largest |got - want| relative to the largest |want| (0 for empty
    arrays)."""
    want = np.asarray(want, np.float64)
    if want.size == 0:
        return 0.0
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def same_programs(model_fn, opt_fn):
    """Both packages build the same op types in the same order and the
    same parameter names and shapes."""
    jm, _, _, _ = build(pfluid, model_fn, opt_fn)
    tm, _, _, _ = build(tfluid, model_fn, opt_fn)
    ops = ([o.type for o in jm.global_block().ops],
           [o.type for o in tm.global_block().ops])
    params = [{p.name: tuple(p.shape) for p in m.all_parameters()}
              for m in (jm, tm)]
    return ops, params


def _grad_attrs(op_type, ins, outs, attrs):
    return dict(attrs, fwd_input_slots=list(ins),
                fwd_output_slots=list(outs))


def run_both(op_type, ins, attrs, seed=99, rngs=None):
    """One op in both packages on the same numpy inputs: (JAX outputs,
    port outputs, JAX input grads, port input grads) as numpy, the grads
    from each package's derived grad op (``make_grad_compute``) for one
    random cotangent an output; no grads for a no_grad op. ``rngs``: a
    random op's (port seed, JAX key), passed to its forward and to its
    derived grad op."""
    j_ins = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}
    t_ins = {k: [torch.from_numpy(np.array(v)) for v in vs]
             for k, vs in ins.items()}
    jdef, tdef = jax_op_def(op_type), get_op_def(op_type)
    t_kw, j_kw = ({"seed": rngs[0]}, {"rng": rngs[1]}) if rngs else ({}, {})
    j_outs = jdef.compute(j_ins, dict(attrs), **j_kw)
    t_outs = tdef.compute(t_ins, dict(attrs), torch.device("cpu"), **t_kw)
    jo = {k: [np.asarray(v) for v in vs] for k, vs in j_outs.items()}
    to = {k: [v.numpy() for v in vs] for k, vs in t_outs.items()}
    if jdef.no_grad:
        return jo, to, None, None
    r = np.random.RandomState(seed)
    cots = {k: [np.asarray(r.randn(*v.shape), v.dtype) for v in vs]
            for k, vs in jo.items()
            if vs and np.issubdtype(vs[0].dtype, np.floating)}
    g_attrs = _grad_attrs(op_type, ins, jo, attrs)
    jg_ins = dict(j_ins, **{k: [jnp.asarray(v) for v in vs]
                            for k, vs in j_outs.items()})
    jg_ins.update({"GRAD::" + k: [jnp.asarray(v) for v in vs]
                   for k, vs in cots.items()})
    tg_ins = dict(t_ins, **t_outs)
    tg_ins.update({"GRAD::" + k: [torch.from_numpy(v) for v in vs]
                   for k, vs in cots.items()})
    jg = jautodiff.make_grad_compute(jdef)(jg_ins, g_attrs, **j_kw)
    tg = tautodiff.make_grad_compute(tdef)(tg_ins, g_attrs,
                                           torch.device("cpu"), **t_kw)
    jg = {k: [None if v is None else np.asarray(v) for v in vs]
          for k, vs in jg.items()}
    tg = {k: [None if v is None else v.numpy() for v in vs]
          for k, vs in tg.items()}
    return jo, to, jg, tg


def assert_match(jo, to, jg, tg, tol_fwd=1e-5, tol_grad=1e-4):
    """``run_both``'s results agree: the same output slots, shapes and
    dtypes, float outputs within ``tol_fwd`` and gradients within
    ``tol_grad`` of the largest |element| of the JAX value (``rel``),
    integer and bool outputs exactly."""
    assert sorted(to) == sorted(jo), (sorted(to), sorted(jo))
    for k, vs in jo.items():
        assert len(to[k]) == len(vs), k
        for j, t in zip(vs, to[k]):
            assert t.shape == j.shape and t.dtype == j.dtype, (
                k, t.shape, j.shape, t.dtype, j.dtype)
            if np.issubdtype(j.dtype, np.floating):
                assert rel(t, j) <= tol_fwd, (k, rel(t, j))
            else:
                np.testing.assert_array_equal(t, j, err_msg=k)
    if jg is None:
        return
    assert sorted(tg) == sorted(jg), (sorted(tg), sorted(jg))
    for k, vs in jg.items():
        for j, t in zip(vs, tg[k]):
            assert (j is None) == (t is None), k
            if j is not None:
                assert t.shape == j.shape, (k, t.shape, j.shape)
                assert rel(t, j) <= tol_grad, (k, rel(t, j))
