"""A model built and trained in both packages on the CPU, for the port's
parity tests: the same build function, the JAX package's startup state
carried across by name (optimizer slots by (param, kind)), the same numpy
feeds, and the fetches of every step from each package."""

import numpy as np

import paddle_tpu as pfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio


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
    """Largest |got - want| relative to the largest |want|."""
    want = np.asarray(want, np.float64)
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
