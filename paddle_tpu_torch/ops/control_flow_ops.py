"""Control-flow ops: ``while``, ``bounded_while``, ``cond``, ``scan``.

The JAX package lowers ``while`` to ``lax.while_loop``: the sub-block is
traced into the compiled step. A CUDA graph cannot hold a loop whose trip
count depends on the data, so here the loop runs on the host and reads
its condition after each iteration (one synchronization an iteration):

- eagerly (``_eager_loop``): the sub-block's ops run through
  ``core/interp.exec_ops`` over an env of the captured and carried
  values. This is the path on the CPU under ``use_program_cache=False``,
  on the card under ``use_program_cache=False``, and for a body that
  itself holds a host loop or a host-seeded random op;
- with a ``core/lowering.LoopRunner`` inside a cached executor call: the
  body runs as a captured CUDA graph, replayed from the host loop (on
  the CPU the runner calls the body directly, with the same buffers and
  bookkeeping). The executor caches the runner per (program, op,
  shapes) and gives it its graph pool (``lowering.LoopContext``).

Values crossing the block boundary are op inputs (slots ``X`` /
``Captured``), never Python closures, so state analysis
(core/lowering.py ``analyze_state``) sees the weights the body reads in
the parent block. The op is ``host_loop``: a block that holds it is never
captured whole; the encoder and the beam set-up around a decode loop run
eagerly at every call, and the op captures only its body.

Seeds: iteration ``i`` runs its body with the seed ``mix64(op seed, i)``
(``rng.mix64_tensor``, mixed on the device), the counterpart of the JAX
package's ``fold_in(rng, i)``: a body with dropout draws new masks each
iteration, the same ones eagerly and replayed, and the same ones again
on a rerun of the same executor step.

The three differentiable ops run their sub-blocks inside their compute,
as plain ops of the step that holds them (a CUDA graph captures them
with it; none reads a value on the host):

- ``scan`` (the JAX package's ``lax.scan``) is a Python loop of T steps;
  step ``i`` runs the body with the seed ``mix64(op seed, i)``, ``i`` the
  step's position in time whichever the direction, and AMP's narrowed
  carries are cast back to their initial dtypes at each step's end.
  ``unroll`` gives the same math (the loop is unrolled already), and a
  ``pipelinable`` scan runs as this plain scan: the JAX package's GPipe
  schedule needs a pipe axis of several devices (ROADMAP.md, Queue 1
  item 9);
- ``bounded_while`` runs exactly ``max_trip_count`` iterations, a dead
  one passing its carries through a select, as the JAX package's scan
  over N steps does;
- ``cond`` runs both branches on the device (seed folds 0 and 1) and
  selects with ``torch.where`` on the device predicate, so the step needs
  no host sync and stays capturable. Its registered ``cond_grad`` takes
  each branch's vector-Jacobian product apart and selects the
  cotangents: the derived grad of the select would multiply the untaken
  branch's non-finite partials by zero (NaN), where ``lax.cond`` gives
  the taken branch's finite gradient. Index ops in the untaken branch
  run too, so they clamp as the JAX ones do.

``scan`` and ``bounded_while`` differentiate through the derived grad,
which re-runs the loop under autograd with the same per-step seeds. On
meta tensors (shape inference) ``scan`` runs its body once and
``cond`` its true branch; the loops return their carries' shapes.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import autodiff, lowering, rng
from paddle_tpu_torch.core.interp import exec_ops, resolve_op_def
from paddle_tpu_torch.core.registry import register_op


def _signature(ts):
    return tuple((tuple(t.shape), t.dtype) for t in ts)


def _check_carry(name, new, old, what):
    if new.shape != old.shape or new.dtype != old.dtype:
        raise RuntimeError(
            f"{what}: loop-carried value '{name}' is {new.dtype} "
            f"{tuple(new.shape)} after an iteration, {old.dtype} "
            f"{tuple(old.shape)} before it; a while loop keeps each "
            f"carried value's shape and dtype")


def _float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def _op_seed(seed):
    return (None if seed is None or seed.buf is None
            else seed.op_seed_tensor())


def _fold(op_seed, i):
    """The seed buffer of iteration (or branch) ``i``: ``mix64(op seed,
    i)`` on the device; None when the op has no seed (shape
    inference)."""
    return None if op_seed is None else rng.mix64_tensor(op_seed, i)


def _block_ops(block):
    ops = list(block.ops)
    return ops, [resolve_op_def(op.type) for op in ops]


def _body_seed(seed, op_defs):
    """The op seed a loop folds its iterations' seeds from, or None when
    no op of its body is random (no seed kernels a step then)."""
    return _op_seed(seed) if any(d.needs_rng for d in op_defs) else None


def _eager_loop(ops, op_defs, carry_names, cond_name, cap_names, cond0,
                carries, caps, op_seed, device, amp, what):
    env_caps = dict(zip(cap_names, caps))
    cond = cond0.reshape(()).to(torch.bool)
    vals = list(carries)
    i = 0
    while lowering.host_bool(cond):
        env = dict(env_caps)
        env[cond_name] = cond
        env.update(zip(carry_names, vals))
        seed = None if op_seed is None else rng.mix64_tensor(op_seed, i)
        exec_ops(ops, env, device=device, seed=seed, amp=amp,
                 op_defs=op_defs)
        cond = env[cond_name].reshape(()).to(torch.bool)
        new = [env[n] for n in carry_names]
        for n, v, old in zip(carry_names, new, vals):
            _check_carry(n, v, old, what)
        vals = new
        i += 1
    return vals, cond, torch.full((), i, dtype=torch.int32, device=device)


@register_op("while", no_grad=True, needs_rng=True, host_loop=True)
def _while(ins, attrs, device, seed=None, amp=False):
    """Run ``sub_block`` while the condition var is true.

    attrs: sub_block, carry_names (env names of the loop-carried values,
    written by each iteration), cond_name (env name of the bool the
    sub-block refreshes each iteration), captured_names.
    inputs: Condition=[cond0], X=carried initial values, Captured=read-only.
    outputs: Out=final carried values (in carry_names' order), CondOut=the
    final condition (a 0-d bool), Steps=iterations run (a 0-d int32).
    """
    sub = attrs["sub_block"]
    carry_names = list(attrs["carry_names"])
    cond_name = attrs["cond_name"]
    cap_names = list(attrs.get("captured_names", []))
    cond0 = ins["Condition"][0]
    carries = list(ins.get("X", []))
    caps = list(ins.get("Captured", []))
    if device.type == "meta":  # shape inference: carries keep their shapes
        return {"Out": [torch.empty_like(v) for v in carries],
                "CondOut": [torch.empty((), dtype=torch.bool, device=device)],
                "Steps": [torch.empty((), dtype=torch.int32, device=device)]}
    ops, op_defs = _block_ops(sub)
    op_seed = _op_seed(seed)
    ctx = lowering.current_loop_context()
    what = (f"{ctx.what if ctx is not None else 'program'}, while op of "
            f"block {sub.idx}")
    capturable = lowering.uncaptured_reason(ops, op_defs) is None
    if ctx is None or not capturable:
        vals, cond, steps = _eager_loop(
            ops, op_defs, carry_names, cond_name, cap_names, cond0, carries,
            caps, op_seed, device, amp, what)
    else:
        prog = sub.program
        key = (prog._uid, prog.version, sub.idx, amp,
               _signature([cond0] + carries + caps))
        runner = ctx.runners.get(key)
        if runner is None:
            runner = ctx.runners[key] = lowering.LoopRunner(
                ops, op_defs, carry_names, cond_name, cap_names, device,
                amp, what, ctx.pool)
        vals, cond, steps = runner.run(cond0, carries, caps, op_seed)
    return {"Out": vals, "CondOut": [cond], "Steps": [steps]}


@register_op("bounded_while", diff_inputs=("X", "Captured"), needs_rng=True,
             sub_blocks=True)
def _bounded_while(ins, attrs, device, seed=None, amp=False):
    """A differentiable ``while``: exactly ``max_trip_count`` iterations,
    each dead one (after the condition turned false) passing the carries
    through a select, so gradients flow through the live iterations and
    the captured values. CondOut still true at the end means the loop was
    truncated; Steps counts the live iterations.

    Same attrs, inputs and outputs as ``while``, plus ``max_trip_count``.
    """
    carry_names = list(attrs["carry_names"])
    cond_name = attrs["cond_name"]
    cap_names = list(attrs.get("captured_names", []))
    n_steps = int(attrs["max_trip_count"])
    carries = list(ins.get("X", []))
    live = ins["Condition"][0].reshape(()).to(torch.bool)
    if device.type == "meta":
        return {"Out": [torch.empty_like(v) for v in carries],
                "CondOut": [torch.empty((), dtype=torch.bool, device=device)],
                "Steps": [torch.empty((), dtype=torch.int32, device=device)]}
    ops, op_defs = _block_ops(attrs["sub_block"])
    op_seed = _body_seed(seed, op_defs)
    env_caps = dict(zip(cap_names, ins.get("Captured", [])))
    steps = torch.zeros((), dtype=torch.int32, device=live.device)
    for i in range(n_steps):
        env = dict(env_caps)
        env[cond_name] = live
        env.update(zip(carry_names, carries))
        exec_ops(ops, env, device=device, seed=_fold(op_seed, i), amp=amp,
                 op_defs=op_defs)
        carries = [torch.where(live, env[n].to(v.dtype), v)
                   for n, v in zip(carry_names, carries)]
        steps = steps + live.to(torch.int32)
        live = live & env[cond_name].reshape(()).to(torch.bool)
    return {"Out": carries, "CondOut": [live], "Steps": [steps]}


def _branch(block, out_names, cap_names, caps, device, seed, amp):
    ops, op_defs = _block_ops(block)
    env = dict(zip(cap_names, caps))
    exec_ops(ops, env, device=device, seed=seed, amp=amp, op_defs=op_defs)
    return [env[n] for n in out_names]


def _cond_branches(ins, attrs):
    return ((attrs["true_block"], list(attrs["true_out_names"]), 0),
            (attrs["false_block"], list(attrs["false_out_names"]), 1))


@register_op("cond", diff_inputs=("Captured",), needs_rng=True,
             sub_blocks=True)
def _cond(ins, attrs, device, seed=None, amp=False):
    """Select between two sub-blocks on a scalar predicate.

    attrs: true_block, false_block, true_out_names, false_out_names,
    captured_names. Both branches read the same Captured values; outputs
    pair up by position (``Out[i]`` = true_out_names[i] /
    false_out_names[i]). Both branches run; ``torch.where`` on the device
    predicate picks each output."""
    cap_names = list(attrs.get("captured_names", []))
    caps = list(ins.get("Captured", []))
    (tb, t_names, _), (fb, f_names, _) = _cond_branches(ins, attrs)
    if device.type == "meta":
        return {"Out": _branch(tb, t_names, cap_names, caps, device, None,
                               amp)}
    pred = ins["Cond"][0].reshape(()).to(torch.bool)
    op_seed = _op_seed(seed)
    t_outs = _branch(tb, t_names, cap_names, caps, device, _fold(op_seed, 0),
                     amp)
    f_outs = _branch(fb, f_names, cap_names, caps, device, _fold(op_seed, 1),
                     amp)
    return {"Out": [torch.where(pred, a, b) for a, b in zip(t_outs, f_outs)]}


@register_op("cond_grad", no_grad=True, needs_rng=True, sub_blocks=True)
def _cond_grad(ins, attrs, device, seed=None, amp=False):
    """The gradient of ``cond`` for its float Captured values: each
    branch's vector-Jacobian product for the output cotangents, taken
    apart (each branch re-run under autograd with the forward's seed
    fold), then selected with ``torch.where`` on the predicate, so a
    non-finite partial of the untaken branch never reaches the result
    (the taken branch's gradient, as ``lax.cond``'s)."""
    cap_names = list(attrs.get("captured_names", []))
    caps = list(ins.get("Captured", []))
    diff = [i for i, c in enumerate(caps) if _float(c)]
    if device.type == "meta":
        return {"GRAD::Captured": [torch.empty_like(c) if i in diff else None
                                   for i, c in enumerate(caps)]}
    pred = ins["Cond"][0].reshape(()).to(torch.bool)
    cots = list(ins.get("GRAD::Out", []))
    op_seed = _op_seed(seed)
    per_branch = []
    for block, names, fold in _cond_branches(ins, attrs):
        with torch.enable_grad():
            primals = [caps[i].detach().requires_grad_(True) for i in diff]
            merged = list(caps)
            for i, p in zip(diff, primals):
                merged[i] = p
            outs = _branch(block, names, cap_names, merged, device,
                           _fold(op_seed, fold), amp)
            ys, gs = [], []
            for j, y in enumerate(outs):
                g = cots[j] if j < len(cots) else None
                if g is None or not y.requires_grad:
                    continue
                ys.append(y)
                gs.append(g.to(y.dtype).expand(y.shape))
            grads = autodiff.vjp(ys, primals, gs)
        per_branch.append([torch.zeros_like(p) if g is None else g
                           for p, g in zip(primals, grads)])
    result = [None] * len(caps)
    for i, gt, gf in zip(diff, *per_branch):
        result[i] = torch.where(pred, gt, gf)
    return {"GRAD::Captured": result}


@register_op("scan", diff_inputs=("X", "Init", "Captured"), needs_rng=True,
             sub_blocks=True)
def _scan(ins, attrs, device, seed=None, amp=False):
    """Fixed-length recurrence: run ``sub_block`` over the leading axis.

    attrs: sub_block, x_names (env names of the per-step slices of X),
    state_in_names / state_out_names (the carried state's env names, read
    and written each step), y_names (env names stacked into Y),
    captured_names, reverse, n_steps (when X is empty), unroll,
    pipelinable.
    inputs: X=[T, ...] scanned tensors (time-major), Init=initial states,
    Captured=read-only values (parameters live here, so gradients flow).
    outputs: Y=stacked per-step outputs [T, ...], FinalState=final states.
    """
    x_names = list(attrs.get("x_names", []))
    s_in = list(attrs.get("state_in_names", []))
    s_out = list(attrs.get("state_out_names", []))
    y_names = list(attrs.get("y_names", []))
    cap_names = list(attrs.get("captured_names", []))
    reverse = bool(attrs.get("reverse", False))
    xs = list(ins.get("X", []))
    init = list(ins.get("Init", []))
    n_steps = int(xs[0].shape[0]) if xs else int(attrs["n_steps"])
    ops, op_defs = _block_ops(attrs["sub_block"])
    env_caps = dict(zip(cap_names, ins.get("Captured", [])))
    op_seed = _body_seed(seed, op_defs)
    meta = device.type == "meta"

    def step(carry, i):
        env = dict(env_caps)
        env.update(zip(s_in, carry))
        env.update(zip(x_names, (x[i] for x in xs)))
        exec_ops(ops, env, device=device, seed=_fold(op_seed, i), amp=amp,
                 op_defs=op_defs)
        # AMP may narrow a carried activation to bf16 mid-body: each
        # carry keeps its initial dtype across steps
        return ([env[n].to(v.dtype) for n, v in zip(s_out, init)],
                [env[n] for n in y_names])

    if meta:  # shape inference: one step gives every shape
        carry, ys = step(init, 0)
        return {"Y": [y.unsqueeze(0).expand((n_steps,) + tuple(y.shape))
                      for y in ys], "FinalState": carry}
    order = range(n_steps - 1, -1, -1) if reverse else range(n_steps)
    carry, ys_steps = list(init), []
    for i in order:
        carry, ys = step(carry, i)
        ys_steps.append(ys)
    if reverse:
        ys_steps.reverse()
    return {"Y": [torch.stack([st[j] for st in ys_steps])
                  for j in range(len(y_names))],
            "FinalState": carry}
