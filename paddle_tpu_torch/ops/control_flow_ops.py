"""Control-flow ops: ``while``.

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
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import lowering, rng
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
    ops = list(sub.ops)
    op_defs = [resolve_op_def(op.type) for op in ops]
    op_seed = (None if seed is None or seed.buf is None
               else seed.op_seed_tensor())
    ctx = lowering.current_loop_context()
    what = (f"{ctx.what if ctx is not None else 'program'}, while op of "
            f"block {sub.idx}")
    capturable = not any(d.host_loop or d.host_rng for d in op_defs)
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
