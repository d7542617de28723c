"""Automatic mixed precision (the JAX package's amp.py; reference:
contrib/mixed_precision/decorator.py:190).

A program marked ``_amp`` runs its matmul-heavy ops in bf16 and keeps the
activation stream between them in bf16 (the op sets are in
core/interp.py); parameters stay f32. ``enable_amp`` marks a program;
``decorate`` wraps an optimizer whose ``minimize`` marks it.

``use_dynamic_loss_scaling=True`` also builds the dynamic loss-scaling
state machine as ops of the step (Micikevicius et al., ICLR 2018), so
it runs inside the captured step with no host round trip: the loss is
multiplied by a persistable ``loss_scaling`` var before the backward;
one ``isfinite`` op checks every gradient; the gradients are divided by
the scale (a direct divide: near the f32 ceiling the reciprocal of the
scale is subnormal, and a flush to zero would zero every gradient) and
zeroed when any was non-finite; every parameter's learning rate is gated
to 0 on such a step; and the scale grows ``incr_ratio``-fold after
``incr_every_n_steps`` clean steps (only while the grown scale is still
finite) and shrinks ``decr_ratio``-fold after
``decr_every_n_nan_or_inf`` overflowing ones, with a cumulative skip
counter.

Skip semantics: parameters are bit-unchanged on an overflow step.
Optimizer accumulators still see the (zeroed) gradient, so momentum and
Adam moments decay one step and Adam's beta powers advance, as in the
JAX package.

Left out of the port: the JAX package registers the scale, the overflow
flag and the skip count with its numerics plane (numerics.py, not
ported), and refuses dynamic scaling in dygraph mode (dygraph is not
ported).
"""

from __future__ import annotations

from paddle_tpu_torch.framework import default_main_program


class AmpOptimizer:
    """The ``decorate`` wrapper: delegates to the inner optimizer, marks
    programs for bf16 execution and, with dynamic loss scaling, builds
    the state machine around ``minimize``."""

    def __init__(self, inner, init_loss_scaling: float,
                 use_dynamic_loss_scaling: bool,
                 incr_every_n_steps: int, decr_every_n_nan_or_inf: int,
                 incr_ratio: float, decr_ratio: float):
        self._inner = inner
        self._dynamic = bool(use_dynamic_loss_scaling)
        self._init_scale = float(init_loss_scaling)
        self._incr_every_n = int(incr_every_n_steps)
        self._decr_every_n = int(decr_every_n_nan_or_inf)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        # set by the dynamic minimize: scope names of the state vars
        self.loss_scaling_name = None
        self.found_inf_name = None
        self.skip_count_name = None

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def backward(self, *args, **kwargs):
        return self._inner.backward(*args, **kwargs)

    def apply_gradients(self, params_grads):
        if self._dynamic:
            raise RuntimeError(
                "dynamic loss scaling wires scaling/unscale/skip ops "
                "around the whole backward — use minimize(), not a "
                "separate backward() + apply_gradients()")
        result = self._inner.apply_gradients(params_grads)
        default_main_program()._amp = True
        return result

    def minimize(self, loss, **kwargs):
        program = loss.block.program
        if not self._dynamic:
            result = self._inner.minimize(loss, **kwargs)
            program._amp = True
            return result
        return self._dynamic_minimize(loss, program, **kwargs)

    def _dynamic_minimize(self, loss, program, startup_program=None,
                          parameter_list=None, no_grad_set=None):
        from paddle_tpu_torch import unique_name
        from paddle_tpu_torch.layers import more as lmore
        from paddle_tpu_torch.layers import nn, tensor

        program._amp = True
        block = program.global_block()
        scale_var = tensor.create_global_var(
            [1], self._init_scale, "float32", persistable=True,
            name=unique_name.generate("loss_scaling"))
        good_var = tensor.create_global_var(
            [1], 0.0, "float32", persistable=True,
            name=unique_name.generate("loss_scaling_good"))
        bad_var = tensor.create_global_var(
            [1], 0.0, "float32", persistable=True,
            name=unique_name.generate("loss_scaling_bad"))
        skips_var = tensor.create_global_var(
            [1], 0.0, "float32", persistable=True,
            name=unique_name.generate("loss_scaling_skips"))

        scaled_loss = nn.elementwise_mul(loss, block.var(scale_var.name))
        params_grads = self._inner.backward(
            scaled_loss, startup_program, parameter_list, no_grad_set)

        grads = [g for _, g in params_grads if g is not None]
        # one isfinite op over every gradient -> one all-finite flag
        fin = lmore.isfinite(grads)
        fin_f = nn.cast(fin, "float32")
        one = tensor.fill_constant([1], "float32", 1.0)
        not_fin = nn.elementwise_sub(one, fin_f)

        # unscale by a direct divide, and zero the whole gradient set on
        # overflow (g / scale keeps an inf, which would poison the clip
        # and decay arithmetic downstream)
        new_pgs = []
        for p, g in params_grads:
            if g is None:
                new_pgs.append((p, None))
                continue
            clean = nn.where(
                fin, nn.elementwise_div(g, block.var(scale_var.name)),
                tensor.zeros_like(g))
            new_pgs.append((p, clean))

        # grow after incr_every_n clean steps, shrink after decr_every_n
        # overflowing ones; each counter resets on the other outcome and
        # on its own firing
        good1 = nn.elementwise_mul(
            nn.elementwise_add(good_var, one), fin_f)
        bad1 = nn.elementwise_mul(
            nn.elementwise_add(bad_var, one), not_fin)
        grow = nn.elementwise_mul(
            nn.cast(lmore.greater_equal(
                good1, tensor.fill_constant(
                    [1], "float32", float(self._incr_every_n))),
                "float32"),
            fin_f)
        shrink = nn.elementwise_mul(
            nn.cast(lmore.greater_equal(
                bad1, tensor.fill_constant(
                    [1], "float32", float(self._decr_every_n))),
                "float32"),
            not_fin)
        factor = nn.elementwise_mul(
            nn.elementwise_pow(
                tensor.fill_constant([1], "float32", self._incr_ratio),
                grow),
            nn.elementwise_pow(
                tensor.fill_constant([1], "float32", self._decr_ratio),
                shrink))
        # the growth guard: grow only while the grown scale is finite (an
        # inf scale would flag every later step as an overflow)
        cand = nn.elementwise_mul(block.var(scale_var.name), factor)
        tensor.assign(
            nn.where(lmore.isfinite(cand), cand,
                     block.var(scale_var.name)),
            output=block.var(scale_var.name))
        tensor.assign(
            nn.elementwise_mul(good1, nn.elementwise_sub(one, grow)),
            output=block.var(good_var.name))
        tensor.assign(
            nn.elementwise_mul(bad1, nn.elementwise_sub(one, shrink)),
            output=block.var(bad_var.name))
        tensor.assign(
            nn.elementwise_add(block.var(skips_var.name), not_fin),
            output=block.var(skips_var.name))

        self.loss_scaling_name = scale_var.name
        self.found_inf_name = not_fin.name
        self.skip_count_name = skips_var.name
        program._amp_scale_vars = (scale_var.name, good_var.name,
                                   bad_var.name, not_fin.name)

        # the skip: every parameter's learning rate gated to 0 on an
        # overflow step (an instance attribute shadows the method for
        # this one apply_gradients; the inner optimizer stays reusable)
        inner = self._inner
        orig_param_lr = inner._param_lr

        def _gated_lr(param):
            return nn.elementwise_mul(orig_param_lr(param), fin_f)

        inner._param_lr = _gated_lr
        try:
            opt_ops = inner.apply_gradients(new_pgs)
        finally:
            del inner.__dict__["_param_lr"]
        return opt_ops, new_pgs


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             use_dynamic_loss_scaling: bool = False,
             incr_every_n_steps: int = 1000,
             decr_every_n_nan_or_inf: int = 1,
             incr_ratio: float = 2.0, decr_ratio: float = 0.5):
    """Wrap an optimizer so that ``minimize()`` marks the program for
    bf16 execution; with ``use_dynamic_loss_scaling`` the loss-scaling
    state machine is built around the backward too (module docstring).
    ``amp_lists`` is taken for the JAX package's signature: the op sets
    are fixed, as there."""
    return AmpOptimizer(optimizer, init_loss_scaling,
                        use_dynamic_loss_scaling, incr_every_n_steps,
                        decr_every_n_nan_or_inf, incr_ratio, decr_ratio)


def enable_amp(program=None):
    """Mark a program for bf16 execution of its matmul-heavy ops."""
    (program or default_main_program())._amp = True


def disable_amp(program=None):
    (program or default_main_program())._amp = False
