"""Optimizers as ops (reference: python/paddle/fluid/optimizer.py:50-475).

``minimize`` = ``append_backward`` + one update op per parameter, with
per-parameter accumulators created as persistable vars initialized by
the startup program. Ported: the ``Optimizer`` base, SGD, Momentum and
Adam.
"""

from __future__ import annotations

from typing import Dict, Optional

from paddle_tpu_torch import clip as clip_mod
from paddle_tpu_torch import regularizer as reg_mod
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.backward import append_backward
from paddle_tpu_torch.framework import Parameter, Variable, default_main_program
from paddle_tpu_torch.layers import nn, tensor


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._lr_input = learning_rate
        self._lr_var: Optional[Variable] = None
        self.regularization = regularization
        self._name = name
        # {accumulator kind: {param name: Variable}}
        self._accumulators: Dict[str, Dict[str, Variable]] = {}

    # --- learning rate ---

    def _create_lr_var(self):
        if isinstance(self._lr_input, Variable):
            self._lr_var = self._lr_input
            return
        self._lr_var = tensor.create_global_var(
            shape=[1], value=float(self._lr_input), dtype="float32",
            persistable=True, name=unique_name.generate("learning_rate"))

    @property
    def learning_rate(self):
        return self._lr_var

    def _param_lr(self, param: Parameter):
        mult = (param.optimize_attr or {}).get("learning_rate", 1.0)
        if mult == 1.0:
            return self._lr_var
        return nn.scale(self._lr_var, scale=float(mult))

    # --- accumulators ---

    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        shape = list(shape if shape is not None else param.shape)
        var = tensor.create_global_var(
            shape=shape, value=fill_value, dtype=dtype or param.dtype,
            persistable=True,
            name=unique_name.generate(f"{param.name}_{name}"))
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def slot_descriptor(self) -> Dict[str, Dict[str, str]]:
        """{slot var name -> {"param": owning param, "slot": kind}} for
        every accumulator this optimizer created, plus the learning-rate
        var it created. Slot var names come from ``unique_name`` and
        differ between builds (and between the two packages); (param,
        kind) does not, so state moves across by it (io.py)."""
        out: Dict[str, Dict[str, str]] = {}
        for kind, d in self._accumulators.items():
            for pname, var in d.items():
                out[var.name] = {"param": pname, "slot": kind}
        if self._lr_var is not None and \
                not isinstance(self._lr_input, Variable):
            out[self._lr_var.name] = {"param": "", "slot": "learning_rate"}
        return out

    # --- hooks for subclasses ---

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # --- public API (reference: optimizer.py:352-475) ---

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        """Append clip, regularization and update ops; returns the
        operators appended to the block."""
        block = default_main_program().global_block()
        self._create_lr_var()
        params_grads = clip_mod.append_gradient_clip_ops(params_grads)
        params_grads = reg_mod.append_regularization_ops(
            params_grads, self.regularization)
        self._create_accumulators(block, [p for p, _ in params_grads])
        n_before = len(block.ops)
        for pg in params_grads:
            self._append_optimize_op(block, pg)
        return block.ops[n_before:]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        block.append_op(
            "sgd",
            inputs={"Param": p, "Grad": g, "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p.name},
        )


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        block.append_op(
            "momentum",
            inputs={"Param": p, "Grad": g, "Velocity": v,
                    "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p.name, "VelocityOut": v.name},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=1.0, shape=[1])
            self._add_accumulator("beta2_pow", p, fill_value=1.0, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow", p)
        b2p = self._get_accumulator("beta2_pow", p)
        block.append_op(
            "adam",
            inputs={"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2,
                    "Beta1Pow": b1p, "Beta2Pow": b2p,
                    "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p.name, "Moment1Out": m1.name,
                     "Moment2Out": m2.name, "Beta1PowOut": b1p.name,
                     "Beta2PowOut": b2p.name},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
