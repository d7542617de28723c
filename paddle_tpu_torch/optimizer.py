"""Optimizers as ops (reference: python/paddle/fluid/optimizer.py:50-475).

``minimize`` = ``append_backward`` + the gradient clip and weight decay
(clip.py, regularizer.py) + one update op per parameter, with
per-parameter accumulators created as persistable vars initialized by
the startup program; their names and fill values are the JAX package's,
so ``slot_descriptor()`` lines up between the packages. Ported: the
``Optimizer`` base, SGD, Momentum, LarsMomentum, Adam, AdamW and Lamb
(Adam's update op with another ``_op_type`` and ``_extra_attrs``), the
row-sparse updates of SGD, Momentum and Adam (ops/sparse_ops.py; the
other optimizers refuse a row-sparse gradient, as in the JAX package),
Adagrad, DecayedAdagrad, RMSProp, Ftrl, Adamax, Adadelta, the
``ExponentialMovingAverage`` of the parameters and the ``ModelAverage``
placeholder, with the JAX package's short aliases. Not ported:
``DGCMomentumOptimizer`` (its op runs the JAX package's
parallel/dgc.py), and the JAX package's dygraph minimize (dygraph is not
ported).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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
        # Row-sparse gradients (embedding(is_sparse=True)) bypass the clip
        # and the decay and go to the optimizer's sparse op. A requested
        # decay or clip on such a parameter raises instead of being
        # skipped (a global-norm clip over the dense gradients alone
        # would under-clip).
        sparse = [(p, g) for p, g in params_grads
                  if getattr(g, "is_selected_rows", False)]
        dense = [(p, g) for p, g in params_grads
                 if not getattr(g, "is_selected_rows", False)]
        for p, _ in sparse:
            if self.regularization is not None or \
                    getattr(p, "regularizer", None) is not None:
                raise NotImplementedError(
                    f"regularization on row-sparse parameter '{p.name}' is "
                    f"not supported; use is_sparse=False for this embedding")
            if clip_mod.clip_applies_to(p.name):
                raise NotImplementedError(
                    f"gradient clipping with row-sparse parameter "
                    f"'{p.name}' is not supported (a global-norm clip over "
                    f"dense grads only would under-clip); use "
                    f"is_sparse=False")
        pre_clip = list(dense)
        dense = clip_mod.append_gradient_clip_ops(dense)
        dense = reg_mod.append_regularization_ops(dense, self.regularization)
        params_grads = dense + sparse
        self._maybe_instrument_grad_norm(block.program, pre_clip)
        self._create_accumulators(block, [p for p, _ in params_grads])
        n_before = len(block.ops)
        for pg in params_grads:
            if getattr(pg[1], "is_selected_rows", False):
                self._append_sparse_optimize_op(block, pg)
            else:
                self._append_optimize_op(block, pg)
        return block.ops[n_before:]

    def _append_sparse_optimize_op(self, block, param_and_grad):
        raise NotImplementedError(
            f"{type(self).__name__} has no row-sparse update op; use "
            f"SGD/Momentum/Adam for is_sparse=True embeddings, or build "
            f"the embedding with is_sparse=False")

    @staticmethod
    def _maybe_instrument_grad_norm(prog, dense):
        """Numerics-plane grad-norm instrument: with the ``numerics``
        flag on at graph-build time (and no GradientClipByGlobalNorm
        already exporting the norm), append a global-norm reduction over
        the pre-clip, pre-decay gradients (the norm the clip exports, so
        ``pt_grad_global_norm`` always means the raw-gradient norm) and
        register it as an aux var. Flag-gated at build, so a program
        built with the flag off carries no extra op."""
        from paddle_tpu_torch import flags as _flags

        if not _flags.get_flag("numerics"):
            return
        from paddle_tpu_torch import numerics

        if any(k == "grad_global_norm"
               for k, _ in getattr(prog, "_numerics_aux", ())):
            return
        grads = [g for _, g in dense if g is not None]
        if not grads:
            return
        from paddle_tpu_torch.layer_helper import LayerHelper
        from paddle_tpu_torch.layers import nn

        helper = LayerHelper("grad_norm_instrument")
        sq = []
        for g in grads:
            out = helper.create_variable_for_type_inference(dtype=g.dtype)
            helper.append_op("squared_l2_norm", inputs={"X": g},
                             outputs={"Out": out})
            sq.append(out)
        norm = nn.sqrt(nn.sums(sq))
        numerics.register_aux(prog, "grad_global_norm", norm.name)

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

    def _append_sparse_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        block.append_op(
            "sgd_sparse",
            inputs={"Param": p, "Rows": g.sparse_rows_name,
                    "Values": g.sparse_values_name,
                    "LearningRate": self._param_lr(p)},
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

    def _append_sparse_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        block.append_op(
            "momentum_sparse",
            inputs={"Param": p, "Rows": g.sparse_rows_name,
                    "Values": g.sparse_values_name, "Velocity": v,
                    "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p.name, "VelocityOut": v.name},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        block.append_op(
            "lars_momentum",
            inputs={"Param": p, "Grad": g, "Velocity": v,
                    "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p.name, "VelocityOut": v.name},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay},
        )


class AdamOptimizer(Optimizer):
    """Adam; AdamW and Lamb reuse its accumulators and op desc under
    their own ``_op_type`` with ``_extra_attrs``. A row-sparse gradient
    takes lazy Adam (``adam_sparse``: the rows a batch does not touch keep
    their moments), whatever ``lazy_mode`` says, as in the JAX package,
    which takes ``lazy_mode`` for the reference's signature."""

    _op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None,
                 lazy_mode=False):
        super().__init__(learning_rate, regularization, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=1.0, shape=[1])
            self._add_accumulator("beta2_pow", p, fill_value=1.0, shape=[1])

    def _extra_attrs(self):
        return {}

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow", p)
        b2p = self._get_accumulator("beta2_pow", p)
        block.append_op(
            self._op_type,
            inputs={"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2,
                    "Beta1Pow": b1p, "Beta2Pow": b2p,
                    "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p.name, "Moment1Out": m1.name,
                     "Moment2Out": m2.name, "Beta1PowOut": b1p.name,
                     "Beta2PowOut": b2p.name},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, **self._extra_attrs()},
        )

    def _append_sparse_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow", p)
        b2p = self._get_accumulator("beta2_pow", p)
        block.append_op(
            "adam_sparse",
            inputs={"Param": p, "Rows": g.sparse_rows_name,
                    "Values": g.sparse_values_name, "Moment1": m1,
                    "Moment2": m2, "Beta1Pow": b1p, "Beta2Pow": b2p,
                    "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p.name, "Moment1Out": m1.name,
                     "Moment2Out": m2.name, "Beta1PowOut": b1p.name,
                     "Beta2PowOut": b2p.name},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )


class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay (the ``adamw`` op)."""

    _op_type = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, regularization=None,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         regularization, name)
        self._weight_decay = weight_decay

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}

    def _append_sparse_optimize_op(self, block, param_and_grad):
        # adam_sparse would silently drop the decoupled decay
        return Optimizer._append_sparse_optimize_op(
            self, block, param_and_grad)


class LambOptimizer(AdamOptimizer):
    """Adam's moments with a layer-wise trust ratio (the ``lamb`` op)."""

    _op_type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, regularization=None,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         regularization, name)
        self._weight_decay = lamb_weight_decay

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}

    def _append_sparse_optimize_op(self, block, param_and_grad):
        # adam_sparse would silently drop the trust-ratio rule
        return Optimizer._append_sparse_optimize_op(
            self, block, param_and_grad)


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None, initial_accumulator_value=0.0):
        super().__init__(learning_rate, regularization, name)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        block.append_op(
            "adagrad",
            inputs={"Param": p, "Grad": g, "Moment": m,
                    "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p.name, "MomentOut": m.name},
            attrs={"epsilon": self._epsilon},
        )


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        block.append_op(
            "decayed_adagrad",
            inputs={"Param": p, "Grad": g, "Moment": m,
                    "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p.name, "MomentOut": m.name},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("moment", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ms = self._get_accumulator("mean_square", p)
        mom = self._get_accumulator("moment", p)
        inputs = {"Param": p, "Grad": g, "MeanSquare": ms, "Moment": mom,
                  "LearningRate": self._param_lr(p)}
        outputs = {"ParamOut": p.name, "MeanSquareOut": ms.name,
                   "MomentOut": mom.name}
        if self._centered:
            mg = self._get_accumulator("mean_grad", p)
            inputs["MeanGrad"] = mg
            outputs["MeanGradOut"] = mg.name
        block.append_op(
            "rmsprop", inputs=inputs, outputs=outputs,
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered},
        )


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        block.append_op(
            "ftrl",
            inputs={"Param": p, "Grad": g, "SquaredAccumulator": sq,
                    "LinearAccumulator": lin,
                    "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p.name, "SquaredAccumOut": sq.name,
                     "LinearAccumOut": lin.name},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power},
        )


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, fill_value=1.0, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        u = self._get_accumulator("inf_norm", p)
        b1p = self._get_accumulator("beta1_pow", p)
        block.append_op(
            "adamax",
            inputs={"Param": p, "Grad": g, "Moment": m, "InfNorm": u,
                    "Beta1Pow": b1p, "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p.name, "MomentOut": m.name,
                     "InfNormOut": u.name, "Beta1PowOut": b1p.name},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )


class AdadeltaOptimizer(Optimizer):
    """Adadelta; its op applies the learning-rate-free rule."""

    def __init__(self, learning_rate=1.0, epsilon=1e-6, rho=0.95,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        eg2 = self._get_accumulator("avg_squared_grad", p)
        edx2 = self._get_accumulator("avg_squared_update", p)
        block.append_op(
            "adadelta",
            inputs={"Param": p, "Grad": g, "AvgSquaredGrad": eg2,
                    "AvgSquaredUpdate": edx2,
                    "LearningRate": self._param_lr(p)},
            outputs={"ParamOut": p.name, "AvgSquaredGradOut": eg2.name,
                     "AvgSquaredUpdateOut": edx2.name},
            attrs={"rho": self._rho, "epsilon": self._epsilon},
        )


# the JAX package's short aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adagrad = AdagradOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer


class ExponentialMovingAverage:
    """EMA of the trainable parameters (reference: optimizer.py:2292).
    ``update()`` appends the shadow updates (shadow = decay * shadow +
    (1 - decay) * param) and a step counter to the main program;
    ``apply()`` puts the zero-debiased shadows, shadow / (1 - decay^t),
    into the Scope in place of the parameters, and ``restore()`` puts the
    parameters back. Each value set is a tensor of its own: a captured
    step copies it into the Scope's buffer before its next replay
    (core/lowering.py), and the buffer, which that copy overwrites, is
    never kept as the backup."""

    def __init__(self, decay=0.999, name=None):
        self._decay = decay
        self._name = name or "ema"
        self._shadows: List[Tuple[Variable, Variable]] = []
        self._backup: Dict[str, object] = {}
        self._step_var = None

    def update(self):
        prog = default_main_program()
        block = prog.global_block()
        # the shadows start at 0: the step count debiases them
        self._step_var = tensor.create_global_var(
            shape=[1], value=0.0, dtype="float32", persistable=True,
            name=unique_name.generate(f"{self._name}_step"))
        bumped = nn.scale(block.var(self._step_var.name), scale=1.0,
                          bias=1.0)
        block.append_op("assign", inputs={"X": bumped},
                        outputs={"Out": self._step_var.name})
        for p in prog.all_parameters():
            if not p.trainable:
                continue
            shadow = tensor.create_global_var(
                shape=list(p.shape), value=0.0, dtype=p.dtype,
                persistable=True,
                name=unique_name.generate(f"{self._name}_{p.name}"))
            scaled = nn.scale(block.var(shadow.name), scale=self._decay)
            contrib = nn.scale(block.var(p.name), scale=1.0 - self._decay)
            summed = nn.elementwise_add(scaled, contrib)
            block.append_op("assign", inputs={"X": summed},
                            outputs={"Out": shadow.name})
            self._shadows.append((p, shadow))

    def apply(self, executor=None, need_restore: bool = True):
        """Swap the debiased EMA values into the parameters; a context
        manager that restores them on exit when ``need_restore``."""
        import contextlib

        import torch

        from paddle_tpu_torch.executor import global_scope

        scope = global_scope()
        correction = 1.0
        if self._step_var is not None:
            sv = scope.find_var(self._step_var.name)
            t = (float(torch.as_tensor(sv).reshape(-1)[0])
                 if sv is not None else 0.0)
            if t > 0:
                correction = 1.0 / (1.0 - self._decay ** t)
        for p, shadow in self._shadows:
            if need_restore:
                self._backup[p.name] = torch.as_tensor(
                    scope.find_var(p.name)).clone()
            sv = scope.find_var(shadow.name)
            if sv is not None:
                scope.set(p.name, torch.as_tensor(sv) * correction)

        @contextlib.contextmanager
        def _guard():
            try:
                yield
            finally:
                if need_restore:
                    self.restore()

        return _guard()

    def restore(self, executor=None):
        from paddle_tpu_torch.executor import global_scope

        scope = global_scope()
        for name, val in self._backup.items():
            scope.set(name, val)
        self._backup.clear()


class ModelAverage(Optimizer):
    """Placeholder for reference optimizer.py:2132, as in the JAX
    package: it takes the signature and appends nothing."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization, name)
