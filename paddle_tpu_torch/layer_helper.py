"""LayerHelper: shared machinery for layer functions."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.framework import (
    Variable,
    default_main_program,
    default_startup_program,
)
from paddle_tpu_torch.initializer import (
    ConstantInitializer,
    Initializer,
    XavierInitializer,
)
from paddle_tpu_torch.param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def append_op(self, *args, **kwargs):
        return self.block.append_op(*args, **kwargs)

    def create_variable_for_type_inference(self, dtype="float32", stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(self.name + ".tmp"),
            dtype=dtype,
            stop_gradient=stop_gradient,
        )

    def create_parameter(
        self,
        attr: Optional[ParamAttr],
        shape,
        dtype="float32",
        is_bias: bool = False,
        default_initializer: Optional[Initializer] = None,
    ):
        attr = ParamAttr._to_attr(attr)
        if attr is False or (attr is not None and attr.name is False):
            return None
        suffix = "b" if is_bias else "w"
        name = attr.name or unique_name.generate(f"{self.name}.{suffix}")
        init = attr.initializer or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()

        shape = [int(d) for d in shape]
        # Parameter lives in both programs: startup initializes, main uses.
        startup_block = self.startup_program.global_block()
        sp = startup_block.create_parameter(
            name,
            shape,
            dtype,
            initializer=init,
            regularizer=attr.regularizer,
            trainable=attr.trainable,
            optimize_attr={"learning_rate": attr.learning_rate},
        )
        init(sp, startup_block)
        mp = self.main_program.global_block().create_parameter(
            name,
            shape,
            dtype,
            regularizer=attr.regularizer,
            trainable=attr.trainable,
            optimize_attr={"learning_rate": attr.learning_rate},
        )
        return mp

    def append_bias_op(self, input_var: Variable, dim_start=1, dim_end=None):
        bias_attr = self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = input_var.shape[dim_start:dim_end] if input_var.shape else None
        b = self.create_parameter(
            ParamAttr._to_attr(bias_attr),
            shape=list(size) if size else [1],
            dtype=input_var.dtype,
            is_bias=True,
        )
        if b is None:
            return input_var
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            "elementwise_add",
            inputs={"X": input_var, "Y": b},
            outputs={"Out": out},
            attrs={"axis": dim_start},
        )
        return out

    def append_activation(self, input_var: Variable):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(act_type, inputs={"X": input_var}, outputs={"Out": out}, attrs=act)
        return out


def append_simple_op(op_type, inputs, attrs=None, out_slots=("Out",),
                     dtypes=None, name=None, stop_gradient=False):
    """Append one op whose outputs are fresh temp vars; returns the output
    var (or a tuple of them). A None input slot is left out; an output's
    dtype is ``dtypes[i]`` or else the first input's."""
    helper = LayerHelper(op_type, name=name)
    first = next(v for v in inputs.values() if v is not None)
    base = first[0] if isinstance(first, (list, tuple)) else first
    outs = {}
    for i, s in enumerate(out_slots):
        dt = (dtypes[i] if dtypes else None) or base.dtype
        outs[s] = helper.create_variable_for_type_inference(
            dtype=dt, stop_gradient=stop_gradient)
    helper.append_op(op_type,
                     inputs={k: v for k, v in inputs.items()
                             if v is not None},
                     outputs=outs, attrs=attrs or {})
    vals = [outs[s] for s in out_slots]
    return vals[0] if len(vals) == 1 else tuple(vals)
