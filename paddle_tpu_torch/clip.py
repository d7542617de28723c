"""Gradient clipping (the JAX package's clip.py; reference:
python/paddle/fluid/clip.py). ``set_gradient_clip`` installs a clip that
``Optimizer.apply_gradients`` applies to the (parameter, gradient) pairs
before weight decay, as graph ops: by value, by each gradient's L2 norm,
or by the joint L2 norm of all of them. The JAX package also registers
the global norm and its scale with its numerics plane; that plane
(numerics.py) is not ported, so nothing is registered here."""

from __future__ import annotations

from typing import Optional, Set


class BaseGradientClipAttr:
    def process(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    """Each gradient element clipped into [min, max] (min = -max when
    None)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def process(self, params_grads):
        from paddle_tpu_torch.layers import nn

        return [
            (p, nn.clip(g, self.min, self.max) if g is not None else None)
            for p, g in params_grads
        ]


class GradientClipByNorm(BaseGradientClipAttr):
    """Each gradient scaled to L2 norm ``clip_norm`` where its norm
    exceeds it (the ``clip_by_norm`` op)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def process(self, params_grads):
        from paddle_tpu_torch.layers import nn

        return [
            (p, nn.clip_by_norm(g, self.clip_norm) if g is not None else None)
            for p, g in params_grads
        ]


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scale all gradients by clip_norm / max(global_norm, clip_norm), so
    their joint L2 norm stays under ``clip_norm``. ``global_norm_name``
    and ``scale_name`` name the vars of the latest ``process`` call (one
    a program build), which a caller may fetch."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)
        self.global_norm_name = None
        self.scale_name = None

    def process(self, params_grads):
        from paddle_tpu_torch.layer_helper import LayerHelper
        from paddle_tpu_torch.layers import nn, tensor

        helper = LayerHelper("global_norm_clip")
        sq_norms = []
        for _, g in params_grads:
            if g is None:
                continue
            out = helper.create_variable_for_type_inference(dtype=g.dtype)
            helper.append_op("squared_l2_norm", inputs={"X": g},
                             outputs={"Out": out})
            sq_norms.append(out)
        if not sq_norms:
            return params_grads
        total = nn.sums(sq_norms)
        global_norm = nn.sqrt(total)
        clip_v = tensor.fill_constant([1], "float32", self.clip_norm)
        scale = nn.elementwise_div(
            clip_v, nn.elementwise_max(global_norm, clip_v))
        self.global_norm_name = global_norm.name
        self.scale_name = scale.name
        return [
            (p, nn.elementwise_mul(g, scale) if g is not None else None)
            for p, g in params_grads
        ]


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max


_clip_attr: Optional[BaseGradientClipAttr] = None
_clip_param_names: Optional[Set[str]] = None


def set_gradient_clip(clip: BaseGradientClipAttr, param_list=None,
                      program=None):
    """Install a gradient clip. ``param_list`` (names or Variables)
    restricts clipping to those parameters; None clips all."""
    global _clip_attr, _clip_param_names
    _clip_attr = clip
    _clip_param_names = None if param_list is None else {
        p if isinstance(p, str) else p.name for p in param_list}


def has_clip_attr() -> bool:
    return _clip_attr is not None


def clip_applies_to(param_name: str) -> bool:
    """Whether the installed gradient clip covers this parameter
    (set_gradient_clip may scope to an explicit param_list)."""
    if _clip_attr is None:
        return False
    return _clip_param_names is None or param_name in _clip_param_names


def append_gradient_clip_ops(params_grads):
    if _clip_attr is None:
        return params_grads
    if _clip_param_names is None:
        return _clip_attr.process(params_grads)
    selected = [(p, g) for p, g in params_grads
                if p.name in _clip_param_names]
    untouched = [(p, g) for p, g in params_grads
                 if p.name not in _clip_param_names]
    return _clip_attr.process(selected) + untouched
