"""Gradient clipping hook of ``Optimizer.apply_gradients`` (the JAX
package's clip.py). The clip classes (by value, norm, global norm) are
not ported yet; with no clip set, ``append_gradient_clip_ops`` returns
the pairs unchanged."""

from __future__ import annotations

from typing import Optional, Set

_clip_attr = None
_clip_param_names: Optional[Set[str]] = None


def set_gradient_clip(clip, param_list=None, program=None):
    """Install a gradient clip: an object whose ``process(params_grads)``
    returns the clipped pairs. ``param_list`` (names or Variables)
    restricts clipping to those parameters; None clips all."""
    global _clip_attr, _clip_param_names
    _clip_attr = clip
    _clip_param_names = None if param_list is None else {
        p if isinstance(p, str) else p.name for p in param_list}


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
