"""Weight-decay hook of ``Optimizer.apply_gradients`` (the JAX package's
regularizer.py). The decay classes are not ported yet; a parameter or
optimizer regularizer is any callable ``reg(param, grad, block)`` that
returns the new gradient var. With none set, the pairs pass unchanged."""

from __future__ import annotations


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or regularization
        if reg is None or g is None:
            out.append((p, g))
            continue
        out.append((p, reg(p, g, p.block)))
    return out
