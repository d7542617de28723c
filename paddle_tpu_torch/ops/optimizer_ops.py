"""Optimizer update ops (reference kernels: paddle/fluid/operators/
optimizers/{sgd_op.cc, adam_op.cc}). Updates are functional: the op
returns the new parameter and accumulator values under the same
variable names, and the executor commits them to the scope."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op


def _g(ins, slot):
    v = ins.get(slot)
    return v[0] if v else None


@register_op("sgd", no_grad=True)
def _sgd(ins, attrs, device):
    p, g, lr = _g(ins, "Param"), _g(ins, "Grad"), _g(ins, "LearningRate")
    return {"ParamOut": [p - lr.reshape(()).to(p.dtype) * g.to(p.dtype)]}


@register_op("adam", no_grad=True)
def _adam(ins, attrs, device):
    p, g = _g(ins, "Param"), _g(ins, "Grad")
    m1, m2 = _g(ins, "Moment1"), _g(ins, "Moment2")
    b1p, b2p = _g(ins, "Beta1Pow"), _g(ins, "Beta2Pow")
    lr = _g(ins, "LearningRate").reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    g = g.to(m1.dtype)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    b1pn, b2pn = b1p * b1, b2p * b2
    lr_t = lr * torch.sqrt(1 - b2pn.reshape(())) / (1 - b1pn.reshape(()))
    upd = lr_t.to(p.dtype) * (m1n / (torch.sqrt(m2n) + eps)).to(p.dtype)
    return {
        "ParamOut": [p - upd],
        "Moment1Out": [m1n],
        "Moment2Out": [m2n],
        "Beta1PowOut": [b1pn],
        "Beta2PowOut": [b2pn],
    }
