"""Optimizer update ops (reference kernels: paddle/fluid/operators/
optimizers/{sgd_op.cc, momentum_op.cc, lars_momentum_op.cc, adam_op.cc,
adagrad_op.cc, decayed_adagrad_op.cc, rmsprop_op.cc, lamb_op.cc,
ftrl_op.cc, adamax_op.cc, adadelta_op.cc}). Updates are functional: the
op returns the new parameter and accumulator values under the same
variable names, and the executor commits them to the scope (in place
into the Scope's tensors in a captured step, core/lowering.py). Each
follows the JAX package's op arithmetic, step for step."""

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


@register_op("momentum", no_grad=True)
def _momentum(ins, attrs, device):
    """v' = mu * v + g; p' = p - lr * v', or with ``use_nesterov``
    p' = p - (g + mu * v') * lr."""
    p, g, v = _g(ins, "Param"), _g(ins, "Grad"), _g(ins, "Velocity")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    mu = attrs.get("mu", 0.9)
    g = g.to(p.dtype)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": [p_new], "VelocityOut": [v_new]}


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


@register_op("lars_momentum", no_grad=True)
def _lars_momentum(ins, attrs, device):
    """Momentum with a layer-wise rate lr * coeff * |p| / (|g| + decay |p|)
    where both norms are positive, else lr."""
    p, g, v = _g(ins, "Param"), _g(ins, "Grad"), _g(ins, "Velocity")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    g = g.to(p.dtype)
    pn = torch.sqrt(torch.sum(torch.square(p)))
    gn = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = torch.where((pn > 0) & (gn > 0),
                           lr * coeff * pn / (gn + decay * pn + 1e-12), lr)
    v_new = mu * v + local_lr * (g + decay * p)
    return {"ParamOut": [p - v_new], "VelocityOut": [v_new]}


@register_op("adamw", no_grad=True)
def _adamw(ins, attrs, device):
    """Adam, then the decoupled decay p -= lr * weight_decay * p (of the
    parameter before the step)."""
    p = _g(ins, "Param")
    wd = attrs.get("weight_decay", 0.01)
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    outs = _adam(ins, attrs, device)
    outs["ParamOut"][0] = outs["ParamOut"][0] - lr * wd * p
    return outs


@register_op("adagrad", no_grad=True)
def _adagrad(ins, attrs, device):
    p, g, m = _g(ins, "Param"), _g(ins, "Grad"), _g(ins, "Moment")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    eps = attrs.get("epsilon", 1e-6)
    g = g.to(p.dtype)
    m_new = m + torch.square(g)
    p_new = p - lr * g / (torch.sqrt(m_new) + eps)
    return {"ParamOut": [p_new], "MomentOut": [m_new]}


@register_op("rmsprop", no_grad=True)
def _rmsprop(ins, attrs, device):
    p, g = _g(ins, "Param"), _g(ins, "Grad")
    ms, mom = _g(ins, "MeanSquare"), _g(ins, "Moment")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    g = g.to(p.dtype)
    ms_new = rho * ms + (1 - rho) * torch.square(g)
    if attrs.get("centered", False):
        mg = _g(ins, "MeanGrad")
        mg_new = rho * mg + (1 - rho) * g
        denom = ms_new - torch.square(mg_new) + eps
        mom_new = mu * mom + lr * g / torch.sqrt(denom)
        return {
            "ParamOut": [p - mom_new],
            "MeanSquareOut": [ms_new],
            "MomentOut": [mom_new],
            "MeanGradOut": [mg_new],
        }
    mom_new = mu * mom + lr * g / torch.sqrt(ms_new + eps)
    return {
        "ParamOut": [p - mom_new],
        "MeanSquareOut": [ms_new],
        "MomentOut": [mom_new],
    }


@register_op("lamb", no_grad=True)
def _lamb(ins, attrs, device):
    """Adam's moments, bias-corrected by the beta powers before this
    step, plus weight_decay * p; the step scaled by the trust ratio
    |p| / |r| where both norms are positive, else 1."""
    p, g = _g(ins, "Param"), _g(ins, "Grad")
    m1, m2 = _g(ins, "Moment1"), _g(ins, "Moment2")
    b1p, b2p = _g(ins, "Beta1Pow"), _g(ins, "Beta2Pow")
    lr = _g(ins, "LearningRate").reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    g = g.to(m1.dtype)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    mhat = m1n / (1 - b1p.reshape(()))
    vhat = m2n / (1 - b2p.reshape(()))
    r = mhat / (torch.sqrt(vhat) + eps) + wd * p.to(m1.dtype)
    pn = torch.sqrt(torch.sum(torch.square(p.float())))
    rn = torch.sqrt(torch.sum(torch.square(r.float())))
    trust = torch.where((pn > 0) & (rn > 0), pn / rn, 1.0)
    p_new = p - (lr * trust).to(p.dtype) * r.to(p.dtype)
    return {
        "ParamOut": [p_new],
        "Moment1Out": [m1n],
        "Moment2Out": [m2n],
        "Beta1PowOut": [b1p * b1],
        "Beta2PowOut": [b2p * b2],
    }


@register_op("ftrl", no_grad=True)
def _ftrl(ins, attrs, device):
    p, g = _g(ins, "Param"), _g(ins, "Grad")
    sq, lin = _g(ins, "SquaredAccumulator"), _g(ins, "LinearAccumulator")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    g = g.to(p.dtype)
    sq_new = sq + torch.square(g)
    sigma = (sq_new ** -power - sq ** -power) / lr
    lin_new = lin + g - sigma * p
    pre = torch.clamp(lin_new, -l1, l1) - lin_new
    denom = sq_new ** -power / lr + 2 * l2
    return {
        "ParamOut": [pre / denom],
        "SquaredAccumOut": [sq_new],
        "LinearAccumOut": [lin_new],
    }


@register_op("decayed_adagrad", no_grad=True)
def _decayed_adagrad(ins, attrs, device):
    p, g, m = _g(ins, "Param"), _g(ins, "Grad"), _g(ins, "Moment")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g = g.to(p.dtype)
    m_new = decay * m + (1 - decay) * torch.square(g)
    return {"ParamOut": [p - lr * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


@register_op("adamax", no_grad=True)
def _adamax(ins, attrs, device):
    """Adam with an infinity-norm second moment."""
    p, g = _g(ins, "Param"), _g(ins, "Grad")
    m, u = _g(ins, "Moment"), _g(ins, "InfNorm")
    b1p = _g(ins, "Beta1Pow")
    lr = _g(ins, "LearningRate").reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    g = g.to(m.dtype)
    m_new = b1 * m + (1 - b1) * g
    u_new = torch.maximum(b2 * u, torch.abs(g))
    b1pn = b1p * b1
    lr_t = (lr / (1 - b1pn.reshape(()))).to(p.dtype)
    p_new = p - lr_t * (m_new / (u_new + eps)).to(p.dtype)
    return {"ParamOut": [p_new], "MomentOut": [m_new],
            "InfNormOut": [u_new], "Beta1PowOut": [b1pn]}


@register_op("adadelta", no_grad=True)
def _adadelta(ins, attrs, device):
    """The learning-rate-free rule: the step from the running squared
    gradient and the running squared step."""
    p, g = _g(ins, "Param"), _g(ins, "Grad")
    eg2, edx2 = _g(ins, "AvgSquaredGrad"), _g(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g = g.to(p.dtype)
    eg2_new = rho * eg2 + (1 - rho) * torch.square(g)
    upd = -torch.sqrt((edx2 + eps) / (eg2_new + eps)) * g
    edx2_new = rho * edx2 + (1 - rho) * torch.square(upd)
    return {"ParamOut": [p + upd], "AvgSquaredGradOut": [eg2_new],
            "AvgSquaredUpdateOut": [edx2_new]}
