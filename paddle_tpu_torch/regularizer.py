"""Weight-decay regularizers (the JAX package's regularizer.py;
reference: python/paddle/fluid/regularizer.py). ``Optimizer.
apply_gradients`` calls ``append_regularization_ops`` after the gradient
clip: a parameter's own regularizer (``ParamAttr(regularizer=...)``)
wins over the optimizer's ``regularization``; each adds its decay term
to the gradient as graph ops."""

from __future__ import annotations


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff * param."""

    def __init__(self, regularization_coeff: float = 0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        from paddle_tpu_torch.layers import nn

        decay = nn.scale(param, scale=self._coeff)
        return nn.elementwise_add(grad, decay)


class L1DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff * sign(param), the sign as param / max(|param|,
    1e-12)."""

    def __init__(self, regularization_coeff: float = 0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        from paddle_tpu_torch.layers import nn

        sign = nn.elementwise_div(
            param, nn.elementwise_max(nn.abs(param),
                                      nn.fill_constant_like(param, 1e-12)))
        decay = nn.scale(sign, scale=self._coeff)
        return nn.elementwise_add(grad, decay)


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or regularization
        if reg is None or g is None:
            out.append((p, g))
            continue
        out.append((p, reg(p, g, p.block)))
    return out
