"""Optimizer update kernels (port of ``paddle_tpu/ops/optimizer_ops.py``,
the dense ``sgd``, ``momentum`` and ``adam`` rules).

Reference: ``paddle/fluid/operators/optimizers/`` — one kernel per rule.
Each returns the new state under the state var's own name (``ParamOut``
is the parameter's name), and the Executor stores persistable writes back
into the Scope: a new tensor, never an update in place.  All are
not_differentiable (terminal ops of the train step).
"""

import torch

from .registry import register, first


def _lr(ins):
    lr = first(ins, "LearningRate")
    return lr.reshape(()) if lr.ndim else lr


@register("sgd", not_differentiable=True)
def sgd(ins, attrs):
    p, g = first(ins, "Param"), first(ins, "Grad")
    return {"ParamOut": [p - _lr(ins) * g.to(p.dtype)]}


@register("momentum", not_differentiable=True)
def momentum(ins, attrs):
    p, g, v = first(ins, "Param"), first(ins, "Grad"), first(ins, "Velocity")
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@register("adam", not_differentiable=True)
def adam(ins, attrs):
    """Adam with the reference's bias correction folded into the step
    size, lr·sqrt(1-β2^t)/(1-β1^t), and ε outside the square root."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    m1, m2 = first(ins, "Moment1"), first(ins, "Moment2")
    b1p = first(ins, "Beta1Pow").reshape(())
    b2p = first(ins, "Beta2Pow").reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins) * torch.sqrt(1 - b2p * b2) / (1 - b1p * b1)
    g = g.to(p.dtype)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g * g
    p_out = p - lr * m1_out / (torch.sqrt(m2_out) + eps)
    return {"ParamOut": [p_out], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out],
            "Beta1PowOut": [(b1p * b1).reshape((1,))],
            "Beta2PowOut": [(b2p * b2).reshape((1,))]}
