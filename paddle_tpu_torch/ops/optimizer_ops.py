"""Optimizer update kernels (port of ``paddle_tpu/ops/optimizer_ops.py``:
``sgd``, ``momentum``, ``lars_momentum``, ``adagrad``,
``decayed_adagrad``, ``adam``, ``adamax``, ``adadelta``, ``rmsprop``
(centered or not, with momentum), ``ftrl``, ``proximal_gd`` and
``proximal_adagrad``, :22-190, with the SelectedRows arms of ``sgd``,
``adagrad`` and ``adam``, :294-330).

Reference: ``paddle/fluid/operators/optimizers/`` — one kernel per rule.
Each returns the new state under the state var's own name (``ParamOut``
is the parameter's name), and the Executor stores persistable writes back
into the Scope: a new tensor, never an update in place.  All are
not_differentiable (terminal ops of the train step).
"""

import torch

from ..core.selected_rows import is_selected_rows
from .registry import register, first


def _lr(ins):
    lr = first(ins, "LearningRate")
    return lr.reshape(()) if lr.ndim else lr


@register("sgd", not_differentiable=True)
def sgd(ins, attrs):
    p, g = first(ins, "Param"), first(ins, "Grad")
    if is_selected_rows(g):
        # touched rows only; duplicate rows accumulate in the index_add
        return {"ParamOut": [p.index_add(
            0, g.rows, (-_lr(ins) * g.values).to(p.dtype))]}
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


@register("adagrad", not_differentiable=True)
def adagrad(ins, attrs):
    p, g, m = first(ins, "Param"), first(ins, "Grad"), first(ins, "Moment")
    eps = attrs.get("epsilon", 1e-6)
    lr = _lr(ins)
    if is_selected_rows(g):
        g = g.merged()        # square of the sum, not sum of squares, for dups
        vals = g.values.to(m.dtype)
        m_out = m.index_add(0, g.rows, vals * vals)
        upd = -lr * vals / (torch.sqrt(m_out[g.rows]) + eps)
        return {"ParamOut": [p.index_add(0, g.rows, upd.to(p.dtype))],
                "MomentOut": [m_out]}
    m_out = m + g * g
    return {"ParamOut": [p - lr * g / (torch.sqrt(m_out) + eps)],
            "MomentOut": [m_out]}


@register("adam", not_differentiable=True)
def adam(ins, attrs):
    """Adam with the reference's bias correction folded into the step
    size, lr·sqrt(1-β2^t)/(1-β1^t), and ε outside the square root.  A
    SelectedRows grad is densified unless ``lazy_mode`` is set (it is off
    by default, as in the reference); lazy mode advances only the
    touched rows' moments."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    if is_selected_rows(g):
        if attrs.get("lazy_mode", False):
            return _adam_lazy(ins, attrs, g)
        g = g.to_dense()
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


def _adam_lazy(ins, attrs, g):
    """Lazy Adam over a SelectedRows grad (the reference's lazy_mode=True):
    only the touched rows' moments and parameters advance."""
    p = first(ins, "Param")
    m1, m2 = first(ins, "Moment1"), first(ins, "Moment2")
    b1p = first(ins, "Beta1Pow").reshape(())
    b2p = first(ins, "Beta2Pow").reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins) * torch.sqrt(1 - b2p * b2) / (1 - b1p * b1)
    g = g.merged()
    rows, vals = g.rows, g.values.to(p.dtype)
    m1_rows = b1 * m1[rows] + (1 - b1) * vals
    m2_rows = b2 * m2[rows] + (1 - b2) * vals * vals
    # the reference's `.at[rows].add(new - old)`, kept for equal rounding
    m1_out = m1.index_add(0, rows, m1_rows - m1[rows])
    m2_out = m2.index_add(0, rows, m2_rows - m2[rows])
    upd = -lr * m1_out[rows] / (torch.sqrt(m2_out[rows]) + eps)
    return {"ParamOut": [p.index_add(0, rows, upd.to(p.dtype))],
            "Moment1Out": [m1_out], "Moment2Out": [m2_out],
            "Beta1PowOut": [(b1p * b1).reshape((1,))],
            "Beta2PowOut": [(b2p * b2).reshape((1,))]}


@register("lars_momentum", not_differentiable=True)
def lars_momentum(ins, attrs):
    """Momentum with the layer-wise rate lr · coeff · ‖p‖ / (‖g‖ + decay ·
    ‖p‖ + 1e-12) (You et al., 2017), weight decay inside the velocity."""
    p, g, v = first(ins, "Param"), first(ins, "Grad"), first(ins, "Velocity")
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = _lr(ins) * coeff * p_norm / (g_norm + decay * p_norm + 1e-12)
    v_out = mu * v + local_lr * (g + decay * p)
    return {"ParamOut": [p - v_out], "VelocityOut": [v_out]}


@register("decayed_adagrad", not_differentiable=True)
def decayed_adagrad(ins, attrs):
    p, g, m = first(ins, "Param"), first(ins, "Grad"), first(ins, "Moment")
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_out = decay * m + (1 - decay) * g * g
    return {"ParamOut": [p - _lr(ins) * g / (torch.sqrt(m_out) + eps)],
            "MomentOut": [m_out]}


@register("adamax", not_differentiable=True)
def adamax(ins, attrs):
    """Adam under the infinity norm: InfNorm = max(β2 · InfNorm, |g|),
    the step lr / (1 - β1^t) with Beta1Pow = β1^t (advanced by the
    optimizer's own ``scale`` op after this one)."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    m, inf = first(ins, "Moment"), first(ins, "InfNorm")
    b1p = first(ins, "Beta1Pow").reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = b1 * m + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf, torch.abs(g))
    lr = _lr(ins) / (1 - b1p)
    return {"ParamOut": [p - lr * m_out / (inf_out + eps)],
            "MomentOut": [m_out], "InfNormOut": [inf_out]}


@register("adadelta", not_differentiable=True)
def adadelta(ins, attrs):
    p, g = first(ins, "Param"), first(ins, "Grad")
    avg_sq = first(ins, "AvgSquaredGrad")
    avg_upd = first(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    sq_out = rho * avg_sq + (1 - rho) * g * g
    upd = -torch.sqrt((avg_upd + eps) / (sq_out + eps)) * g
    return {"ParamOut": [p + upd], "AvgSquaredGradOut": [sq_out],
            "AvgSquaredUpdateOut": [rho * avg_upd + (1 - rho) * upd * upd]}


@register("rmsprop", not_differentiable=True)
def rmsprop(ins, attrs):
    """RMSProp with momentum; ``centered`` divides by the variance
    estimate MeanSquare - MeanGrad² instead of MeanSquare."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    ms, mom = first(ins, "MeanSquare"), first(ins, "Moment")
    eps = attrs.get("epsilon", 1e-10)
    decay = attrs.get("decay", 0.9)
    mu = attrs.get("momentum", 0.0)
    lr = _lr(ins)
    ms_out = decay * ms + (1 - decay) * g * g
    if attrs.get("centered", False):
        mg_out = decay * first(ins, "MeanGrad") + (1 - decay) * g
        mom_out = mu * mom + lr * g / torch.sqrt(ms_out - mg_out * mg_out
                                                 + eps)
        return {"ParamOut": [p - mom_out], "MeanSquareOut": [ms_out],
                "MomentOut": [mom_out], "MeanGradOut": [mg_out]}
    mom_out = mu * mom + lr * g / torch.sqrt(ms_out + eps)
    return {"ParamOut": [p - mom_out], "MeanSquareOut": [ms_out],
            "MomentOut": [mom_out]}


@register("ftrl", not_differentiable=True)
def ftrl(ins, attrs):
    """FTRL-proximal (McMahan et al., 2013) with an l1/l2 penalty and the
    rate power ``lr_power`` (-0.5: the square root)."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    sq = first(ins, "SquaredAccumulator")
    lin = first(ins, "LinearAccumulator")
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq + g * g
    if lr_power == -0.5:
        root_new, root_old = torch.sqrt(new_sq), torch.sqrt(sq)
    else:
        root_new = torch.pow(new_sq, -lr_power)
        root_old = torch.pow(sq, -lr_power)
    lin_out = lin + g - (root_new - root_old) / lr * p
    l1t = torch.full((), l1, dtype=lin_out.dtype, device=lin_out.device)
    pre = torch.minimum(torch.maximum(lin_out, -l1t), l1t) - lin_out
    return {"ParamOut": [pre / (root_new / lr + 2 * l2)],
            "SquaredAccumOut": [new_sq], "LinearAccumOut": [lin_out]}


def _proximal(prox, lr, l1, l2):
    return torch.sign(prox) * torch.clamp_min(
        torch.abs(prox) - lr * l1, 0.0) / (1.0 + lr * l2)


@register("proximal_gd", not_differentiable=True)
def proximal_gd(ins, attrs):
    p, g = first(ins, "Param"), first(ins, "Grad")
    lr = _lr(ins)
    return {"ParamOut": [_proximal(p - lr * g, lr, attrs.get("l1", 0.0),
                                   attrs.get("l2", 0.0))]}


@register("proximal_adagrad", not_differentiable=True)
def proximal_adagrad(ins, attrs):
    p, g, m = first(ins, "Param"), first(ins, "Grad"), first(ins, "Moment")
    m_out = m + g * g
    eff_lr = _lr(ins) / torch.sqrt(m_out)
    return {"ParamOut": [_proximal(p - eff_lr * g, eff_lr,
                                   attrs.get("l1", 0.0),
                                   attrs.get("l2", 0.0))],
            "MomentOut": [m_out]}
