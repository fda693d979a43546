"""Optimizer update kernels (port of ``paddle_tpu/ops/optimizer_ops.py``:
``sgd``, ``momentum``, ``adagrad`` and ``adam``, with the SelectedRows
arms of ``sgd``, ``adagrad`` and ``adam``, :294-330).

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
