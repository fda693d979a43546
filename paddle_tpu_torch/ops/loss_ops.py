"""Loss, ranking and similarity kernels (port of
``paddle_tpu/ops/loss_ops.py``): ``cos_sim``, the recommender's score,
and the losses the front end's layers emit — ``sign`` ... ``nce``.

Reference semantics: ``paddle/fluid/operators/`` — ``sign_op.cc``,
``log_loss_op.h``, ``hinge_loss_op.h``, ``rank_loss_op.cc``
(C = -P·(o_l - o_r) + log(1 + e^(o_l - o_r))), ``margin_rank_loss_op.h``,
``modified_huber_loss_op.h``, ``huber_loss_op.h``, ``kldiv_loss_op.h``,
``squared_l2_distance_op.h``, ``cos_sim_op.h``, ``bpr_loss_op.h``
(loss_i = 1/(C-1) · sum_{j != label} log(1 + exp(x_j - x_label))),
``bilinear_tensor_product_op.h``,
``teacher_student_sigmoid_loss_op.cc``, ``nce_op.h``.

A ``max(·, 0)`` here is :func:`math_ops.tie_max`, whose gradient splits
a tie in half as the JAX package's ``jnp.maximum`` does, and an ``|·|``
:func:`math_ops.tie_abs`, whose derivative at 0 is 1 as ``jnp.abs``'s.
``nce`` draws its negative classes in the op from the op's Philox stream
(``registry.uniforms``), as the JAX package draws them in the graph:
the same ids on the CPU and the card, other ids than the JAX package's.
"""

import torch

from .math_ops import tie_abs, tie_clip, tie_max
from .registry import register, first, as_out, op_seed, uniforms


def _softplus(x):
    """log(1 + e^x) as the reference writes it: log1p(e^-|x|) + max(x, 0)."""
    return torch.log1p(torch.exp(-tie_abs(x))) + tie_max(x, 0.0)


@register("sign")
def sign(ins, attrs):
    return as_out(torch.sign(first(ins, "X")))


@register("log_loss")
def log_loss(ins, attrs):
    pred = first(ins, "Predicted")
    label = first(ins, "Labels")
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-label * torch.log(pred + eps)
                     - (1.0 - label) * torch.log(1.0 - pred + eps)]}


@register("hinge_loss")
def hinge_loss(ins, attrs):
    """max(0, 1 - (2·label - 1)·logit): labels in {0, 1}."""
    logits = first(ins, "Logits")
    labels = first(ins, "Labels")
    return {"Loss": [tie_max(1.0 - (2.0 * labels - 1.0) * logits, 0.0)]}


@register("rank_loss")
def rank_loss(ins, attrs):
    o = first(ins, "Left") - first(ins, "Right")
    return as_out(-first(ins, "Label") * o + _softplus(o))


@register("margin_rank_loss")
def margin_rank_loss(ins, attrs):
    label = first(ins, "Label")
    out = tie_max(-label * (first(ins, "X1") - first(ins, "X2"))
                  + attrs.get("margin", 0.0), 0.0)
    return {"Out": [out], "Activated": [(out > 0).to(out.dtype)]}


@register("modified_huber_loss")
def modified_huber_loss(ins, attrs):
    z = first(ins, "X") * (2.0 * first(ins, "Y") - 1.0)
    loss = torch.where(z < -1.0, -4.0 * z,
                       torch.square(tie_max(1.0 - z, 0.0)))
    return {"Out": [loss], "IntermediateVal": [z]}


@register("huber_loss")
def huber_loss(ins, attrs):
    delta = attrs.get("delta", 1.0)
    r = first(ins, "Y") - first(ins, "X")
    ar = tie_abs(r)
    loss = torch.where(ar <= delta, 0.5 * torch.square(r),
                       delta * (ar - 0.5 * delta))
    return {"Out": [loss], "Residual": [r]}


@register("kldiv_loss")
def kldiv_loss(ins, attrs):
    """target · (log target - X), 0 where target <= 0, reduced by
    ``reduction`` (mean, sum, batchmean or none)."""
    x = first(ins, "X")
    target = first(ins, "Target")
    loss = target * (torch.log(tie_max(target, 1e-12)) - x)
    loss = torch.where(target <= 0, torch.zeros_like(loss), loss)
    reduction = attrs.get("reduction", "mean")
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    elif reduction == "batchmean":
        loss = loss.sum() / x.shape[0]
    return {"Loss": [loss]}


@register("squared_l2_distance")
def squared_l2_distance(ins, attrs):
    sub = first(ins, "X") - first(ins, "Y")
    out = torch.square(sub.reshape(sub.shape[0], -1)).sum(dim=1,
                                                          keepdim=True)
    return {"Out": [out], "sub_result": [sub]}


@register("cos_sim")
def cos_sim(ins, attrs):
    """Row-wise cosine of X and Y [N, ...] -> Out [N, 1], with the norms
    XNorm and YNorm [N, 1]; the norms' product is floored at 1e-12."""
    x = first(ins, "X")
    y = first(ins, "Y")
    x2 = x.reshape(x.shape[0], -1)
    y2 = y.reshape(y.shape[0], -1)
    xn = torch.sqrt(torch.sum(torch.square(x2), dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y2), dim=1, keepdim=True))
    out = torch.sum(x2 * y2, dim=1, keepdim=True) / \
        torch.clamp_min(xn * yn, 1e-12)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register("bpr_loss")
def bpr_loss(ins, attrs):
    x = first(ins, "X")                          # [N, C] logits
    c = x.shape[-1]
    lbl = first(ins, "Label").reshape(-1).long()
    pos = torch.gather(x, -1, lbl[:, None])      # [N, 1]
    terms = _softplus(x - pos)
    mask = torch.nn.functional.one_hot(lbl, c).to(x.dtype)
    return {"Y": [(terms * (1.0 - mask)).sum(dim=-1, keepdim=True)
                  / (c - 1)]}


@register("bilinear_tensor_product")
def bilinear_tensor_product(ins, attrs):
    """out[n, o] = x[n] · W[o] · y[n] (+ Bias [1, O])."""
    x, y, w = first(ins, "X"), first(ins, "Y"), first(ins, "Weight")
    bias = first(ins, "Bias")
    out = torch.einsum("nm,omk,nk->no", x, w, y)
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return as_out(out)


@register("teacher_student_sigmoid_loss")
def teacher_student_sigmoid_loss(ins, attrs):
    """The hard label's cross entropy (label > 0.5 counts as 1) plus the
    teacher score's, on the logit clipped to the soft bounds."""
    x = first(ins, "X")
    label = first(ins, "Label")
    hard = (label > 0.5).to(x.dtype)
    z = tie_clip(x, attrs.get("soft_max_lower_bound", -15.0),
                 attrs.get("soft_max_up_bound", 15.0))
    return {"Y": [-hard * x + _softplus(x) - label * z + _softplus(z)]}


# Philox stream tag of nce's negative classes (registry.uniforms)
_TAG_NCE = 2


@register("nce")
def nce(ins, attrs):
    """Noise-contrastive estimation with uniform noise (nce_op.h, dense):
    Input [N, D], Label [N, T], Weight [V, D], optional Bias [V];
    ``num_neg_samples`` negative classes a row drawn uniformly from
    [0, ``num_total_classes``).  Cost [N, 1], SampleLogits and
    SampleLabels [N, T + num_neg] (the true classes first)."""
    import math

    x = first(ins, "Input")
    label = first(ins, "Label")
    w = first(ins, "Weight")
    b = first(ins, "Bias")
    num_neg = attrs.get("num_neg_samples", 10)
    num_total = attrs.get("num_total_classes", w.shape[0])
    n = x.shape[0]
    t = label.shape[-1] if label.ndim > 1 else 1
    lbl = label.reshape(n, t).long()
    u = uniforms(op_seed(attrs), (n, num_neg), x.device, _TAG_NCE)
    neg = (u * num_total).long().clamp_max(num_total - 1)

    def logits_for(ids):
        lg = torch.einsum("nd,nkd->nk", x, w[ids])
        return lg + b.reshape(-1)[ids] if b is not None else lg

    pos_logit, neg_logit = logits_for(lbl), logits_for(neg)
    log_noise = math.log(num_neg / num_total)
    cost = torch.log1p(torch.exp(log_noise - pos_logit)).sum(
        dim=-1, keepdim=True) + torch.log1p(
        torch.exp(neg_logit - log_noise)).sum(dim=-1, keepdim=True)
    return {"Cost": [cost],
            "SampleLogits": [torch.cat([pos_logit, neg_logit], -1)],
            "SampleLabels": [torch.cat([lbl, neg], -1)]}
