"""Loss kernels (port of part of ``paddle_tpu/ops/loss_ops.py``):
``cos_sim``, the recommender's score.  The file's other ops wait for a
later slice of the port.

Reference op semantics: ``cos_sim_op.h``.
"""

import torch

from .registry import register, first


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
