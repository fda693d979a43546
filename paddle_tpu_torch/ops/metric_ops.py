"""Metric kernels (port of part of ``paddle_tpu/ops/metric_ops.py``):
``edit_distance`` and ``auc``.  The file's other ops wait for a later
slice.

Reference semantics: ``edit_distance_op.cc`` (Levenshtein distance per
hypothesis/reference pair, optionally divided by the reference's
length), ``auc_op.cc`` (the bucketed ROC AUC over running StatPos /
StatNeg histograms).
"""

import torch

from .registry import register, first


@register("edit_distance", not_differentiable=True)
def edit_distance(ins, attrs):
    """Hyps [B, T1(, 1)] and Refs [B, T2(, 1)] with HypsLen and RefsLen.
    The DP runs a row of the padded [T1 + 1, T2 + 1] grid at a time for
    every pair at once: with a[j] = min(up[j] + 1, diag[j] + cost), the
    row is min over k <= j of a[k] + (j - k), i.e. j + cummin(a - j), so
    a row is a few tensor ops and no scalar loop.  Pair b's distance is
    the grid's [HypsLen_b, RefsLen_b] (cells past the lengths never reach
    it)."""
    hx = first(ins, "Hyps")
    hy = first(ins, "Refs")
    hx = hx.reshape(hx.shape[0], -1)
    hy = hy.reshape(hy.shape[0], -1)
    xl = first(ins, "HypsLen").reshape(-1).long()
    yl = first(ins, "RefsLen").reshape(-1).long()
    b, t1, t2 = hx.shape[0], hx.shape[1], hy.shape[1]
    j = torch.arange(t2 + 1, dtype=torch.float32, device=hx.device)
    row = j.expand(b, t2 + 1)
    rows = [row]
    for i in range(1, t1 + 1):
        cost = (hx[:, i - 1:i] != hy).to(torch.float32)       # [B, T2]
        a = torch.cat([torch.full((b, 1), float(i), device=hx.device),
                       torch.minimum(row[:, 1:] + 1, row[:, :-1] + cost)],
                      dim=1)
        row = torch.cummin(a - j, dim=1).values + j
        rows.append(row)
    grid = torch.stack(rows, dim=1)                        # [B, T1+1, T2+1]
    d = grid[torch.arange(b, device=hx.device), xl, yl]
    if attrs.get("normalized", False):
        d = d / torch.clamp_min(yl.to(torch.float32), 1.0)
    return {"Out": [d.reshape(-1, 1)],
            "SequenceNum": [torch.full((), b, dtype=torch.int64,
                                       device=hx.device)]}


@register("auc", not_differentiable=True)
def auc(ins, attrs):
    """Each prediction's class-1 probability picks a bucket of the
    histograms (floor(p · T), clipped to [0, T]); the AUC is the
    trapezoid area under the running totals' ROC, walked from the high
    threshold down, over positives × negatives (0 while either is 0)."""
    preds = first(ins, "Predict")
    labels = first(ins, "Label").reshape(-1)
    stat_pos, stat_neg = first(ins, "StatPos"), first(ins, "StatNeg")
    num_t = stat_pos.shape[0] - 1
    idx = torch.clamp((preds[:, -1] * num_t).to(torch.int32), 0,
                      num_t).long()
    pos = (labels > 0).to(stat_pos.dtype)
    stat_pos = stat_pos.index_add(0, idx, pos)
    stat_neg = stat_neg.index_add(0, idx, 1.0 - pos)
    zero = stat_pos.new_zeros(1)
    tp = torch.cat([zero, torch.cumsum(stat_pos.flip(0), 0)])
    fp = torch.cat([zero, torch.cumsum(stat_neg.flip(0), 0)])
    area = torch.sum((fp[1:] - fp[:-1]) * (tp[1:] + tp[:-1]) / 2.0)
    both = tp[-1] * fp[-1]
    auc_val = torch.where(both > 0, area / torch.clamp_min(both, 1.0),
                          torch.zeros_like(area))
    return {"AUC": [auc_val.reshape(())],
            "StatPosOut": [stat_pos], "StatNegOut": [stat_neg]}
