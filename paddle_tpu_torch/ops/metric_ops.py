"""Metric kernels (port of part of ``paddle_tpu/ops/metric_ops.py``):
``edit_distance``.  The file's other ops wait for a later slice.

Reference semantics: ``edit_distance_op.cc`` (Levenshtein distance per
hypothesis/reference pair, optionally divided by the reference's
length).
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
