"""Port of part of ``paddle_tpu/ops/misc_ops.py``: the row partition and
merge of ``IfElse`` (``split_lod_tensor`` :158, ``merge_lod_tensor``
:171), ``add_position_encoding`` (:18), ``mean_iou`` (:40) and
ModelAverage's ``average_accumulates`` (the registration that wins in
the reference, :297).  The rest of that module waits for a later slice
(ROADMAP queue 1 item 13).

Reference: ``split_lod_tensor_op.cc``, ``merge_lod_tensor_op.cc``,
``add_position_encoding_op.h``, ``mean_iou_op.cc``,
``average_accumulates_op.h``.  The split and the merge keep the full
batch, as the JAX package's dense lowering does: the split masks the
rows the condition does not select to zero, and the merge selects each
row from its branch.
"""

import torch

from .registry import register, first, as_out


def _row_mask(mask, x):
    m = mask.reshape(-1).to(torch.bool)
    return m.reshape((-1,) + (1,) * (x.dim() - 1))


@register("split_lod_tensor", not_differentiable=True)
def split_lod_tensor(ins, attrs):
    x = first(ins, "X")
    m = _row_mask(first(ins, "Mask"), x)
    zeros = torch.zeros_like(x)
    return {"OutTrue": [torch.where(m, x, zeros)],
            "OutFalse": [torch.where(m, zeros, x)]}


@register("merge_lod_tensor")
def merge_lod_tensor(ins, attrs):
    x_true = first(ins, "InTrue")
    x_false = first(ins, "InFalse")
    m = _row_mask(first(ins, "Mask"), x_true)
    return as_out(torch.where(m, x_true, x_false))


@register("add_position_encoding")
def add_position_encoding(ins, attrs):
    """alpha · x + beta · PE for x [B, T, D], PE[t] the concatenation of
    sin(t / div) and cos(t / div), div_k = 10000^(k / (D/2 - 1))."""
    x = first(ins, "X")
    alpha, beta = attrs.get("alpha", 1.0), attrs.get("beta", 1.0)
    _, t, d = x.shape
    if d % 2:
        raise ValueError(
            f"add_position_encoding requires an even feature dim, got {d} "
            "(the sin/cos halves must tile it exactly — "
            "add_position_encoding_op.h)")
    half = d // 2
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    div = torch.pow(10000.0, torch.arange(half, dtype=torch.float32,
                                          device=x.device) / max(half - 1, 1))
    pe = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    return as_out(alpha * x + beta * pe[None].to(x.dtype))


@register("mean_iou", not_differentiable=True)
def mean_iou(ins, attrs):
    """The mean over present classes of intersection / union of the
    predicted and the true class ids, with each class's wrong and correct
    counts."""
    pred = first(ins, "Predictions").reshape(-1).long()
    label = first(ins, "Labels").reshape(-1).long()
    c = int(attrs["num_classes"])
    hit = pred == label
    zeros = torch.zeros(c, dtype=torch.float32, device=pred.device)
    inter = zeros.index_add(0, torch.where(hit, pred, c - 1),
                            hit.to(torch.float32))
    ones = torch.ones(pred.shape, dtype=torch.float32, device=pred.device)
    pred_cnt = zeros.index_add(0, pred, ones)
    label_cnt = zeros.index_add(0, label, ones)
    union = pred_cnt + label_cnt - inter
    present = union > 0
    iou = torch.where(present, inter / torch.clamp_min(union, 1.0), zeros)
    miou = iou.sum() / torch.clamp_min(present.to(torch.float32).sum(), 1.0)
    return {"OutMeanIou": [miou.reshape(())],
            "OutWrong": [(label_cnt - inter).to(torch.int32)],
            "OutCorrect": [inter.to(torch.int32)]}


# average_accumulates_op.h's kMaxNumAccumulates: every this many updates
# sum_1 drains into sum_2, which keeps the float sums' precision
_MAX_NUM_ACCUMULATES = 16384


@register("average_accumulates", not_differentiable=True)
def average_accumulates(ins, attrs):
    """ModelAverage's sliding window (average_accumulates_op.h:80-106):
    sum_1 += Param each step; every 16384 updates sum_1 drains into
    sum_2; when the window reaches both min_average_window and
    min(max_average_window, floor(num_updates · average_window)) the sums
    fold into sum_3 and the window restarts.  The product is truncated to
    an integer before the compare (7 updates at rate 0.25 give a limit of
    1, not 1.75).  The counters run as int32, as in the JAX package, and
    every branch is a select on the device: no host read, so a captured
    step keeps the op."""
    param = first(ins, "Param")
    s1, s2, s3 = (first(ins, n) for n in ("InSum1", "InSum2", "InSum3"))
    num_acc, old_acc, num_upd = (
        first(ins, n).reshape(()).to(torch.int32)
        for n in ("InNumAccumulates", "InOldNumAccumulates",
                  "InNumUpdates"))
    window = attrs["average_window"]
    min_w = int(attrs["min_average_window"])
    max_w = min(int(attrs["max_average_window"]), 2**31 - 1)

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    s1 = s1 + param.to(s1.dtype)
    drain = torch.remainder(num_upd, _MAX_NUM_ACCUMULATES) == 0
    zeros = torch.zeros_like(s1)
    s2 = torch.where(drain, s2 + s1, s2)
    s1 = torch.where(drain, zeros, s1)
    limit = torch.clamp_max(
        torch.floor(num_upd.to(torch.float32) * window).to(torch.int32),
        max_w)
    close = (num_acc >= min_w) & (num_acc >= limit)
    s3 = torch.where(close, s1 + s2, s3)
    s1 = torch.where(close, zeros, s1)
    s2 = torch.where(close, zeros, s2)
    old_acc = torch.where(close, num_acc, old_acc)
    num_acc = torch.where(close, torch.zeros_like(num_acc), num_acc)
    return {"OutSum1": [s1], "OutSum2": [s2], "OutSum3": [s3],
            "OutNumAccumulates": [num_acc.reshape(1)],
            "OutOldNumAccumulates": [old_acc.reshape(1)],
            "OutNumUpdates": [num_upd.reshape(1)]}
