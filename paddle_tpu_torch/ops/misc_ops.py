"""Row partition and merge of ``IfElse`` (port of two ops of
``paddle_tpu/ops/misc_ops.py``: ``split_lod_tensor`` :158 and
``merge_lod_tensor`` :171; the rest of that module is not ported yet).

Reference: ``split_lod_tensor_op.cc``, ``merge_lod_tensor_op.cc``.  Both
keep the full batch, as the JAX package's dense lowering does: the split
masks the rows the condition does not select to zero, and the merge
selects each row from its branch.
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
