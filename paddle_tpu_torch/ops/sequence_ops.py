"""Sequence (LoD) kernels over the dense + lengths representation (port
of part of ``paddle_tpu/ops/sequence_ops.py``): ``sequence_pool`` (every
pool type, lod-2 included), ``sequence_softmax``, ``sequence_mask``,
``sequence_expand`` and ``sequence_expand_as``.  The file's other ops
wait for a later slice of the port.

Every lod tensor is padded dense [B, T, ...] plus an int32 ``SeqLen``
input [B]; masking is done with tensor ops.  Ops whose output lengths
differ from the input emit an ``OutLen`` slot that the layer wires to the
output's ``@SEQ_LEN`` companion variable.

``sequence_softmax`` runs the hand-written masked-softmax kernel K7
(``ops/sequence_kernels.py``) on a CUDA tensor at every T, and its plain
version on a CPU tensor.
"""

import torch

from . import sequence_kernels
from .registry import register, first, as_out, torch_dtype
from .sequence_kernels import length_mask


def _expand_mask(m, x):
    """[B, T] mask -> broadcastable to x's [B, T, ...]."""
    return m.reshape(tuple(m.shape) + (1,) * (x.dim() - 2))


def _lowest(dtype):
    return torch.finfo(dtype).min if dtype.is_floating_point \
        else torch.iinfo(dtype).min


@register("sequence_pool")
def sequence_pool(ins, attrs):
    x = first(ins, "X")                  # [B, T, ...]
    lens = first(ins, "SeqLen")          # [B]
    lens2 = first(ins, "SeqLen2")        # lod_level=L: innermost lengths
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    if lens2 is not None:
        # multi-level lod: pool the INNERMOST level.  lens2's shape equals
        # x's leading dims ([B, S1.., T, feat..] -> [B, S1.., feat..])
        lead = tuple(x.shape[:lens2.dim()])
        flat = x.reshape((-1,) + tuple(x.shape[lens2.dim():]))
        out = sequence_pool({"X": [flat], "SeqLen": [lens2.reshape(-1)]},
                            dict(attrs))
        return {k: [v[0].reshape(lead + tuple(v[0].shape[1:]))]
                for k, v in out.items()}
    t = x.shape[1]
    m = _expand_mask(length_mask(lens, t, x.dtype), x)
    denom = lens.clamp_min(1).to(x.dtype).reshape(
        (-1,) + (1,) * (x.dim() - 2))
    if ptype == "SUM":
        out = (x * m).sum(dim=1)
    elif ptype == "AVERAGE":
        out = (x * m).sum(dim=1) / denom
    elif ptype == "SQRT":
        out = (x * m).sum(dim=1) / torch.sqrt(denom)
    elif ptype == "MAX":
        masked = torch.where(m > 0, x, torch.full_like(x, _lowest(x.dtype)))
        out, idx = masked.max(dim=1)
        # empty sequences (lod2 pad sentences) emit 0, not the lowest value
        empty = (lens <= 0).reshape((-1,) + (1,) * (out.dim() - 1))
        out = torch.where(empty, torch.zeros_like(out), out)
        return {"Out": [out], "MaxIndex": [idx]}
    elif ptype == "LAST":
        idx = (lens.long() - 1).clamp_min(0)
        out = x[torch.arange(x.shape[0], device=x.device), idx]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError(f"sequence_pool type {ptype}")
    return as_out(out)


@register("sequence_softmax")
def sequence_softmax(ins, attrs):
    x = first(ins, "X")                  # [B, T] or [B, T, 1]
    lens = first(ins, "SeqLen")
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    v = x.reshape(tuple(x.shape[:2])) if squeeze else x
    if v.dim() != 2:
        raise ValueError(f"sequence_softmax takes [B, T] or [B, T, 1], not "
                         f"{tuple(x.shape)}")
    out = sequence_kernels.masked_softmax(v, lens)
    return as_out(out.reshape(x.shape))


@register("sequence_mask", not_differentiable=True)
def sequence_mask(ins, attrs):
    lens = first(ins, "X").reshape(-1)   # lengths [B] or [B, 1]
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise NotImplementedError(
            "sequence_mask needs a static maxlen (its output shape "
            "otherwise depends on the data)")
    return {"Y": [length_mask(lens, maxlen,
                              torch_dtype(attrs.get("out_dtype", "int64")))]}


@register("sequence_expand")
def sequence_expand(ins, attrs):
    """x row/seq i repeated per y's i-th length (sequence_expand_op.cc).

    Dense lowering of the common case (x lod_level 0, ref_level arbitrary):
    x [B, D] broadcast across y's time axis -> [B, Ty, D] masked.
    """
    x = first(ins, "X")
    ylen = first(ins, "YSeqLen")         # level-k lengths [B, S1..S_{k-1}]
    k = ylen.dim()
    t = first(ins, "Y").shape[k]
    if tuple(x.shape[:k]) == tuple(ylen.shape):
        tgt = tuple(x.shape[:k]) + (t,) + tuple(x.shape[k:])
        out = x.unsqueeze(k).expand(tgt)
        m = length_mask(ylen.reshape(-1), t, x.dtype).reshape(
            tuple(ylen.shape) + (t,))
        m = m.reshape(tuple(m.shape) + (1,) * (out.dim() - m.dim()))
        return {"Out": [out * m], "OutLen": [ylen]}
    raise NotImplementedError(
        "sequence_expand: x leading dims must match the ref level's "
        f"lengths shape (x {tuple(x.shape)}, lens {tuple(ylen.shape)}); "
        "for token-wise expansion use sequence_expand_as")


@register("sequence_expand_as")
def sequence_expand_as(ins, attrs):
    x = first(ins, "X")                  # [B, D]
    ylen = first(ins, "YSeqLen")
    t = first(ins, "Y").shape[1]
    out = x[:, None, :].expand(x.shape[0], t, x.shape[1])
    m = _expand_mask(length_mask(ylen, t, x.dtype), out)
    return {"Out": [out * m], "OutLen": [ylen]}
