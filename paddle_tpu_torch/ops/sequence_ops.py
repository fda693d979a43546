"""Sequence (LoD) kernels over the dense + lengths representation (port
of ``paddle_tpu/ops/sequence_ops.py``, all of its 16 ops):
``sequence_pool`` (every pool type, lod-2 and deeper included),
``sequence_softmax``, ``sequence_mask``, ``sequence_expand``,
``sequence_expand_as``, and the ops that change tokens or lengths:
``sequence_concat``, ``sequence_reverse``, ``sequence_slice``,
``sequence_erase``, ``sequence_enumerate``, ``sequence_pad``,
``sequence_unpad``, ``sequence_reshape``, ``sequence_scatter``,
``sequence_conv`` and ``lod_reset``.

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


# ---------------------------------------------------------------------------
# The ops that change a sequence's tokens or lengths.  T stays static: an op
# whose output is shorter than its input keeps T and writes new lengths
# (OutLen), with every position past a length zero, exactly as the JAX
# package's dense layout has it (the next op reads the pads).
# ---------------------------------------------------------------------------

def _gather_t(x, idx):
    """x[b, idx[b, t], ...] for idx [B, T'] int64."""
    return x.gather(1, idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
                    .expand(tuple(idx.shape) + tuple(x.shape[2:])))


@register("sequence_concat")
def sequence_concat(ins, attrs):
    """Concat along time per row: out[b] = x1[b][:l1] ++ x2[b][:l2] ++ ..."""
    xs = ins["X"]
    lens = ins["SeqLen"]
    b = xs[0].shape[0]
    t_out = sum(x.shape[1] for x in xs)
    feat = tuple(xs[0].shape[2:])
    dev = xs[0].device
    out = torch.zeros((b, t_out) + feat, dtype=xs[0].dtype, device=dev)
    offset = torch.zeros((b,), dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    for x, n in zip(xs, lens):
        t = x.shape[1]
        pos = (offset[:, None].long() + torch.arange(t, device=dev)[None, :]
               ).clamp(0, t_out - 1)
        # a row's valid tokens land on distinct slots; its pads add zeros
        out = out.index_put((rows.expand(b, t), pos),
                            x * _expand_mask(length_mask(n, t, x.dtype), x),
                            accumulate=True)
        offset = offset + n.to(torch.int32)
    return {"Out": [out], "OutLen": [offset]}


@register("sequence_reverse")
def sequence_reverse(ins, attrs):
    x = first(ins, "X")
    lens = first(ins, "SeqLen").long()
    t = x.shape[1]
    ts = torch.arange(t, device=x.device)[None, :]
    idx = torch.where(ts < lens[:, None], lens[:, None] - 1 - ts, ts)
    return {"Y": [_gather_t(x, idx)]}


@register("sequence_slice")
def sequence_slice(ins, attrs):
    x = first(ins, "X")
    offset = first(ins, "Offset").reshape(-1).long()
    length = first(ins, "Length").reshape(-1).to(torch.int32)
    t = x.shape[1]
    idx = (offset[:, None] + torch.arange(t, device=x.device)[None, :]
           ).clamp(0, t - 1)
    out = _gather_t(x, idx)
    out = out * _expand_mask(length_mask(length, t, x.dtype), out)
    return {"Out": [out], "OutLen": [length]}


@register("sequence_erase")
def sequence_erase(ins, attrs):
    """Remove the tokens of attr `tokens`; compact each row to the left."""
    x = first(ins, "X")                  # [B, T] or [B, T, 1] ints
    lens = first(ins, "SeqLen")
    tokens = torch.as_tensor(list(attrs.get("tokens", [])), dtype=x.dtype,
                             device=x.device)
    squeeze = x.dim() == 3
    v = x.reshape(tuple(x.shape[:2])) if squeeze else x
    t = v.shape[1]
    keep = length_mask(lens, t, torch.bool) & ~torch.isin(v, tokens)
    new_pos = torch.cumsum(keep.long(), dim=1) - 1
    # dropped tokens all write 0 to slot t-1, which lies past the compacted
    # length (or nothing was dropped): only equal values collide, and the
    # final mask clears the slot
    scatter_pos = torch.where(keep, new_pos, torch.full_like(new_pos, t - 1))
    out = torch.zeros_like(v).scatter(
        1, scatter_pos, torch.where(keep, v, torch.zeros_like(v)))
    new_lens = keep.sum(dim=1).to(torch.int32)
    out = out * length_mask(new_lens, t, v.dtype)
    if squeeze:
        out = out[..., None]
    return {"Out": [out], "OutLen": [new_lens]}


@register("sequence_enumerate", not_differentiable=True)
def sequence_enumerate(ins, attrs):
    x = first(ins, "X")                  # [B, T] or [B, T, 1]
    lens = first(ins, "SeqLen")
    win = attrs["win_size"]
    pad = attrs.get("pad_value", 0)
    v = x.reshape(tuple(x.shape[:2])) if x.dim() == 3 else x
    t = v.shape[1]
    ts = torch.arange(t, device=v.device)[:, None] \
        + torch.arange(win, device=v.device)[None, :]              # [T, win]
    gathered = v[:, ts.clamp(0, t - 1)]                            # [B,T,win]
    in_range = ts[None] < lens[:, None, None]
    out = torch.where(in_range, gathered, torch.full_like(gathered, pad))
    out = out * length_mask(lens, t, v.dtype)[..., None]
    return {"Out": [out], "OutLen": [lens]}


@register("sequence_pad")
def sequence_pad(ins, attrs):
    """Already padded: re-pad to padded_length with PadValue."""
    x = first(ins, "X")
    lens = first(ins, "SeqLen")
    pad_value = first(ins, "PadValue")
    target = attrs.get("padded_length", -1)
    t = x.shape[1]
    if target is None or target < 0:
        target = t
    if target > t:
        x = torch.cat([x, torch.zeros((x.shape[0], target - t)
                                      + tuple(x.shape[2:]), dtype=x.dtype,
                                      device=x.device)], dim=1)
    elif target < t:
        x = x[:, :target]
    m = _expand_mask(length_mask(lens, target, x.dtype), x)
    pv = pad_value.reshape((1, 1) + (1,) * (x.dim() - 2)).to(x.dtype)
    return {"Out": [x * m + pv * (1 - m)],
            "Length": [lens.clamp_max(target)]}


@register("sequence_unpad")
def sequence_unpad(ins, attrs):
    x = first(ins, "X")                  # [B, T, ...] padded
    length = first(ins, "Length").reshape(-1).to(torch.int32)
    m = _expand_mask(length_mask(length, x.shape[1], x.dtype), x)
    return {"Out": [x * m], "OutLen": [length]}


@register("sequence_reshape")
def sequence_reshape(ins, attrs):
    x = first(ins, "X")                  # [B, T, D]
    lens = first(ins, "SeqLen")
    new_dim = attrs["new_dim"]
    b, t, d = x.shape
    if (t * d) % new_dim:
        raise ValueError(f"sequence_reshape: T * D = {t * d} is not a "
                         f"multiple of new_dim {new_dim}")
    return {"Out": [x.reshape(b, t * d // new_dim, new_dim)],
            "OutLen": [torch.div(lens * d, new_dim, rounding_mode="floor")]}


@register("sequence_scatter")
def sequence_scatter(ins, attrs):
    """out = x with updates[b, t] added at (b, ids[b, t]) for t < len[b].
    Pads add 0; where a row repeats an id, its updates are summed (on the
    card in the order the atomics land)."""
    x = first(ins, "X")                  # [B, D]
    ids = first(ins, "Ids")              # [B, T] or [B, T, 1] int
    upd = first(ins, "Updates")          # [B, T]
    lens = first(ins, "SeqLen")
    v_ids = ids.reshape(ids.shape[0], -1).long()
    v_upd = upd.reshape(upd.shape[0], -1)
    m = length_mask(lens, v_ids.shape[1], v_upd.dtype)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return as_out(x.index_put((rows.expand_as(v_ids), v_ids), v_upd * m,
                              accumulate=True))


@register("sequence_conv")
def sequence_conv(ins, attrs):
    """Context-window projection over time (sequence_conv_op.cc).

    X [B, T, D], Filter [context_length * D, M]; each step's window
    [t + start, t + start + len) is flattened (zero beyond the bounds and
    the length) and projected: one product over all steps.
    """
    x = first(ins, "X")
    f = first(ins, "Filter")
    lens = first(ins, "SeqLen")
    ctx_len = attrs.get("contextLength", attrs.get("context_length", 3))
    ctx_start = attrs.get("contextStart", attrs.get("context_start",
                                                    -(ctx_len // 2)))
    b, t, d = x.shape
    dev = x.device
    ts = torch.arange(t, device=dev)[:, None] + ctx_start \
        + torch.arange(ctx_len, device=dev)[None, :]               # [T, ctx]
    # a position before 0 or at/after the length is zero (t >= len covers
    # t >= T, since len <= T)
    tok_valid = (ts[None] < lens[:, None, None]) & (ts[None] >= 0)
    windows = x[:, ts.clamp(0, t - 1)] * tok_valid[..., None].to(x.dtype)
    out = windows.reshape(b, t, ctx_len * d) @ f
    return as_out(out * length_mask(lens, t, x.dtype)[..., None])


@register("lod_reset")
def lod_reset(ins, attrs):
    x = first(ins, "X")
    y = first(ins, "Y")
    if y is not None:
        new_lens = y.reshape(-1).to(torch.int32)
    else:
        target = list(attrs["target_lod"])
        new_lens = torch.tensor([b - a for a, b in zip(target, target[1:])],
                                dtype=torch.int32, device=x.device)
    return {"Out": [x], "OutLen": [new_lens]}
