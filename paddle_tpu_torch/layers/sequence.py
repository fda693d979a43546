"""Sequence layer builders (fluid layers/nn.py sequence_* fns).

Every lod_level>0 variable ``v`` has an int32 companion ``v@SEQ_LEN``
(created by ``layers.data`` or by the producing sequence layer); these
builders wire the companions into the dense+lengths kernels of
``ops/sequence_ops.py``.
"""

from ..core.framework import Variable
from ..core.lod import seq_len_name, seq_len2_name, seq_lenk_name
from ..layer_helper import LayerHelper


def _len_var(x):
    """The companion lengths Variable of lod var x (create ref if needed)."""
    block = x.block
    name = seq_len_name(x.name)
    if block.has_var(name):
        return block.var(name)
    n = x.shape[0] if x.shape else -1
    return block.create_var(name=name, shape=(n,), dtype="int32",
                            stop_gradient=True)


def _len2_var(x):
    """Level-2 lengths companion ([B, S] tokens per inner sequence)."""
    return _lenk_var(x, 2)


def _lenk_var(x, k):
    """Level-k lengths companion ([B, S1..S_{k-1}], arbitrary depth)."""
    block = x.block
    name = seq_lenk_name(x.name, k)
    if block.has_var(name):
        return block.var(name)
    n = x.shape[0] if x.shape else -1
    return block.create_var(name=name, shape=(n,) + (-1,) * (k - 1),
                            dtype="int32", stop_gradient=True)


def _make_lod_out(helper, like, dtype=None, lod_level=1):
    out = helper.create_variable_for_type_inference(dtype or like.dtype)
    out.lod_level = lod_level
    out_len = out.block.create_var(name=seq_len_name(out.name),
                                   shape=(like.shape[0] if like.shape
                                          else -1,),
                                   dtype="int32", stop_gradient=True)
    return out, out_len


def _assert_level1(x, api):
    """Level-2 lod reaches only the ops that understand it (sequence_pool
    collapses the inner level); everything else fails loudly instead of
    masking just one level."""
    if getattr(x, "lod_level", 0) >= 2:
        raise NotImplementedError(
            f"{api} supports lod_level<=1 inputs; reduce the inner level "
            "first (e.g. sequence_pool) — got lod_level="
            f"{x.lod_level}")


def propagate_lod(helper, src, dst):
    """Copy src's lengths companion(s) to dst (for token-wise layers)."""
    if getattr(src, "lod_level", 0) <= 0:
        return dst
    dst.lod_level = src.lod_level
    name = seq_len_name(dst.name)
    if not dst.block.has_var(name):
        out_len = dst.block.create_var(name=name, shape=(None,),
                                       dtype="int32", stop_gradient=True)
        helper.append_op(type="assign", inputs={"X": [_len_var(src)]},
                         outputs={"Out": [out_len]})
    for k in range(2, src.lod_level + 1):
        namek = seq_lenk_name(dst.name, k)
        if not dst.block.has_var(namek):
            out_lenk = dst.block.create_var(
                name=namek, shape=(None,) * k, dtype="int32",
                stop_gradient=True)
            helper.append_op(type="assign",
                             inputs={"X": [_lenk_var(src, k)]},
                             outputs={"Out": [out_lenk]})
    return dst


def sequence_pool(input, pool_type, is_test=False):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    level = getattr(input, "lod_level", 0)
    lod2 = level >= 2
    if input.shape:
        # pooling removes the innermost (level-L) time axis
        out.shape = (tuple(input.shape[:level]) +
                     tuple(input.shape[level + 1:])) \
            if lod2 else (input.shape[0],) + tuple(input.shape[2:])
    outs = {"Out": [out]}
    if pool_type.upper() == "MAX":
        idx = helper.create_variable_for_type_inference("int64")
        idx.shape = out.shape
        outs["MaxIndex"] = [idx]
    ins = {"X": [input], "SeqLen": [_len_var(input)]}
    if lod2:
        # pool removes the INNERMOST level: output is lod_level=L-1 and
        # inherits the outer levels' lengths companions
        ins["SeqLen2"] = [_lenk_var(input, level)]
        out.lod_level = level - 1
        for k in range(1, level):
            out_len = out.block.create_var(
                name=seq_lenk_name(out.name, k),
                shape=(input.shape[0] if input.shape else -1,)
                + (-1,) * (k - 1),
                dtype="int32", stop_gradient=True)
            helper.append_op(type="assign",
                             inputs={"X": [_lenk_var(input, k)]},
                             outputs={"Out": [out_len]})
    helper.append_op(type="sequence_pool", inputs=ins,
                     outputs=outs, attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_softmax(input, use_cudnn=False, name=None):
    _assert_level1(input, "sequence_softmax")
    helper = LayerHelper("sequence_softmax", name=name)
    out, out_len = _make_lod_out(helper, input)
    out.shape = input.shape
    helper.append_op(type="sequence_softmax",
                     inputs={"X": [input], "SeqLen": [_len_var(input)]},
                     outputs={"Out": [out]})
    helper.append_op(type="assign", inputs={"X": [_len_var(input)]},
                     outputs={"Out": [out_len]})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    n = x.shape[0] if x.shape else -1
    out.shape = (n, maxlen)
    helper.append_op(type="sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]},
                     attrs={"maxlen": maxlen, "out_dtype": dtype})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    """Repeat x's level-(ref_level-1) entries across y's ref_level
    sequences (sequence_expand_op.cc).  ref_level=-1 uses y's innermost
    level; with a nested-LoD y any level can be the expansion axis."""
    helper = LayerHelper("sequence_expand", name=name)
    ylevel = getattr(y, "lod_level", 0) or 1
    k = ylevel if ref_level in (-1, None) else ref_level
    out, out_len = _make_lod_out(helper, x)
    out.lod_level = k
    if x.shape and y.shape and len(y.shape) > k:
        out.shape = tuple(x.shape[:k]) + (y.shape[k],) \
            + tuple(x.shape[k:])
    if k >= 2:
        # innermost companion carries the ragged axis; outer levels
        # inherit y's companions
        out_len = out.block.create_var(
            name=seq_lenk_name(out.name, k),
            shape=(x.shape[0] if x.shape else -1,) + (-1,) * (k - 1),
            dtype="int32", stop_gradient=True)
        for j in range(1, k):
            lo = out.block.create_var(
                name=seq_lenk_name(out.name, j),
                shape=(x.shape[0] if x.shape else -1,) + (-1,) * (j - 1),
                dtype="int32", stop_gradient=True)
            helper.append_op(type="assign",
                             inputs={"X": [_lenk_var(y, j)]},
                             outputs={"Out": [lo]})
    helper.append_op(type="sequence_expand",
                     inputs={"X": [x], "Y": [y],
                             "YSeqLen": [_lenk_var(y, k)]},
                     outputs={"Out": [out], "OutLen": [out_len]},
                     attrs={"ref_level": ref_level})
    return out


def sequence_expand_as(x, y, name=None):
    _assert_level1(x, "sequence_expand_as")
    helper = LayerHelper("sequence_expand_as", name=name)
    out, out_len = _make_lod_out(helper, x)
    if x.shape and y.shape:
        out.shape = (x.shape[0], y.shape[1] if len(y.shape) > 1 else None) \
            + tuple(x.shape[1:])
    helper.append_op(type="sequence_expand_as",
                     inputs={"X": [x], "Y": [y], "YSeqLen": [_len_var(y)]},
                     outputs={"Out": [out], "OutLen": [out_len]})
    return out


def sequence_concat(input, name=None):
    _assert_level1(input, "sequence_concat")
    helper = LayerHelper("sequence_concat", name=name)
    x0 = input[0]
    out, out_len = _make_lod_out(helper, x0)
    if all(x.shape and x.shape[1] not in (None, -1) for x in input):
        out.shape = (x0.shape[0], sum(x.shape[1] for x in input)) \
            + tuple(x0.shape[2:])
    helper.append_op(type="sequence_concat",
                     inputs={"X": list(input),
                             "SeqLen": [_len_var(x) for x in input]},
                     outputs={"Out": [out], "OutLen": [out_len]})
    return out


def sequence_reverse(x, name=None):
    _assert_level1(x, "sequence_reverse")
    helper = LayerHelper("sequence_reverse", name=name)
    out, out_len = _make_lod_out(helper, x)
    out.shape = x.shape
    helper.append_op(type="sequence_reverse",
                     inputs={"X": [x], "SeqLen": [_len_var(x)]},
                     outputs={"Y": [out]})
    helper.append_op(type="assign", inputs={"X": [_len_var(x)]},
                     outputs={"Out": [out_len]})
    return out


def sequence_slice(input, offset, length, name=None):
    _assert_level1(input, "sequence_slice")
    helper = LayerHelper("sequence_slice", name=name)
    out, out_len = _make_lod_out(helper, input)
    out.shape = input.shape
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input], "SeqLen": [_len_var(input)],
                             "Offset": [offset], "Length": [length]},
                     outputs={"Out": [out], "OutLen": [out_len]})
    return out


def sequence_erase(input, tokens, name=None):
    _assert_level1(input, "sequence_erase")
    helper = LayerHelper("sequence_erase", name=name)
    out, out_len = _make_lod_out(helper, input)
    out.shape = input.shape
    helper.append_op(type="sequence_erase",
                     inputs={"X": [input], "SeqLen": [_len_var(input)]},
                     outputs={"Out": [out], "OutLen": [out_len]},
                     attrs={"tokens": list(tokens)})
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    _assert_level1(input, "sequence_enumerate")
    helper = LayerHelper("sequence_enumerate", name=name)
    out, out_len = _make_lod_out(helper, input, dtype=input.dtype)
    if input.shape:
        out.shape = tuple(input.shape[:2]) + (win_size,)
    helper.append_op(type="sequence_enumerate",
                     inputs={"X": [input], "SeqLen": [_len_var(input)]},
                     outputs={"Out": [out], "OutLen": [out_len]},
                     attrs={"win_size": win_size, "pad_value": pad_value})
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None):
    _assert_level1(x, "sequence_pad")
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int32")
    if x.shape:
        t = maxlen if maxlen else x.shape[1]
        out.shape = (x.shape[0], t) + tuple(x.shape[2:])
        length.shape = (x.shape[0],)
    helper.append_op(type="sequence_pad",
                     inputs={"X": [x], "SeqLen": [_len_var(x)],
                             "PadValue": [pad_value]},
                     outputs={"Out": [out], "Length": [length]},
                     attrs={"padded_length": maxlen if maxlen else -1})
    return out, length


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", name=name)
    out, out_len = _make_lod_out(helper, x)
    out.shape = x.shape
    helper.append_op(type="sequence_unpad",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Out": [out], "OutLen": [out_len]})
    return out


def sequence_reshape(input, new_dim):
    _assert_level1(input, "sequence_reshape")
    helper = LayerHelper("sequence_reshape")
    out, out_len = _make_lod_out(helper, input)
    if input.shape and None not in input.shape[1:] \
            and -1 not in input.shape[1:]:
        b, t, d = input.shape[0], input.shape[1], input.shape[2]
        out.shape = (b, t * d // new_dim, new_dim)
    helper.append_op(type="sequence_reshape",
                     inputs={"X": [input], "SeqLen": [_len_var(input)]},
                     outputs={"Out": [out], "OutLen": [out_len]},
                     attrs={"new_dim": new_dim})
    return out


def sequence_scatter(input, index, updates, name=None):
    _assert_level1(input, "sequence_scatter")
    helper = LayerHelper("sequence_scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="sequence_scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates],
                             "SeqLen": [_len_var(index)]},
                     outputs={"Out": [out]})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    _assert_level1(input, "sequence_conv")
    helper = LayerHelper("sequence_conv", name=name, param_attr=param_attr,
                         bias_attr=bias_attr, act=act)
    d = input.shape[-1]
    f = helper.create_parameter(helper.param_attr,
                                shape=[filter_size * d, num_filters],
                                dtype=input.dtype)
    out, out_len = _make_lod_out(helper, input)
    if input.shape:
        out.shape = tuple(input.shape[:2]) + (num_filters,)
    helper.append_op(type="sequence_conv",
                     inputs={"X": [input], "Filter": [f],
                             "SeqLen": [_len_var(input)]},
                     outputs={"Out": [out]},
                     attrs={"contextLength": filter_size,
                            "contextStart": -(filter_size // 2),
                            "contextStride": filter_stride})
    helper.append_op(type="assign", inputs={"X": [_len_var(input)]},
                     outputs={"Out": [out_len]})
    pre_act = helper.append_bias_op(out, dim_start=2)
    final = helper.append_activation(pre_act)
    return propagate_lod(helper, out, final)


def lod_reset(x, y=None, target_lod=None):
    helper = LayerHelper("lod_reset")
    out, out_len = _make_lod_out(helper, x)
    out.shape = x.shape
    ins = {"X": [x]}
    attrs = {}
    if y is not None:
        ins["Y"] = [y]
    else:
        attrs["target_lod"] = list(target_lod)
    helper.append_op(type="lod_reset", inputs=ins,
                     outputs={"Out": [out], "OutLen": [out_len]},
                     attrs=attrs)
    return out
