"""NN kernels on the BERT serving path (port of
``paddle_tpu/ops/nn_ops.py``): softmax, dropout at inference, layer_norm,
lookup_table.

Reference semantics: ``softmax_op.cc``, ``dropout_op.cc`` (two
implementations), ``layer_norm_op.cc``, ``lookup_table_op.cc:71``
(padding_idx).
"""

import torch

from .registry import register, first, as_out, current
from .tensor_ops import take_rows


@register("softmax")
def softmax(ins, attrs):
    return as_out(torch.softmax(first(ins, "X"), dim=attrs.get("axis", -1)))


@register("dropout")
def dropout(ins, attrs):
    x = first(ins, "X")
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or current().is_test:
        # downgrade_in_infer scales by the keep rate at inference;
        # upscale_in_train already scaled in training and is the identity
        out = x * (1.0 - p) if impl == "downgrade_in_infer" else x
        return {"Out": [out], "Mask": [torch.ones_like(x)]}
    if p:
        raise NotImplementedError(
            "dropout in training mode runs in the training slice of the "
            "port, which has not landed yet")
    return {"Out": [x], "Mask": [torch.ones_like(x)]}


@register("layer_norm")
def layer_norm(ins, attrs):
    x = first(ins, "X")
    scale = first(ins, "Scale")
    bias = first(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    red = tuple(range(begin, x.ndim))
    # fp32 statistics, output in the input dtype
    xs = x.float() if x.dtype == torch.bfloat16 else x
    mean = xs.mean(dim=red, keepdim=True)
    if x.dtype == torch.bfloat16:
        # one-pass E[x^2]-E[x]^2, as the reference does for bf16 inputs
        var = ((xs * xs).mean(dim=red, keepdim=True)
               - mean * mean).clamp_min(0.0)
    else:
        # exact two-pass form for fp32 inputs
        var = ((xs - mean) ** 2).mean(dim=red, keepdim=True)
    norm = (xs - mean) * torch.rsqrt(var + eps)
    norm_shape = (1,) * begin + tuple(x.shape[begin:])
    if scale is not None:
        norm = norm * scale.to(xs.dtype).reshape(norm_shape)
    if bias is not None:
        norm = norm + bias.to(xs.dtype).reshape(norm_shape)
    lead = tuple(x.shape[:begin])
    return {"Y": [norm.to(x.dtype)], "Mean": [mean.reshape(lead)],
            "Variance": [var.reshape(lead)]}


def squeeze_ids(ids):
    """Drop the trailing 1 dim fluid ids carry ([..., 1] -> [...])."""
    return ids.reshape(ids.shape[:-1]) if ids.shape[-1] == 1 else ids


def normalize_padding_idx(pad, height):
    """Map a possibly-negative padding_idx to [0, height) or -1."""
    if pad is None or pad == -1:
        return -1
    return pad if pad >= 0 else height + pad


@register("lookup_table")
def lookup_table(ins, attrs):
    w = first(ins, "W")              # [V, D]
    idx = squeeze_ids(first(ins, "Ids"))
    out = take_rows(w, idx)
    pad = normalize_padding_idx(attrs.get("padding_idx", -1), w.shape[0])
    if pad != -1:
        out = out.masked_fill((idx == pad).unsqueeze(-1), 0.0)
    return as_out(out)
