"""The dense image slice's kernels (port of ``paddle_tpu/ops/nn_ops.py``
:37-200, :340-380, :551-582): conv2d and its transposed and depthwise
forms, pool2d, adaptive pooling, batch_norm, top_k, arg_max/arg_min and
accuracy.

Reference semantics: ``conv_op.cc`` (NCHW input, OIHW filter, symmetric
paddings, groups), ``conv_transpose_op.cc`` (filter [C_in, C_out/G, kh,
kw], no output padding, ``output_size`` ignored), ``pool_op.cc``
(exclusive avg by default; ``ceil_mode`` is not read: the JAX package's
op computes floor windows whatever the attr says, and so does the
port), ``batch_norm_op.cc`` (moving statistics updated in place),
``top_k_op.cc``, ``metrics/accuracy_op.cc``.

The JAX package lowers convolutions and pools through XLA
(``lax.conv_general_dilated``, ``lax.reduce_window``), never a Pallas
kernel, so the port runs them on cuDNN and torch: no hand kernel.  A
CUDA float32 convolution runs in TF32 when
``torch.backends.cudnn.allow_tf32`` is on, which is PyTorch's default;
the caller sets it (``chip_smoke.py`` turns it off).

The convolutions and batch_norm register a vector-Jacobian product
(``registry.register_vjp``): their ``generic_grad`` ops take dX and dW
from X, W and dOut in one ``convolution_backward`` call, and batch
norm's from its saved mean and inverse deviation, instead of
recomputing the forward under autograd.

batch_norm's moving statistics follow the reference, not
``torch.nn.functional.batch_norm``'s running buffers:
``momentum · old + (1 − momentum) · batch`` with the batch's *biased*
variance, accumulated in float32.  Only the op writes them (MeanOut,
VarianceOut); its grad op returns grads only, so a step updates them
once.
"""

import torch
import torch.nn.functional as F

from .registry import (register, register_vjp, first, as_out, current,
                       has_out_grad, amp_inputs)


def _conv_args(attrs):
    pads = attrs.get("paddings", [0, 0])
    return (list(attrs.get("strides", [1, 1])), [pads[0], pads[1]],
            list(attrs.get("dilations", [1, 1])))


def _conv(x, w, attrs, transposed):
    strides, pads, dilations = _conv_args(attrs)
    groups = attrs.get("groups", 1)
    if transposed:
        return F.conv_transpose2d(x, w, None, strides, pads, 0, groups,
                                  dilations)
    return F.conv2d(x, w, None, strides, pads, dilations, groups)


def _depthwise(ins, attrs):
    return dict(attrs, groups=first(ins, "Input").shape[1])


@register("conv2d")
def conv2d(ins, attrs):
    return {"Output": [_conv(first(ins, "Input"), first(ins, "Filter"),
                             attrs, False)]}


@register("conv2d_transpose")
def conv2d_transpose(ins, attrs):
    return {"Output": [_conv(first(ins, "Input"), first(ins, "Filter"),
                             attrs, True)]}


@register("depthwise_conv2d")
def depthwise_conv2d(ins, attrs):
    """conv2d with groups = C_in (the reference's :95)."""
    return conv2d(ins, _depthwise(ins, attrs))


@register("depthwise_conv2d_transpose")
def depthwise_conv2d_transpose(ins, attrs):
    """conv2d_transpose with groups = C_in (conv_transpose_op.cc:578)."""
    return conv2d_transpose(ins, _depthwise(ins, attrs))


def _conv_vjp(ins, attrs, transposed, depthwise):
    """dInput and dFilter of a convolution from its inputs and dOutput,
    one ``aten.convolution_backward`` call (cuDNN on the card).  In an
    AMP run it computes on the operands the forward's cast wrap gave its
    kernel (``registry.amp_inputs``: bf16 for these white ops) and
    returns each grad in its input's own dtype, as autograd of the casts
    does: an fp32 filter's grad is fp32."""
    if not has_out_grad(ins, "Output"):
        return None
    fw = _depthwise(ins, attrs["fw_attrs"]) if depthwise \
        else attrs["fw_attrs"]
    x0, w0 = first(ins, "Input"), first(ins, "Filter")
    cast = amp_inputs(attrs["fw_type"], {"Input": [x0], "Filter": [w0]},
                      attrs["fw_attrs"])
    x, w = first(cast, "Input"), first(cast, "Filter")
    g = first(ins, "Output@GRAD_OUT").to(x.dtype)
    needs = {s for s, _ in attrs["needs_input_grad"]}
    strides, pads, dilations = _conv_args(fw)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g, x, w, None, strides, pads, dilations, transposed, [0, 0],
        fw.get("groups", 1), ["Input" in needs, "Filter" in needs, False])
    outs = {}
    if "Input" in needs:
        outs["Input@GRAD"] = [dx.to(x0.dtype)]
    if "Filter" in needs:
        outs["Filter@GRAD"] = [dw.to(w0.dtype)]
    return outs


for _type, _transposed, _depthwise_form in (
        ("conv2d", False, False), ("depthwise_conv2d", False, True),
        ("conv2d_transpose", True, False),
        ("depthwise_conv2d_transpose", True, True)):
    register_vjp(_type)(
        lambda ins, attrs, t=_transposed, d=_depthwise_form:
        _conv_vjp(ins, attrs, t, d))


def _pool_window(attrs):
    ksize = list(attrs.get("ksize", [2, 2]))
    strides = list(attrs.get("strides", ksize))
    pads = attrs.get("paddings", [0, 0])
    return ksize, strides, [pads[0], pads[1]]


@register("pool2d")
def pool2d(ins, attrs):
    """Max pool pads with -inf; avg divides by the window's elements
    inside the input (``exclusive``, the default) or by kh·kw.  Windows
    are floor windows (see the module docstring on ``ceil_mode``)."""
    x = first(ins, "X")
    avg = attrs.get("pooling_type", "max") != "max"
    if not attrs.get("global_pooling", False):
        ksize, strides, pads = _pool_window(attrs)
    elif avg:
        return as_out(x.mean(dim=(2, 3), keepdim=True))
    else:
        ksize, strides, pads = list(x.shape[2:]), list(x.shape[2:]), [0, 0]
    implicit = all(p <= k // 2 for p, k in zip(pads, ksize))
    if not avg:
        if not implicit:    # torch pads implicitly only up to half a window
            x = F.pad(x, (pads[1], pads[1], pads[0], pads[0]),
                      value=float("-inf"))
            pads = [0, 0]
        return as_out(F.max_pool2d(x, ksize, strides, pads))
    exclusive = attrs.get("exclusive", True)
    if implicit:
        return as_out(F.avg_pool2d(
            x, ksize, strides, pads, count_include_pad=not exclusive,
            divisor_override=None if exclusive else ksize[0] * ksize[1]))
    pad = (pads[1], pads[1], pads[0], pads[0])
    summed = F.avg_pool2d(F.pad(x, pad), ksize, strides,
                          divisor_override=1)
    if not exclusive:
        return as_out(summed / (ksize[0] * ksize[1]))
    ones = F.pad(torch.ones_like(x[:1, :1]), pad)
    counts = F.avg_pool2d(ones, ksize, strides, divisor_override=1)
    return as_out(summed / counts)


_ADAPTIVE = {(2, "avg"): F.adaptive_avg_pool2d,
             (2, "max"): F.adaptive_max_pool2d,
             (3, "avg"): F.adaptive_avg_pool3d,
             (3, "max"): F.adaptive_max_pool3d}


def _adaptive(ins, attrs, nd):
    """Output cell i covers [floor(i·S/O), ceil((i+1)·S/O)), uneven
    sizes included: torch's adaptive pools use the same cells."""
    fn = _ADAPTIVE[nd, attrs.get("pooling_type", "avg")]
    return as_out(fn(first(ins, "X"), tuple(attrs["pooled_size"])))


@register("adaptive_pool2d")
def adaptive_pool2d(ins, attrs):
    return _adaptive(ins, attrs, 2)


@register("adaptive_pool3d")
def adaptive_pool3d(ins, attrs):
    return _adaptive(ins, attrs, 3)


def _bn_layout(x, attrs):
    """(channel axis, reduce axes, broadcast shape of a [C] vector)."""
    c = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.ndim - 1
    shape = [1] * x.ndim
    shape[c] = x.shape[c]
    return c, tuple(i for i in range(x.ndim) if i != c), shape


def _global_stats(attrs):
    return attrs.get("is_test", False) or current().is_test or \
        attrs.get("use_global_stats", False)


@register("batch_norm")
def batch_norm(ins, attrs):
    """Y = (X − mean) · rsqrt(var + eps) · Scale + Bias over the batch's
    statistics in training, the moving ones under ``is_test``,
    ``use_global_stats`` or a test-mode run.  SavedVariance is
    1/sqrt(var + eps).  Statistics are float32 for a bfloat16 input."""
    x = first(ins, "X")
    scale, bias = first(ins, "Scale"), first(ins, "Bias")
    mean, var = first(ins, "Mean"), first(ins, "Variance")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    c, red, shape = _bn_layout(x, attrs)
    sdt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    xs = x.to(sdt)
    if _global_stats(attrs):
        use_mean, use_var = mean.to(sdt), var.to(sdt)
        mean_out, var_out = mean, var
    else:
        use_var, use_mean = torch.var_mean(xs, dim=red, correction=0)
        mean_out = momentum * mean + (1 - momentum) * use_mean.to(mean.dtype)
        var_out = momentum * var + (1 - momentum) * use_var.to(var.dtype)
    inv = torch.rsqrt(use_var + eps)
    if torch.is_grad_enabled():
        # the generic grad's recompute differentiates through the stats
        y = (xs - use_mean.reshape(shape)) * inv.reshape(shape) * \
            scale.to(sdt).reshape(shape) + bias.to(sdt).reshape(shape)
    else:
        # one fused normalize over the statistics computed above
        y = F.batch_norm(xs.movedim(c, 1), use_mean, use_var,
                         scale.to(sdt), bias.to(sdt), False, 0.0,
                         eps).movedim(1, c)
    return {"Y": [y.to(x.dtype)], "MeanOut": [mean_out],
            "VarianceOut": [var_out], "SavedMean": [use_mean],
            "SavedVariance": [inv]}


@register_vjp("batch_norm")
def batch_norm_vjp(ins, attrs):
    """dX, dScale, dBias from dY, X, Scale and the forward's SavedMean
    and SavedVariance (its 1/sqrt(var + eps)) in one
    ``aten.native_batch_norm_backward``; None (the generic recompute)
    when another output carries a grad."""
    if not has_out_grad(ins, "Y") or any(
            has_out_grad(ins, s) for s in ("MeanOut", "VarianceOut",
                                           "SavedMean", "SavedVariance")):
        return None
    fw = attrs["fw_attrs"]
    x = first(ins, "X")
    mean = first(ins, "SavedMean@FW_OUT")
    inv = first(ins, "SavedVariance@FW_OUT")
    if mean is None or inv is None:
        return None
    scale = first(ins, "Scale")
    c, _, _ = _bn_layout(x, fw)
    sdt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    g = first(ins, "Y@GRAD_OUT").to(sdt).movedim(c, 1)
    xs = x.to(sdt).movedim(c, 1)
    needs = {s for s, _ in attrs["needs_input_grad"]}
    eps = fw.get("epsilon", 1e-5)
    train = not _global_stats(fw)
    # under global stats the forward normalized by the moving statistics
    # (MeanOut = Mean there, so the name holds them still), which then
    # carry no grad of X
    running = (None, None) if train else (
        mean, first(ins, "Variance").to(sdt))
    saved = (mean, inv) if train else (None, None)
    dx, dscale, dbias = torch.ops.aten.native_batch_norm_backward(
        g, xs, scale.to(sdt), *running, *saved, train, eps,
        ["X" in needs, "Scale" in needs, "Bias" in needs])
    outs = {}
    if "X" in needs:
        outs["X@GRAD"] = [dx.movedim(1, c).to(x.dtype)]
    if "Scale" in needs:
        outs["Scale@GRAD"] = [dscale.to(scale.dtype)]
    if "Bias" in needs:
        outs["Bias@GRAD"] = [dbias.to(first(ins, "Bias").dtype)]
    return outs


@register("top_k", not_differentiable=True)
def top_k(ins, attrs):
    """The k largest along the last axis, in descending order, and their
    indices (the IR's int64; the JAX package returns int32).  Among equal
    values the lower index comes first, as ``lax.top_k`` orders them:
    a stable descending sort cut to k, on every device (``torch.topk``
    promises no order among ties, and its CPU and CUDA orders differ)."""
    k = attrs.get("k", 1)
    vals, idx = torch.sort(first(ins, "X"), dim=-1, descending=True,
                           stable=True)
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}


# torch.argmax and torch.argmin return the first extreme along the axis on
# the CPU and on CUDA, as jnp.argmax and jnp.argmin do
@register("arg_max", not_differentiable=True)
def arg_max(ins, attrs):
    return as_out(torch.argmax(first(ins, "X"), dim=attrs.get("axis", -1)))


@register("arg_min", not_differentiable=True)
def arg_min(ins, attrs):
    return as_out(torch.argmin(first(ins, "X"), dim=attrs.get("axis", -1)))


@register("accuracy", not_differentiable=True)
def accuracy(ins, attrs):
    """The share of rows whose label is among their top-k Indices:
    Accuracy a float32 scalar, Correct and Total int32 [1]."""
    indices = first(ins, "Indices")              # [N, k]
    label = first(ins, "Label")                  # [N, 1]
    n = indices.shape[0]
    correct = (indices == label.to(indices.dtype)).any(dim=-1).sum()
    return {"Accuracy": [correct.float() / n],
            "Correct": [correct.to(torch.int32).reshape(1)],
            "Total": [torch.full((1,), n, dtype=torch.int32,
                                 device=indices.device)]}
