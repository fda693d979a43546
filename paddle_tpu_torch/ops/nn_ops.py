"""NN kernels on the BERT serving and training paths, the RNN slice and
transformer NMT (port of ``paddle_tpu/ops/nn_ops.py``): softmax,
cross_entropy over probabilities (with its lod mask),
softmax_with_cross_entropy with its fused grad, dropout, layer_norm with
its analytic grad, lookup_table with its dense and SelectedRows grads,
square_error_cost, sigmoid_cross_entropy_with_logits, one_hot,
label_smooth, and ``norm`` with ``l2_normalize``, ``smooth_l1_loss`` and
``hierarchical_sigmoid`` (on the default complete binary tree).

Reference semantics: ``softmax_op.cc``, ``cross_entropy_op.cc``,
``softmax_with_cross_entropy_op.cc``, ``dropout_op.cc`` (two
implementations), ``layer_norm_op.cc``, ``lookup_table_op.cc:71``
(padding_idx), ``norm_op.cc``, ``smooth_l1_loss_op.h``,
``hierarchical_sigmoid_op.h`` (``math/matrix_bit_code.h``'s SimpleCode).

Training-mode dropout keys its mask by the reference's per-op seed
recipe (``registry.op_seed``: program seed, op seed, step) and draws it
from counter-based Philox (``registry.dropout_keep``), so the generic
grad's recompute in the same step draws the same mask (an Executor run
reuses it), and the CPU and the card draw the same mask for the same op
and step.  Under ``FLAGS_use_fused_dropout`` a CUDA tensor takes the
hand-written kernel K10 instead (``ops/dropout_kernels.py``: the same
bits and the same arithmetic, drawn in registers), and the op's generic
grad runs K10 once on the cotangent (:func:`dropout_vjp`) where the
plain arm recomputes the forward.  Either arm makes the Mask output only
when something reads it (``registry.output_read``).
"""

import torch

from ..core.selected_rows import SelectedRows
from ..flags import get_flag
from . import dropout_kernels
from .registry import (register, register_grad, register_vjp, first, as_out,
                       amp_inputs, current, dropout_keep, generic_grad_kernel,
                       has_out_grad, op_seed, output_read)
from .math_ops import tie_abs, tie_max
from .sequence_kernels import length_mask
from .tensor_ops import take_rows


@register("softmax")
def softmax(ins, attrs):
    return as_out(torch.softmax(first(ins, "X"), dim=attrs.get("axis", -1)))


def _fused_dropout(x, attrs):
    """Whether this dropout takes K10: in training, 0 < p < 1, the flag
    on, and a tensor off the CPU (the wrapper launches on CUDA or
    raises)."""
    return not (attrs.get("is_test", False) or current().is_test) \
        and 0.0 < attrs.get("dropout_prob", 0.5) < 1.0 \
        and x.device.type != "cpu" and get_flag("use_fused_dropout")


@register("dropout")
def dropout(ins, attrs):
    x = first(ins, "X")
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    upscale = impl == "upscale_in_train"
    if attrs.get("is_test", False) or current().is_test:
        # downgrade_in_infer scales by the keep rate at inference;
        # upscale_in_train already scaled in training and is the identity
        out = x * (1.0 - p) if impl == "downgrade_in_infer" else x
        return _with_mask(out, lambda: torch.ones_like(x))
    if _fused_dropout(x, attrs):
        seed = op_seed(attrs)
        out = dropout_kernels.fused_dropout(x.contiguous(), p, seed, upscale)
        return _with_mask(out, lambda: dropout_kernels.fused_dropout(
            torch.ones_like(x), p, seed, upscale=False))
    if p >= 1.0:
        keep = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        out = torch.zeros_like(x)
    elif p > 0.0:
        masks = current().masks
        key = (op_seed(attrs), tuple(x.shape), p, x.device)
        keep = None if masks is None else masks.get(key)
        if keep is None:
            keep = dropout_keep(key[0], key[1], p, x.device)
            if masks is not None:
                masks[key] = keep
        out = dropout_kernels.fused_dropout_reference(x, p, key[0], upscale,
                                                      keep=keep)
    else:
        keep, out = None, x
    return _with_mask(out, lambda: torch.ones_like(x) if keep is None
                      else keep.to(x.dtype))


def _with_mask(out, mask):
    """The op's outputs: Out, and Mask (`mask()`) only when it is read."""
    if output_read("Mask"):
        return {"Out": [out], "Mask": [mask()]}
    return {"Out": [out]}


@register_vjp("dropout")
def dropout_vjp(ins, attrs):
    """K10's arm of the dropout grad: dX = K10(dOut) under the forward's
    seed, one launch (``_dropout_fused_bwd``, :1445).  None on the plain
    arm, whose generic grad recomputes the forward over the run's cached
    mask."""
    fw = attrs["fw_attrs"]
    x0 = first(ins, "X")
    # in an AMP run, at the forward's precision: K10's bf16 arm on a bf16
    # cotangent where the wrap handed the forward a bf16 X
    x = first(amp_inputs("dropout", {"X": [x0]}, fw), "X")
    if not _fused_dropout(x, fw) or not has_out_grad(ins, "Out"):
        return None
    impl = fw.get("dropout_implementation", "downgrade_in_infer")
    g = first(ins, "Out@GRAD_OUT").to(x.dtype).contiguous()
    return {"X@GRAD": [dropout_kernels.fused_dropout(
        g, fw.get("dropout_prob", 0.5), op_seed(fw),
        upscale=impl == "upscale_in_train").to(x0.dtype)]}


def _labels(label):
    """Hard labels [..., 1] -> [...]."""
    return label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
        else label


@register("cross_entropy")
def cross_entropy(ins, attrs):
    """-log of the probability of the label (hard) or -sum(label *
    log(prob)) (soft), over probabilities X [..., C].  The log's argument
    is clamped at 1e-20, so a 0 probability (a masked pad row) gives a
    finite loss and grad.  With SeqLen (a lod input) the loss of each pad
    position is 0."""
    x = first(ins, "X")
    label = first(ins, "Label")
    lens = first(ins, "SeqLen")
    if attrs.get("soft_label", False):
        loss = -(label * torch.log(x.clamp_min(1e-20))).sum(dim=-1,
                                                             keepdim=True)
    else:
        lbl = _labels(label).long()
        c = x.shape[-1]
        # in-range indices for the gather (never a device-side assert);
        # the ignored label's loss is zeroed below
        idx = torch.where(lbl < 0, lbl + c, lbl).clamp(0, c - 1)
        picked = torch.gather(x, -1, idx.unsqueeze(-1))
        loss = -torch.log(picked.clamp_min(1e-20))
        loss = loss.masked_fill(
            (lbl == attrs.get("ignore_index", -100)).unsqueeze(-1), 0.0)
    if lens is not None and loss.dim() >= 2:
        valid = length_mask(lens, loss.shape[1], loss.dtype)
        loss = loss * valid.reshape(tuple(valid.shape)
                                    + (1,) * (loss.dim() - 2))
    return as_out(loss)


@register("softmax_with_cross_entropy")
def softmax_with_cross_entropy(ins, attrs):
    logits = first(ins, "Logits")
    label = first(ins, "Label")
    logits_f = logits.float()
    lse = torch.logsumexp(logits_f, dim=-1, keepdim=True)
    if attrs.get("soft_label", False):
        loss = (label.float() * (lse - logits_f)).sum(dim=-1, keepdim=True)
    else:
        lbl = _labels(label).long()
        c = logits.shape[-1]
        idx = torch.where(lbl < 0, lbl + c, lbl).clamp(0, c - 1)
        picked = torch.gather(logits, -1, idx.unsqueeze(-1))
        loss = lse - picked.float()
        ignore = attrs.get("ignore_index", -100)
        loss = loss.masked_fill((lbl == ignore).unsqueeze(-1), 0.0)
    softmax = torch.exp(logits_f - lse).to(logits.dtype)
    return {"Softmax": [softmax], "Loss": [loss]}


@register_grad("softmax_with_cross_entropy")
def softmax_with_cross_entropy_grad(ins, attrs):
    """Fused xent backward: dLogits = g * (softmax - onehot) in fp32,
    written in the logits dtype (the reference's custom grad,
    nn_ops.py:266)."""
    needs_label = any(s == "Label" for s, _ in attrs["needs_input_grad"])
    if needs_label or has_out_grad(ins, "Softmax"):
        # someone differentiates through the Softmax output or a soft
        # Label too: the generic recompute path is exact there
        return generic_grad_kernel(ins, attrs)
    fw_attrs = attrs["fw_attrs"]
    logits = first(ins, "Logits")
    label = first(ins, "Label")
    g = first(ins, "Loss@GRAD_OUT").float()
    logits_f = logits.float()
    sm = torch.softmax(logits_f, dim=-1)
    if fw_attrs.get("soft_label", False):
        lab = label.float()
        d = g * (sm * lab.sum(dim=-1, keepdim=True) - lab)
    else:
        lbl = _labels(label).long()
        onehot = torch.arange(logits.shape[-1], device=logits.device) \
            == lbl.unsqueeze(-1)
        d = g * (sm - onehot.float())
        ignore = fw_attrs.get("ignore_index", -100)
        d = d.masked_fill((lbl == ignore).unsqueeze(-1), 0.0)
    return {"Logits@GRAD": [d.to(logits.dtype)]}


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


@register_grad("layer_norm")
def layer_norm_grad(ins, attrs):
    """Analytic LN backward (the reference's custom grad, nn_ops.py:417):
    the row statistics recomputed once, dX in one expression, dScale and
    dBias as column sums."""
    if has_out_grad(ins, "Mean") or has_out_grad(ins, "Variance"):
        return generic_grad_kernel(ins, attrs)
    fw = attrs["fw_attrs"]
    x = first(ins, "X")
    scale = first(ins, "Scale")
    dy = first(ins, "Y@GRAD_OUT")
    eps = fw.get("epsilon", 1e-5)
    begin = fw.get("begin_norm_axis", 1)
    red = tuple(range(begin, x.ndim))
    lead = tuple(range(begin))
    norm_shape = (1,) * begin + tuple(x.shape[begin:])
    xs = x.float()
    dyf = dy.float()
    m1 = xs.mean(dim=red, keepdim=True)
    if x.dtype == torch.bfloat16:     # match the forward's stats exactly
        var = ((xs * xs).mean(dim=red, keepdim=True)
               - m1 * m1).clamp_min(0.0)
    else:
        var = ((xs - m1) ** 2).mean(dim=red, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (xs - m1) * inv
    g = dyf * scale.float().reshape(norm_shape) if scale is not None \
        else dyf
    s1 = g.mean(dim=red, keepdim=True)
    s2 = (g * xhat).mean(dim=red, keepdim=True)
    needs = {s for s, _ in attrs["needs_input_grad"]}
    outs = {}
    if "X" in needs:
        outs["X@GRAD"] = [(inv * (g - s1 - xhat * s2)).to(x.dtype)]
    if "Scale" in needs:
        dscale = (dyf * xhat).sum(dim=lead) if lead else dyf * xhat
        outs["Scale@GRAD"] = [dscale.reshape(scale.shape).to(scale.dtype)]
    if "Bias" in needs:
        bias = first(ins, "Bias")
        dbias = dyf.sum(dim=lead) if lead else dyf
        outs["Bias@GRAD"] = [dbias.reshape(bias.shape).to(bias.dtype)]
    return outs


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


@register_grad("lookup_table")
def lookup_table_grad(ins, attrs):
    """Table gradient (the reference's custom grad, nn_ops.py:692).
    ``is_sparse``: a SelectedRows of the looked-up rows and their out-grad
    rows (selected_rows.h:32: O(touched rows), duplicates accumulate when
    an update applies it; ids are the caller's contract, as in the
    reference).  Dense: one scatter-add of the out-grad rows, ids out of
    range adding nothing, as jax's scatter drops them.  Either way the
    padding_idx rows are zeroed."""
    fw_attrs = attrs["fw_attrs"]
    w = first(ins, "W")
    og = first(ins, "Out@GRAD_OUT")
    rows = squeeze_ids(first(ins, "Ids")).reshape(-1).long()
    values = og.reshape((-1,) + tuple(w.shape[1:]))
    n = w.shape[0]
    pad = normalize_padding_idx(fw_attrs.get("padding_idx", -1), n)
    drop = rows == pad if pad != -1 else torch.zeros_like(rows, dtype=bool)
    if fw_attrs.get("is_sparse", False):
        if pad != -1:
            values = values.masked_fill(
                drop.reshape((-1,) + (1,) * (values.ndim - 1)), 0.0)
        return {"W@GRAD": [SelectedRows(rows, values, n)]}
    rows = torch.where(rows < 0, rows + n, rows)
    drop = drop | (rows < 0) | (rows >= n)
    values = values.masked_fill(
        drop.reshape((-1,) + (1,) * (values.ndim - 1)), 0.0)
    dense = torch.zeros((n,) + tuple(w.shape[1:]), dtype=values.dtype,
                        device=values.device)
    return {"W@GRAD": [dense.index_add(0, rows.clamp(0, n - 1), values)]}


@register("sigmoid_cross_entropy_with_logits")
def sigmoid_cross_entropy_with_logits(ins, attrs):
    """Elementwise max(x, 0) - x·label + log(1 + exp(-|x|)) (the
    reference's nn_ops.py:605): 0 where the label equals ``ignore_index``;
    with ``normalize``, divided by the count of labels not ignored."""
    x = first(ins, "X")
    label = first(ins, "Label")
    ignore = attrs.get("ignore_index", -100)
    loss = torch.clamp_min(x, 0) - x * label + \
        torch.log1p(torch.exp(-torch.abs(x)))
    loss = torch.where(label == ignore, torch.zeros_like(loss), loss)
    if attrs.get("normalize", False):
        norm = torch.clamp_min((label != ignore).to(x.dtype).sum(), 1.0)
        loss = loss / norm
    return as_out(loss)


@register("one_hot", not_differentiable=True)
def one_hot(ins, attrs):
    """Ids [..., 1] or [...] -> float32 [..., depth] (the reference's
    :584): one fp32 zero plane and a scatter of one value a row, so no
    int64 or bool [..., depth] plane is made on the way; an id outside
    [0, depth) gives a zero row, as jax.nn.one_hot does."""
    x = first(ins, "X")
    depth = attrs["depth"]
    idx = (x.reshape(x.shape[:-1]) if x.shape[-1] == 1 else x).long()
    valid = (idx >= 0) & (idx < depth)
    out = torch.zeros(tuple(idx.shape) + (depth,), dtype=torch.float32,
                      device=x.device)
    return as_out(out.scatter_(-1, idx.clamp(0, depth - 1).unsqueeze(-1),
                               valid.float().unsqueeze(-1)))


@register("label_smooth")
def label_smooth(ins, attrs):
    """(1 - eps)·X + eps·PriorDist, or + eps / depth with no prior (the
    reference's :593)."""
    x = first(ins, "X")
    eps = attrs.get("epsilon", 0.1)
    dist = first(ins, "PriorDist")
    if dist is not None:
        return as_out((1 - eps) * x + eps * dist)
    return as_out((1 - eps) * x + eps / x.shape[-1])


@register("square_error_cost")
def square_error_cost(ins, attrs):
    return as_out(torch.square(first(ins, "X") - first(ins, "Y")))


@register("norm")
def norm(ins, attrs):
    """X / sqrt(sum(X², axis) + epsilon), with that norm as Norm."""
    x = first(ins, "X")
    nrm = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", -1),
                               keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": [x / nrm], "Norm": [nrm]}


@register("l2_normalize")
def l2_normalize(ins, attrs):
    return {"Out": norm(ins, attrs)["Out"]}


@register("smooth_l1_loss")
def smooth_l1_loss(ins, attrs):
    """Per-row sum of 0.5·σ²·d² where |d| < 1/σ², |d| - 0.5/σ² elsewhere,
    d = X - Y: Out [N, 1] and Diff."""
    x, y = first(ins, "X"), first(ins, "Y")
    s2 = attrs.get("sigma", 1.0) ** 2
    diff = x - y
    ad = tie_abs(diff)
    elem = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    return {"Out": [elem.reshape(x.shape[0], -1).sum(dim=1, keepdim=True)],
            "Diff": [diff]}


@register("hierarchical_sigmoid")
def hierarchical_sigmoid(ins, attrs):
    """Summed sigmoid cross entropy along the label's path in the default
    complete binary tree over C classes (SimpleCode: code = label + C;
    the node at depth d is (code >> (d + 1)) - 1 and its bit (code >> d)
    & 1; depths past the code's length count 0): X [N, D], W [C - 1, D],
    optional Bias [C - 1].  Out [N, 1] and PreOut [N, depth], the path's
    logits.  O(D log C) a row."""
    import math

    x = first(ins, "X")
    w = first(ins, "W")
    bias = first(ins, "Bias")
    c = int(attrs["num_classes"])
    label = squeeze_ids(first(ins, "Label")).reshape(-1).long()
    depth = max(int(math.ceil(math.log2(c))), 1)
    code = label + c
    ds = torch.arange(depth, device=x.device)
    node = (code[:, None] >> (ds[None, :] + 1)) - 1         # [N, depth]
    valid = node >= 0
    node = node.clamp_min(0)
    bit = ((code[:, None] >> ds[None, :]) & 1).to(x.dtype)
    logits = torch.einsum("nd,ntd->nt", x, w[node])
    if bias is not None:
        logits = logits + bias.reshape(-1)[node]
    ce = tie_max(logits, 0.0) - logits * bit + \
        torch.log1p(torch.exp(-tie_abs(logits)))
    loss = torch.where(valid, ce, torch.zeros_like(ce)).sum(dim=1,
                                                           keepdim=True)
    return {"Out": [loss], "PreOut": [logits]}


@register("prelu")
def prelu(ins, attrs):
    """x where x > 0, else alpha · x, alpha one value (``all``), one a
    channel (``channel``) or one an element of a sample (``element``)."""
    x = first(ins, "X")
    alpha = first(ins, "Alpha")
    mode = attrs.get("mode", "all")
    if mode == "all":
        a = alpha.reshape(())
    elif mode == "channel":
        a = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    else:
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    return as_out(torch.where(x > 0, x, a * x))
