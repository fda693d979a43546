"""Dense math kernels (port of ``paddle_tpu/ops/math_ops.py``):
elementwise ops with fluid's ``axis`` broadcast and the custom
``elementwise_add`` grad, mul/matmul, sum, the activations and reductions
on the BERT serving and training paths and the RNN slice (``sigmoid``,
the length-masked ``mean`` of a lod input).

Reference op semantics: ``paddle/fluid/operators/elementwise/``,
``mul_op.cc``, ``matmul_op.cc``, ``activation_op.cc``, ``scale_op.cc``,
``mean_op.cc``, ``reduce_ops/``, ``sum_op.cc``.  The matrix products go
to torch.matmul (cuBLAS on the card), as the JAX package left them to
XLA.
"""

import torch

from .registry import register, register_grad, first, as_out
from .sequence_kernels import length_mask


def _bcast_y(x, y, axis):
    """Fluid broadcast: y's dims align to x starting at `axis`
    (elementwise_op_function.h); axis=-1 aligns trailing dims."""
    if x.ndim == y.ndim:
        return y
    if axis == -1 or axis is None:
        axis = x.ndim - y.ndim
    return y.reshape((1,) * axis + tuple(y.shape)
                     + (1,) * (x.ndim - axis - y.ndim))


def _ew(fn):
    def kernel(ins, attrs):
        x, y = first(ins, "X"), first(ins, "Y")
        return as_out(fn(x, _bcast_y(x, y, attrs.get("axis", -1))))
    return kernel


register("elementwise_add")(_ew(torch.add))


@register_grad("elementwise_add")
def elementwise_add_grad(ins, attrs):
    """dX = og (X never broadcasts in fluid's rule,
    elementwise_op_function.h); dY = og summed in fp32 over Y's broadcast
    dims (the reference's custom grad, math_ops.py:41)."""
    fw_attrs = attrs["fw_attrs"]
    x, y = first(ins, "X"), first(ins, "Y")
    og = first(ins, "Out@GRAD_OUT")
    axis = fw_attrs.get("axis", -1)
    needs = {s for s, _ in attrs["needs_input_grad"]}
    outs = {}
    if "X" in needs:
        outs["X@GRAD"] = [og.to(x.dtype)]
    if "Y" in needs:
        if y.shape == og.shape:
            outs["Y@GRAD"] = [og.to(y.dtype)]
        else:
            ax = og.ndim - y.ndim if axis in (-1, None) else axis
            # dims outside Y's span, plus size-1 dims INSIDE the span
            # that the forward broadcast (e.g. a (2,1) Y against (2,3))
            red = tuple(range(ax)) + tuple(range(ax + y.ndim, og.ndim)) \
                + tuple(ax + i for i, d in enumerate(y.shape)
                        if d == 1 and og.shape[ax + i] != 1)
            dy = og.float().sum(dim=red) if red else og.float()
            outs["Y@GRAD"] = [dy.to(y.dtype).reshape(y.shape)]
    return outs
register("elementwise_sub")(_ew(torch.sub))
register("elementwise_mul")(_ew(torch.mul))
register("elementwise_div")(_ew(torch.div))
register("elementwise_max")(_ew(torch.maximum))
register("elementwise_min")(_ew(torch.minimum))
register("elementwise_pow")(_ew(torch.pow))


@register("scale")
def scale(ins, attrs):
    x = first(ins, "X")
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return as_out(x * s + b)
    return as_out((x + b) * s)


@register("sum")
def sum_op(ins, attrs):
    """Sum of the inputs.  SelectedRows inputs (the partial grads of a
    table looked up twice) concatenate their row sets, duplicates
    accumulating when the update applies them; mixed with dense inputs
    they are densified first."""
    from ..core.selected_rows import SelectedRows, is_selected_rows

    xs = ins["X"]
    if any(is_selected_rows(x) for x in xs):
        if all(is_selected_rows(x) for x in xs):
            return as_out(SelectedRows(
                torch.cat([x.rows for x in xs]),
                torch.cat([x.values for x in xs]), xs[0].height))
        xs = [x.to_dense() if is_selected_rows(x) else x for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return as_out(out)


def _prod(t):
    r = 1
    for v in t:
        r *= v
    return r


@register("mul")
def mul(ins, attrs):
    """out = flatten2d(X) @ flatten2d(Y)  (mul_op.cc)."""
    x, y = first(ins, "X"), first(ins, "Y")
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    xm = x.reshape(_prod(xs[:xnc]), _prod(xs[xnc:]))
    ym = y.reshape(_prod(ys[:ync]), _prod(ys[ync:]))
    return as_out((xm @ ym).reshape(xs[:xnc] + ys[ync:]))


@register("matmul")
def matmul(ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    if attrs.get("transpose_X", False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return as_out(out)


def _unary(fn):
    def kernel(ins, attrs):
        return as_out(fn(first(ins, "X")))
    return kernel


register("relu")(_unary(torch.relu))
register("sigmoid")(_unary(torch.sigmoid))
register("tanh")(_unary(torch.tanh))
# exact erf form, as jax.nn.gelu(approximate=False) in the reference
register("gelu")(_unary(
    lambda x: torch.nn.functional.gelu(x, approximate="none")))


@register("mean")
def mean(ins, attrs):
    x = first(ins, "X")
    lens = first(ins, "SeqLen")
    if lens is not None and x.dim() >= 2:
        # lod input [B, T, ...]: mask pads and average valid tokens only
        valid = length_mask(lens, x.shape[1], x.dtype)
        masked = x * valid.reshape(tuple(valid.shape) + (1,) * (x.dim() - 2))
        denom = lens.sum().clamp_min(1).to(x.dtype) * _prod(x.shape[2:])
        return as_out(masked.sum() / denom)
    return as_out(torch.mean(x))


def _reduce(fn):
    def kernel(ins, attrs):
        x = first(ins, "X")
        dims = attrs.get("dim", [0])
        if isinstance(dims, int):
            dims = [dims]
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False) or dims is None:
            dims = list(range(x.ndim))    # dim=None reduces everything
        axis = tuple(d % x.ndim for d in dims)
        return as_out(fn(x, dim=axis, keepdim=keep))
    return kernel


register("reduce_sum")(_reduce(torch.sum))
