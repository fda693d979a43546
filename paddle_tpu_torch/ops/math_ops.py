"""Dense math kernels (port of ``paddle_tpu/ops/math_ops.py``):
elementwise ops with fluid's ``axis`` broadcast and the custom
``elementwise_add`` grad, mul/matmul, sum, the activations and reductions
on the BERT serving and training paths and the RNN slice (``sigmoid``,
the length-masked ``mean`` of a lod input), ``log``, the comparison
and logical ops of the control-flow slice (bool outputs), ``exp``,
``floor``, ``ceil``, ``cos`` and ``pow``, the learning-rate schedules'
chain, and the rest of the reference's unary, clip, reduction and
elementwise ops (``sqrt`` ... ``isfinite``), which the front end's layers,
gradient clipping and ``L1Decay`` emit.

Gradients at ties follow the JAX package, not torch's defaults: the
reference's ``jnp.clip`` is a ``lax.max`` then a ``lax.min``, whose
derivatives split a tie in half, so ``clip``, ``relu6`` and
``hard_sigmoid`` here are ``torch.maximum`` then ``torch.minimum``
against tensor bounds (which split ties the same way), never
``torch.clamp`` (whose derivative is 1 at a bound); and ``reduce_max`` /
``reduce_min`` use ``torch.amax`` / ``torch.amin``, which share the
gradient evenly among equal extrema as ``jnp.max`` does.
``elementwise_mod`` takes the divisor's sign (``torch.remainder``, as
``jnp.mod``), and ``elementwise_floordiv`` floors.

Reference op semantics: ``paddle/fluid/operators/elementwise/``,
``mul_op.cc``, ``matmul_op.cc``, ``activation_op.cc``, ``scale_op.cc``,
``mean_op.cc``, ``reduce_ops/``, ``sum_op.cc``,
``controlflow/compare_op.cc``, ``controlflow/logical_op.cc``.  The matrix products go
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
register("elementwise_mod")(_ew(torch.remainder))
# a floor has no derivative: the quotient is made outside autograd, as
# the JAX package's is zero through its round
register("elementwise_floordiv")(_ew(
    lambda x, y: torch.floor_divide(x.detach(), y.detach())))


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


def tie_max(x, c):
    """``jnp.maximum(x, c)`` for a number `c`: against a tensor, so a tie
    splits its gradient in half (made by a fill on the device: a copy
    from the host could not be captured)."""
    return torch.maximum(x, torch.full((), c, dtype=x.dtype,
                                       device=x.device))


def tie_abs(x):
    """``jnp.abs``, whose derivative at 0 is 1 (torch's is 0)."""
    return torch.where(x >= 0, x, -x)


def tie_clip(x, lo, hi):
    """``jnp.clip``: :func:`tie_max` against `lo`, then the min against
    `hi` the same way."""
    return torch.minimum(tie_max(x, lo), torch.full(
        (), hi, dtype=x.dtype, device=x.device))


register("relu")(_unary(torch.relu))
register("sigmoid")(_unary(torch.sigmoid))
register("tanh")(_unary(torch.tanh))
register("square")(_unary(torch.square))
register("log")(_unary(torch.log))
# the learning-rate schedules' ops (layers/learning_rate_scheduler.py)
register("exp")(_unary(torch.exp))
register("floor")(_unary(torch.floor))
register("ceil")(_unary(torch.ceil))
register("cos")(_unary(torch.cos))


register("sqrt")(_unary(torch.sqrt))
register("rsqrt")(_unary(lambda x: 1.0 / torch.sqrt(x)))
register("abs")(_unary(tie_abs))
register("round")(_unary(torch.round))
register("reciprocal")(_unary(lambda x: 1.0 / x))
register("softsign")(_unary(lambda x: x / (tie_abs(x) + 1)))
register("softplus")(_unary(lambda x: torch.logaddexp(x, torch.zeros_like(x))))
register("sin")(_unary(torch.sin))
register("erf")(_unary(torch.erf))
register("logsigmoid")(_unary(torch.nn.functional.logsigmoid))


@register("pow")
def pow_op(ins, attrs):
    return as_out(torch.pow(first(ins, "X"), attrs.get("factor", 1.0)))


@register("leaky_relu")
def leaky_relu(ins, attrs):
    x = first(ins, "X")
    return as_out(torch.where(x > 0, x, attrs.get("alpha", 0.02) * x))


@register("elu")
def elu(ins, attrs):
    """``jax.nn.elu``: alpha·expm1(x) where x <= 0 (the expm1 of a
    zeroed argument elsewhere, so a large x never overflows)."""
    x = first(ins, "X")
    alpha = attrs.get("alpha", 1.0)
    pos = x > 0
    return as_out(torch.where(
        pos, x, alpha * torch.expm1(torch.where(pos, torch.zeros_like(x),
                                                x))))


@register("relu6")
def relu6(ins, attrs):
    return as_out(tie_clip(first(ins, "X"), 0.0,
                           attrs.get("threshold", 6.0)))


@register("hard_sigmoid")
def hard_sigmoid(ins, attrs):
    x = first(ins, "X")
    return as_out(tie_clip(x * attrs.get("slope", 0.2)
                           + attrs.get("offset", 0.5), 0.0, 1.0))


@register("swish")
def swish(ins, attrs):
    x = first(ins, "X")
    return as_out(x * torch.sigmoid(attrs.get("beta", 1.0) * x))


@register("clip")
def clip(ins, attrs):
    return as_out(tie_clip(first(ins, "X"), attrs["min"], attrs["max"]))


@register("clip_by_norm")
def clip_by_norm(ins, attrs):
    """x · max_norm / ‖x‖ where ‖x‖ > max_norm, with the norm floored at
    1e-12 in the division (the reference's guard)."""
    x = first(ins, "X")
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm, max_norm / tie_max(norm, 1e-12),
                        torch.ones_like(norm))
    return as_out(x * scale)


@register("squared_l2_norm")
def squared_l2_norm(ins, attrs):
    return as_out(torch.sum(torch.square(first(ins, "X"))).reshape(1))


@register("isfinite", not_differentiable=True)
def isfinite(ins, attrs):
    return as_out(torch.all(torch.isfinite(first(ins, "X"))).reshape(1))

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


def _prod_dims(x, dim, keepdim):
    """``jnp.prod`` over several dims (``torch.prod`` takes one): the
    reduced dims moved last and flattened."""
    keep = [d for d in range(x.ndim) if d not in dim]
    flat = x.permute(keep + list(dim)).reshape(
        [x.shape[d] for d in keep] + [-1])
    out = torch.prod(flat, dim=-1)
    if keepdim:
        out = out.reshape([1 if d in dim else x.shape[d]
                           for d in range(x.ndim)])
    return out


register("reduce_sum")(_reduce(torch.sum))
register("reduce_mean")(_reduce(torch.mean))
register("reduce_max")(_reduce(torch.amax))
register("reduce_min")(_reduce(torch.amin))
register("reduce_prod")(_reduce(_prod_dims))


# -- comparison / logical (controlflow/compare_op.cc) -----------------------

def _cmp(fn):
    def kernel(ins, attrs):
        x, y = first(ins, "X"), first(ins, "Y")
        return as_out(fn(x, _bcast_y(x, y, attrs.get("axis", -1))))
    return kernel


register("equal", not_differentiable=True)(_cmp(torch.eq))
register("not_equal", not_differentiable=True)(_cmp(torch.ne))
register("less_than", not_differentiable=True)(_cmp(torch.lt))
register("less_equal", not_differentiable=True)(_cmp(torch.le))
register("greater_than", not_differentiable=True)(_cmp(torch.gt))
register("greater_equal", not_differentiable=True)(_cmp(torch.ge))
register("logical_and", not_differentiable=True)(_cmp(torch.logical_and))
register("logical_or", not_differentiable=True)(_cmp(torch.logical_or))
register("logical_xor", not_differentiable=True)(_cmp(torch.logical_xor))


@register("logical_not", not_differentiable=True)
def logical_not(ins, attrs):
    return as_out(torch.logical_not(first(ins, "X")))


# -- the activation tail of layers/parity_extra.py (activation_op.cc) -------

@register("brelu")
def brelu(ins, attrs):
    """clip(x, t_min, t_max), the tie's gradient split as ``jnp.clip``'s."""
    return as_out(tie_clip(first(ins, "X"), attrs.get("t_min", 0.0),
                           attrs.get("t_max", 24.0)))


@register("stanh")
def stanh(ins, attrs):
    """b · tanh(a · x)."""
    x = first(ins, "X")
    return as_out(attrs.get("scale_b", 1.7159) *
                  torch.tanh(attrs.get("scale_a", 0.67) * x))


@register("soft_relu")
def soft_relu(ins, attrs):
    """log(1 + exp(clip(x, -t, t)))."""
    t = attrs.get("threshold", 40.0)
    return as_out(torch.log1p(torch.exp(tie_clip(first(ins, "X"), -t, t))))
