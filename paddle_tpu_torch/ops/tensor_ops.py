"""Tensor manipulation + initialization kernels (port of
``paddle_tpu/ops/tensor_ops.py``): the ops the BERT inference and
training programs and their startup programs emit, the RNN slice's
``concat`` and ``fill_constant_batch_size_like``, and the control-flow
slice's ``expand``, ``where``, ``increment`` and ``stack``, and the
shape, index and selection ops the front end's layers emit
(``fill_zeros_like`` ... ``row_conv``).

Reference: ``fill_constant_op.cc``, ``fill_any_like_op.cc``,
``fill_constant_batch_size_like_op.cc``, ``assign_op.cc``,
``uniform_random_op.cc``, ``gaussian_random_op.cc``,
``truncated_gaussian_random_op.cc``, ``assign_value_op.cc``,
``reshape_op.cc``, ``transpose_op.cc``, ``cast_op.cc``, ``concat_op.cc``,
``gather_op.cc``, ``slice_op.cc``, ``expand_op.cc``, ``where_op.cc``,
``increment_op.cc``, ``stack_op.cc``, ``fill_zeros_like_op.cc``,
``squeeze_op.cc``, ``unsqueeze_op.cc``, ``flatten_op.cc``,
``scatter_op.cc``, ``range_op.cc``, ``shape_op.cc``, ``reverse_op.cc``,
``argsort_op.cc``, ``sampling_id_op.cc``, ``multiplex_op.cc``,
``selu_op.cc``, ``is_empty_op.cc``, ``row_conv_op.cc``.

Integer outputs (``shape``'s, ``argsort``'s indices, ``sampling_id``'s
ids) keep the values of the JAX package, whose 64-bit types run as
32-bit; the port's dtypes are the IR's.
"""

import numpy as np
import torch

from .registry import (register, first, as_out, current, generator_for,
                       np_dtype, op_seed, torch_dtype, uniforms)


def _random(attrs, draw):
    """Draw a float32 tensor of attrs['shape'] on the run's device with
    the op's generator, then cast to the IR dtype."""
    ctx = current()
    shape = tuple(attrs["shape"])
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    draw(out, generator_for(attrs))
    return as_out(out.to(torch_dtype(attrs.get("dtype", "float32"))))


@register("fill_constant", not_differentiable=True)
def fill_constant(ins, attrs):
    return as_out(torch.full(tuple(attrs.get("shape", ())),
                             attrs.get("value", 0.0),
                             dtype=torch_dtype(attrs.get("dtype", "float32")),
                             device=current().device))


@register("fill_any_like", not_differentiable=True)
def fill_any_like(ins, attrs):
    x = first(ins, "X")
    dtype = attrs.get("dtype")
    dtype = x.dtype if dtype in (None, -1) else torch_dtype(dtype)
    return as_out(torch.full_like(x, attrs.get("value", 0.0), dtype=dtype))


@register("fill_constant_batch_size_like", not_differentiable=True)
def fill_constant_batch_size_like(ins, attrs):
    ref = first(ins, "Input")
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = ref.shape[
        attrs.get("input_dim_idx", 0)]
    return as_out(torch.full(tuple(shape), attrs.get("value", 0.0),
                             dtype=torch_dtype(attrs.get("dtype", "float32")),
                             device=ref.device))


@register("assign")
def assign(ins, attrs):
    return as_out(first(ins, "X"))


@register("uniform_random", not_differentiable=True, generator=True)
def uniform_random(ins, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    return _random(attrs, lambda t, g: t.uniform_(lo, hi, generator=g))


@register("gaussian_random", not_differentiable=True, generator=True)
def gaussian_random(ins, attrs):
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    return _random(attrs, lambda t, g: t.normal_(mean, std, generator=g))


@register("truncated_gaussian_random", not_differentiable=True,
          generator=True)
def truncated_gaussian_random(ins, attrs):
    # truncated at two standard deviations, as jax.random.truncated_normal
    # (-2, 2) in the reference
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)

    def draw(t, g):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
        t.mul_(std).add_(mean)

    return _random(attrs, draw)


@register("assign_value", not_differentiable=True)
def assign_value(ins, attrs):
    vals = np.array(attrs["values"],
                    dtype=np_dtype(attrs.get("dtype", "float32")))
    t = torch.from_numpy(vals.reshape(tuple(attrs["shape"])))
    return as_out(t.to(device=current().device,
                       dtype=torch_dtype(attrs.get("dtype", "float32"))))


@register("cast")
def cast(ins, attrs):
    return as_out(first(ins, "X").to(torch_dtype(attrs["out_dtype"])))


@register("reshape")
def reshape(ins, attrs):
    x = first(ins, "X")
    # fluid: 0 copies the input dim, -1 is inferred
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return as_out(x.reshape(shape))


def _xshape(x):
    return torch.zeros((0,) + tuple(x.shape), dtype=x.dtype,
                       device=x.device)


@register("reshape2")
def reshape2(ins, attrs):
    return {"Out": reshape(ins, attrs)["Out"],
            "XShape": [_xshape(first(ins, "X"))]}


@register("transpose")
def transpose(ins, attrs):
    return as_out(first(ins, "X").permute(*attrs["axis"]))


@register("transpose2")
def transpose2(ins, attrs):
    return {"Out": transpose(ins, attrs)["Out"],
            "XShape": [_xshape(first(ins, "X"))]}


def take_rows(table, idx):
    """``jnp.take(table, idx, axis=0)`` semantics on any device: negative
    ids wrap once, ids out of range give NaN rows (jnp.take's fill mode)
    — never a device-side assert that would poison the CUDA context."""
    n = table.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = table[idx.clamp(0, n - 1)]
    if out.is_floating_point():
        valid = valid.reshape(valid.shape + (1,) * (out.ndim - valid.ndim))
        out = torch.where(valid, out, torch.full_like(out, float("nan")))
    return out


@register("concat")
def concat(ins, attrs):
    return as_out(torch.cat(ins["X"], dim=attrs.get("axis", 0)))


@register("split")
def split(ins, attrs):
    x = first(ins, "X")
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        parts = torch.split(x, list(sections), dim=axis)
    else:
        num = attrs.get("num", 0)
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {axis} of size {x.shape[axis]} "
                             f"does not split into {num} equal parts")
        parts = torch.split(x, x.shape[axis] // num, dim=axis)
    return {"Out": list(parts)}


@register("gather")
def gather(ins, attrs):
    return as_out(take_rows(first(ins, "X"), first(ins, "Index")))


@register("slice")
def slice_op(ins, attrs):
    x = first(ins, "Input")
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    for a in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = out.squeeze(a)
    return as_out(out)


@register("stack")
def stack(ins, attrs):
    return {"Y": [torch.stack(ins["X"], dim=attrs.get("axis", 0))]}


@register("expand")
def expand(ins, attrs):
    """Tile X by ``expand_times`` (``jnp.tile``: fewer factors than dims
    leave the leading dims as they are)."""
    x = first(ins, "X")
    times = [int(t) for t in attrs["expand_times"]]
    times = [1] * (x.dim() - len(times)) + times
    return as_out(x.repeat(*times))


@register("where")
def where(ins, attrs):
    return as_out(torch.where(first(ins, "Condition"), first(ins, "X"),
                              first(ins, "Y")))


@register("increment")
def increment(ins, attrs):
    """X + step in X's dtype: a loop counter stays an integer.  A new
    tensor every time, even under ``in_place`` (Out named as X): the
    tensor bound to X may be shared with another name or held by an
    array."""
    x = first(ins, "X")
    step = attrs.get("step", 1.0)
    return as_out(x + (step if x.is_floating_point() else int(step)))


@register("fill_zeros_like", not_differentiable=True)
def fill_zeros_like(ins, attrs):
    return as_out(torch.zeros_like(first(ins, "X")))


@register("squeeze")
def squeeze(ins, attrs):
    x = first(ins, "X")
    axes = attrs.get("axes", [])
    if axes:
        return as_out(x.squeeze(tuple(a % x.ndim for a in axes)))
    return as_out(x.squeeze())


@register("unsqueeze")
def unsqueeze(ins, attrs):
    x = first(ins, "X")
    for a in sorted(attrs["axes"]):
        x = x.unsqueeze(a)
    return as_out(x)


@register("flatten")
def flatten(ins, attrs):
    x = first(ins, "X")
    d0 = 1
    for s in x.shape[:attrs.get("axis", 1)]:
        d0 *= s
    return as_out(x.reshape(d0, -1))


@register("scatter")
def scatter(ins, attrs):
    """Rows `Ids` of X replaced by (``overwrite``) or added to `Updates`."""
    x = first(ins, "X")
    ids = first(ins, "Ids").long().reshape(-1)
    upd = first(ins, "Updates")
    return as_out(x.index_put((ids,), upd.to(x.dtype),
                              accumulate=not attrs.get("overwrite", True)))


@register("range", not_differentiable=True, host_read=True)
def range_op(ins, attrs):
    """arange(Start, End, Step) in Start's dtype.  Its length depends on
    the three values, which are read on the host."""
    start, end, step = (first(ins, s) for s in ("Start", "End", "Step"))
    lo, hi, st = (float(v.reshape(())) for v in (start, end, step))
    return as_out(torch.arange(lo, hi, st, dtype=torch.float64,
                               device=start.device).to(start.dtype))


@register("shape", not_differentiable=True)
def shape_op(ins, attrs):
    """X's shape as int32, made by fills on X's device (a copy from the
    host could not be captured)."""
    x = first(ins, "Input")
    return as_out(torch.stack(
        [torch.full((), d, dtype=torch.int32, device=x.device)
         for d in x.shape]) if x.ndim else
        torch.zeros(0, dtype=torch.int32, device=x.device))


@register("reverse")
def reverse(ins, attrs):
    return as_out(torch.flip(first(ins, "X"), dims=tuple(attrs["axis"])))


@register("argsort", not_differentiable=True)
def argsort(ins, attrs):
    """Ascending stable sort along `axis`: equal values keep their order,
    as ``jnp.argsort``'s."""
    x = first(ins, "X")
    out, idx = torch.sort(x, dim=attrs.get("axis", -1), stable=True)
    return {"Out": [out], "Indices": [idx]}


# Philox stream tag of sampling_id's draw (registry.uniforms)
_TAG_SAMPLING_ID = 1


@register("sampling_id", not_differentiable=True)
def sampling_id(ins, attrs):
    """One id per row of X [N, C], drawn with probability proportional to
    max(x, 1e-20): the reference's categorical over log(max(x, 1e-20)).
    The uniform of row i is element i of the op's Philox draw
    (``registry.uniforms``), and the id the first whose cumulative
    probability, scaled by the row's total, exceeds it."""
    x = first(ins, "X")
    p = torch.clamp_min(x.float(), 1e-20)
    u = uniforms(op_seed(attrs), (x.shape[0],), x.device, _TAG_SAMPLING_ID)
    cum = torch.cumsum(p, dim=-1)
    hit = cum > (u * cum[:, -1]).unsqueeze(1)
    return as_out(torch.argmax(hit.to(torch.uint8), dim=-1))


@register("multiplex")
def multiplex(ins, attrs):
    ids = first(ins, "Ids").reshape(-1).long()
    xs = torch.stack(ins["X"], dim=0)                    # [K, N, D]
    rows = torch.arange(xs.shape[1], device=xs.device)
    return as_out(xs[ids, rows])


@register("selu")
def selu(ins, attrs):
    x = first(ins, "X")
    scale = attrs.get("scale", 1.0507009873554805)
    alpha = attrs.get("alpha", 1.6732632423543772)
    return as_out(scale * torch.where(x > 0, x, alpha * (torch.exp(x) - 1)))


@register("is_empty", not_differentiable=True)
def is_empty(ins, attrs):
    x = first(ins, "X")
    return as_out(torch.full((), x.numel() == 0, dtype=torch.bool,
                             device=x.device))


@register("row_conv")
def row_conv(ins, attrs):
    """Lookahead row convolution over X [N, T, D] with Filter [k, D]:
    out[t] = sum_j x[t + j] * f[j], zero past the end."""
    x = first(ins, "X")
    f = first(ins, "Filter")
    k, t = f.shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, 0, k - 1))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + pad[:, j:j + t, :] * f[j]
    return as_out(out)
