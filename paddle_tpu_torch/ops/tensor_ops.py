"""Tensor manipulation + initialization kernels (port of
``paddle_tpu/ops/tensor_ops.py``): the ops the BERT inference and
training programs and their startup programs emit, and the RNN slice's
``concat`` and ``fill_constant_batch_size_like``.

Reference: ``fill_constant_op.cc``, ``fill_any_like_op.cc``,
``fill_constant_batch_size_like_op.cc``, ``assign_op.cc``,
``uniform_random_op.cc``, ``gaussian_random_op.cc``,
``truncated_gaussian_random_op.cc``, ``assign_value_op.cc``,
``reshape_op.cc``, ``transpose_op.cc``, ``cast_op.cc``, ``concat_op.cc``,
``gather_op.cc``, ``slice_op.cc``.
"""

import numpy as np
import torch

from .registry import (register, first, as_out, current, generator_for,
                       np_dtype, torch_dtype)


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


@register("uniform_random", not_differentiable=True)
def uniform_random(ins, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    return _random(attrs, lambda t, g: t.uniform_(lo, hi, generator=g))


@register("gaussian_random", not_differentiable=True)
def gaussian_random(ins, attrs):
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    return _random(attrs, lambda t, g: t.normal_(mean, std, generator=g))


@register("truncated_gaussian_random", not_differentiable=True)
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
