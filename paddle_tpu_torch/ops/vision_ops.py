"""Vision and image kernels (port of ``paddle_tpu/ops/vision_ops.py``):
channel affine and group norm, LRN, maxout, bilinear and nearest
interpolation, crop and pad, space-to-depth and channel shuffle, 3-D
convolution and pooling, the affine grid and its sampler, and random
crop.

Reference semantics: ``paddle/fluid/operators/`` — ``affine_channel_op.cc``,
``group_norm_op.cc``, ``lrn_op.cc``, ``maxout_op.cc``, ``interpolate_op.cc``
(bilinear_interp / nearest_interp, align_corners), ``crop_op.cc``,
``pad_constant_like_op.cc``, ``space_to_depth_op.cc``,
``shuffle_channel_op.cc``, ``conv_op.cc`` / ``pool_op.cc`` (conv3d,
pool3d), ``affine_grid_op.cc``, ``grid_sampler_op.cc``,
``random_crop_op.cc``.

``conv3d`` and ``pool3d`` go to ``F.conv3d`` (cuDNN on the card) and
torch's 3-D pools, as the JAX package left them to XLA.  The
interpolation grids are computed in float32 with the JAX package's own
arithmetic (:func:`_linspace` is ``jnp.linspace``'s), so a floor or a
round lands on the same source pixel.  ``random_crop`` draws its offsets
in the op from the op's Philox stream (``registry.uniforms``) and slices
with device indices, so no value is read on the host.
"""

import torch
import torch.nn.functional as F

from .registry import register, first, as_out, op_seed, uniforms


def _linspace(start, stop, num, device):
    """``jnp.linspace(start, stop, num)`` in float32: start·(1 - s) +
    stop·s with s = i / (num - 1), and the last point `stop` itself."""
    if num == 1:
        return torch.full((1,), float(start), device=device)
    div = num - 1
    s = torch.arange(div, dtype=torch.float32, device=device) / div
    out = start * (1 - s) + stop * s
    return torch.cat([out, torch.full((1,), float(stop), device=device)])


def _channel_shape(x, layout="NCHW"):
    shape = [1] * x.ndim
    c_axis = 1 if layout == "NCHW" else x.ndim - 1
    shape[c_axis] = x.shape[c_axis]
    return shape


@register("affine_channel")
def affine_channel(ins, attrs):
    x = first(ins, "X")
    shape = _channel_shape(x, attrs.get("data_layout", "NCHW"))
    return as_out(x * first(ins, "Scale").reshape(shape)
                  + first(ins, "Bias").reshape(shape))


@register("group_norm")
def group_norm(ins, attrs):
    """Normalize each of ``groups`` channel groups of X (NCHW) by its
    mean and population variance, then the per-channel Scale and Bias.
    Mean and Variance [N, groups]."""
    x = first(ins, "X")
    scale, bias = first(ins, "Scale"), first(ins, "Bias")
    groups = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    g = x.reshape(n, groups, c // groups, *x.shape[2:])
    axes = tuple(range(2, g.ndim))
    mean = g.mean(dim=axes, keepdim=True)
    var = torch.square(g - mean).mean(dim=axes, keepdim=True)
    y = ((g - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = [1, c] + [1] * (x.ndim - 2)
    if scale is not None:
        y = y * scale.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return {"Y": [y], "Mean": [mean.reshape(n, groups)],
            "Variance": [var.reshape(n, groups)]}


@register("lrn")
def lrn(ins, attrs):
    """Cross-channel LRN over X (NCHW): MidOut is the sum of squares over
    a window of n channels (n // 2 before, the rest after), and Out =
    X / (k + alpha · MidOut) ^ beta."""
    x = first(ins, "X")
    n = attrs.get("n", 5)
    half = n // 2
    sq = F.pad(torch.square(x), (0, 0, 0, 0, half, n - 1 - half))
    c = x.shape[1]
    mid = sq[:, 0:c]
    for j in range(1, n):
        mid = mid + sq[:, j:j + c]
    div = torch.pow(attrs.get("k", 2.0) + attrs.get("alpha", 1e-4) * mid,
                    attrs.get("beta", 0.75))
    return {"Out": [x / div], "MidOut": [mid]}


@register("maxout")
def maxout(ins, attrs):
    """The max of each run of ``groups`` channels (``torch.amax``: equal
    maxima share the gradient, as ``jnp.max``'s do)."""
    x = first(ins, "X")
    groups = attrs.get("groups", 2)
    n, c = x.shape[0], x.shape[1]
    return as_out(torch.amax(
        x.reshape(n, c // groups, groups, *x.shape[2:]), dim=2))


def _interp_size(ins, attrs):
    if first(ins, "OutSize") is not None:
        raise NotImplementedError(
            "a dynamic OutSize is not supported; set out_h/out_w")
    return attrs["out_h"], attrs["out_w"]


def _bilinear_src(n_out, n_in, align, device):
    if align and n_out > 1:
        return _linspace(0.0, n_in - 1.0, n_out, device)
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * (n_in / n_out) - 0.5
    return torch.clamp_min(pos, 0.0)


@register("bilinear_interp")
def bilinear_interp(ins, attrs):
    x = first(ins, "X")                            # NCHW
    oh, ow = _interp_size(ins, attrs)
    align = attrs.get("align_corners", True)
    h, w = x.shape[2], x.shape[3]
    ys = _bilinear_src(oh, h, align, x.device)
    xs = _bilinear_src(ow, w, align, x.device)
    y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
    y1, x1 = (y0 + 1).clamp_max(h - 1), (x0 + 1).clamp_max(w - 1)
    wy = (ys - y0).to(x.dtype)[None, None, :, None]
    wx = (xs - x0).to(x.dtype)[None, None, None, :]

    def g(yi, xi):
        return x[:, :, yi, :][:, :, :, xi]

    out = (g(y0, x0) * (1 - wy) * (1 - wx) + g(y1, x0) * wy * (1 - wx)
           + g(y0, x1) * (1 - wy) * wx + g(y1, x1) * wy * wx)
    return as_out(out.to(x.dtype))


@register("nearest_interp")
def nearest_interp(ins, attrs):
    """Nearest source pixel: round(linspace) with ``align_corners`` (and
    out_h > 1, which decides both axes, as in the reference), else
    floor(i · in / out)."""
    x = first(ins, "X")
    oh, ow = _interp_size(ins, attrs)
    h, w = x.shape[2], x.shape[3]
    dev = x.device
    if attrs.get("align_corners", True) and oh > 1:
        yi = torch.round(_linspace(0.0, h - 1.0, oh, dev)).long()
        xi = torch.round(_linspace(0.0, w - 1.0, ow, dev)).long()
    else:
        yi = (torch.arange(oh, dtype=torch.float32, device=dev)
              * (h / oh)).long().clamp_max(h - 1)
        xi = (torch.arange(ow, dtype=torch.float32, device=dev)
              * (w / ow)).long().clamp_max(w - 1)
    return as_out(x[:, :, yi, :][:, :, :, xi])


@register("crop")
def crop(ins, attrs):
    """The window of ``shape`` (or Y's shape) at ``offsets``, each offset
    clamped so the window fits (``lax.dynamic_slice``'s rule)."""
    x = first(ins, "X")
    shape = attrs.get("shape")
    y = first(ins, "Y")
    if shape is None and y is not None:
        shape = y.shape
    out = x
    for d, (off, size) in enumerate(zip(attrs["offsets"], shape)):
        off = min(max(int(off), 0), x.shape[d] - size)
        out = out.narrow(d, off, size)
    return as_out(out)


@register("pad_constant_like")
def pad_constant_like(ins, attrs):
    """Y padded at the end of each dim to X's shape with ``pad_value``."""
    x, y = first(ins, "X"), first(ins, "Y")
    pads = []
    for xd, yd in reversed(list(zip(x.shape, y.shape))):
        pads += [0, xd - yd]
    return as_out(F.pad(y, pads, value=attrs.get("pad_value", 0.0)))


@register("space_to_depth")
def space_to_depth(ins, attrs):
    x = first(ins, "X")
    bs = attrs.get("blocksize", 2)
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // bs, bs, w // bs, bs)
    return as_out(out.permute(0, 3, 5, 1, 2, 4).reshape(
        n, c * bs * bs, h // bs, w // bs))


@register("shuffle_channel")
def shuffle_channel(ins, attrs):
    x = first(ins, "X")
    group = attrs.get("group", 1)
    n, c, h, w = x.shape
    return as_out(x.reshape(n, group, c // group, h, w).transpose(1, 2)
                  .reshape(n, c, h, w))


@register("conv3d")
def conv3d(ins, attrs):
    """NCDHW input, OIDHW filter (cuDNN on the card)."""
    return {"Output": [F.conv3d(
        first(ins, "Input"), first(ins, "Filter"),
        stride=tuple(attrs.get("strides", [1, 1, 1])),
        padding=tuple(attrs.get("paddings", [0, 0, 0])),
        dilation=tuple(attrs.get("dilations", [1, 1, 1])),
        groups=attrs.get("groups", 1))]}


@register("pool3d")
def pool3d(ins, attrs):
    """Max or average 3-D pooling of NCDHW; ``exclusive`` averages count
    only the window's cells inside the input."""
    x = first(ins, "X")
    ksize = list(attrs.get("ksize", [2, 2, 2]))
    strides = list(attrs.get("strides", ksize))
    pads = list(attrs.get("paddings", [0, 0, 0]))
    if attrs.get("global_pooling", False):
        ksize = strides = list(x.shape[2:])
        pads = [0, 0, 0]
    if attrs.get("pooling_type", "max") == "max":
        return as_out(F.max_pool3d(x, ksize, strides, pads))
    return as_out(F.avg_pool3d(
        x, ksize, strides, pads,
        count_include_pad=not attrs.get("exclusive", True)))


@register("affine_grid")
def affine_grid(ins, attrs):
    """Theta [N, 2, 3] over the [-1, 1]² grid of ``output_shape``'s
    H × W -> Output [N, H, W, 2] (x, y)."""
    theta = first(ins, "Theta")
    out_shape = attrs.get("output_shape")
    if not out_shape:
        raise NotImplementedError("affine_grid needs a static output_shape")
    h, w = out_shape[2], out_shape[3]
    gy, gx = torch.meshgrid(_linspace(-1.0, 1.0, h, theta.device),
                            _linspace(-1.0, 1.0, w, theta.device),
                            indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).to(
        theta.dtype)
    return {"Output": [torch.einsum("hwk,njk->nhwj", base, theta)]}


@register("grid_sampler")
def grid_sampler(ins, attrs):
    """Bilinear samples of X (NCHW) at Grid [N, H', W', 2] in [-1, 1]
    (corners aligned), source indices clamped into the image."""
    x = first(ins, "X")
    grid = first(ins, "Grid")
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0, gy - y0
    x0, y0 = x0.long(), y0.long()
    img = x.permute(0, 2, 3, 1)                    # [N, H, W, C]
    bidx = torch.arange(n, device=x.device).reshape(n, 1, 1)

    def gather(yi, xi):
        v = img[bidx, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return v.permute(0, 3, 1, 2)               # [N, C, H', W']

    out = (gather(y0, x0) * ((1 - wy) * (1 - wx))[:, None]
           + gather(y0 + 1, x0) * (wy * (1 - wx))[:, None]
           + gather(y0, x0 + 1) * ((1 - wy) * wx)[:, None]
           + gather(y0 + 1, x0 + 1) * (wy * wx)[:, None])
    return {"Output": [out.to(x.dtype)]}


# Philox stream tag of random_crop's offsets (registry.uniforms)
_TAG_RANDOM_CROP = 3


@register("random_crop")
def random_crop(ins, attrs):
    """A window of ``shape`` over X's trailing dims at one offset a dim,
    drawn uniformly from [0, dim - size] (the same for every leading
    index), sliced with index tensors on X's device."""
    x = first(ins, "X")
    shape = list(attrs["shape"])
    lead = x.ndim - len(shape)
    u = uniforms(op_seed(attrs), (len(shape),), x.device, _TAG_RANDOM_CROP)
    out = x
    for i, want in enumerate(shape):
        d = lead + i
        span = x.shape[d] - want + 1
        start = (u[i] * span).long().clamp_max(span - 1)
        idx = start + torch.arange(want, device=x.device)
        out = out.index_select(d, idx)
    return {"Out": [out]}
