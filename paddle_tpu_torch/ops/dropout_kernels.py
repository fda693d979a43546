"""Fused dropout — the port of K10 of ``paddle_tpu/ops/pallas_kernels.py``:
``_dropout_kernel`` (:1405, reached through ``_dropout_call`` ->
``pl.pallas_call`` :1426 from ``fused_dropout`` :1454) becomes
``csrc/fused_dropout.cu``, written by hand for Hopper.

:func:`fused_dropout` ``(x, p, seed, upscale)`` is ``x · keep · s`` with
``s = 1/(1-p)`` (``upscale_in_train``) or 1 (``downgrade_in_infer``):
element i (row-major) is kept when word i % 4 of Philox4x32-10 at counter
(i // 4, 0, 0, 0) under key ``seed_key(seed)`` is below
``keep_threshold(p)`` — the bits of ``registry.dropout_keep``, drawn in
the kernel's registers; no mask tensor is written.  A
``registry.DeviceSeed`` hands the kernel its base key and the address of
the step word, and the kernel takes the key at that step (the same bits
as the int seed of that step), so a captured CUDA graph draws anew at
every replay.  The product is taken
in float32 with ``s`` rounded to float32 and the result rounded to the
element type (fp32 or bf16), so the kernel equals its plain version
:func:`fused_dropout_reference` bit for bit.  On a CUDA tensor it launches
K10 (counted in ``fused_dropout.launches``) or raises; on a CPU tensor it
runs the plain version.  Every shape runs: the TPU arm's n % 128 tiling
condition (:1466-1473) is not ported, by design.

Differentiable: the backward runs K10 on the cotangent with the same seed
(the reference's ``_dropout_fused_bwd``, :1445), since d(x·keep·s)/dx is
that same map.  The ``dropout`` op (``ops/nn_ops.py``) takes this arm in
training under ``FLAGS_use_fused_dropout`` on a CUDA tensor; its generic
grad runs K10 once on the cotangent instead of recomputing the forward.
The op's ``Mask`` output is made only when a later op or the fetch list
reads it, by one more launch over ones with ``upscale=False`` (what the
reference does, relying on XLA to drop the launch when nothing reads it).
"""

import ctypes

import numpy as np
import torch

from . import cuda_build
from .registry import dropout_keep, keep_threshold, launch_key

_SOURCE = "fused_dropout"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_libs = {}


def dropout_scale(p, upscale):
    """The kept elements' factor: float32 1/(1-p), or 1."""
    return float(np.float32(1.0 / (1.0 - p))) if upscale else 1.0


def fused_dropout_reference(x, p, seed, upscale=True, keep=None):
    """Plain version of K10 (the CPU path and the kernel's oracle):
    ``keep ? x·s : 0`` with the product in float32, rounded to x's type.
    `keep` is :func:`registry.dropout_keep` of (seed, x.shape, p), drawn
    here unless the caller holds it."""
    if keep is None:
        keep = dropout_keep(seed, tuple(x.shape), p, x.device)
    s = dropout_scale(p, upscale)
    y = x if s == 1.0 else (x.float() * s).to(x.dtype)
    return y.masked_fill(~keep, 0.0)


def _kernel():
    fn = _libs.get(_SOURCE)
    if fn is None:
        lib = cuda_build.load(_SOURCE)
        entry = lib.fused_dropout_fwd
        p, ll, i, u = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_uint)
        entry.argtypes = [p, p, ll, i, u, u, u, p, ctypes.c_float, i, p]
        entry.restype = ctypes.c_int
        lib.fused_dropout_error_string.argtypes = [ctypes.c_int]
        lib.fused_dropout_error_string.restype = ctypes.c_char_p
        fn = _libs[_SOURCE] = (entry, lib.fused_dropout_error_string)
    return fn


def fused_dropout_fwd(x, p, seed, upscale=True):
    """K10 on a CUDA tensor, its plain version on a CPU tensor; not
    differentiable."""
    cuda_build.refuse_export("K10 (fused_dropout)")
    if not 0.0 < p < 1.0:
        raise ValueError(f"fused_dropout: p must be in (0, 1), not {p}")
    if x.device.type == "cpu":
        return fused_dropout_reference(x, p, seed, upscale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dropout runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_dropout kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_dropout: x must be contiguous")
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    align = 4 * x.element_size()
    vec = int(x.data_ptr() % align == 0 and out.data_ptr() % align == 0)
    k0, k1, step = launch_key(seed, x.device)
    fn, err_str = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), n, _DTYPE_CODES[x.dtype],
                keep_threshold(p), k0, k1, step, dropout_scale(p, upscale),
                vec, stream)
    if rc != 0:
        raise RuntimeError(f"fused_dropout launch failed: "
                           f"{err_str(rc).decode()}")
    fused_dropout.launches += 1
    return out


class _FusedDropout(torch.autograd.Function):
    """K10 forward; K10 on the cotangent backward (``_dropout_fused_bwd``,
    :1445)."""

    @staticmethod
    def forward(ctx, x, p, seed, upscale):
        ctx.args = (p, seed, upscale)
        return fused_dropout_fwd(x, p, seed, upscale)

    @staticmethod
    def backward(ctx, dout):
        return fused_dropout_fwd(dout.contiguous(), *ctx.args), None, None, \
            None


def fused_dropout(x, p, seed, upscale=True):
    """Dropout of probability `p` over x keyed by `seed`, the mask drawn
    in the kernel; differentiable in x."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _FusedDropout.apply(x, p, seed, upscale)
    return fused_dropout_fwd(x, p, seed, upscale)


fused_dropout.launches = 0
