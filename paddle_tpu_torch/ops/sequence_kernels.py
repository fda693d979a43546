"""Masked row softmax — the port of K7 of
``paddle_tpu/ops/pallas_kernels.py``: ``_masked_softmax_kernel`` (:1340,
reached through ``_masked_softmax_p`` -> ``pl.pallas_call`` :1376) becomes
``csrc/masked_softmax.cu``, written by hand for Hopper.

:func:`masked_softmax` ``(x, lens)`` is the row softmax of fp32
``x [B, T]`` restricted to the valid positions ``t < lens[b]``, 0
elsewhere and on a row with none.  The TPU kernel took a ``[B, T]`` mask,
which its one caller, ``sequence_softmax``, built from these lengths.  On
a CUDA tensor it launches K7 (counted in ``masked_softmax.launches``) or
raises; on a CPU tensor it runs the plain version
:func:`masked_softmax_reference` on :func:`length_mask` of the lengths.
Its backward is the plain version's vector-Jacobian product, recomputed
from the saved inputs, as the reference's ``custom_vjp`` (:1383-1393).
Every T runs: the TPU arm's T % 128 fallback (:1363) is not ported, by
design.
"""

import ctypes

import torch

from . import cuda_build

_SOURCE = "masked_softmax"
_libs = {}


def length_mask(lens, t, dtype=torch.float32):
    """[B] lengths -> [B, T] 0/1 mask of `dtype`."""
    return (torch.arange(t, device=lens.device)[None, :]
            < lens.reshape(-1, 1)).to(dtype)


def masked_softmax_reference(x, mask):
    """Plain version of K7 (``_masked_softmax_composed``, :1351): masked
    positions take fp32's lowest value before the softmax and are zeroed
    after it."""
    valid = mask > 0
    xm = torch.where(valid, x.float(),
                     torch.full_like(x, torch.finfo(torch.float32).min,
                                     dtype=torch.float32))
    return (torch.softmax(xm, dim=-1) * valid).to(x.dtype)


def _kernel():
    fn = _libs.get(_SOURCE)
    if fn is None:
        lib = cuda_build.load(_SOURCE)
        entry = lib.masked_softmax_fwd
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        entry.argtypes = [p, ll, p, p, i, i, p]
        entry.restype = ctypes.c_int
        lib.masked_softmax_error_string.argtypes = [ctypes.c_int]
        lib.masked_softmax_error_string.restype = ctypes.c_char_p
        fn = _libs[_SOURCE] = (entry, lib.masked_softmax_error_string)
    return fn


def _check(x, lens):
    if x.dim() != 2:
        raise ValueError(f"masked_softmax takes x [B, T], not "
                         f"{tuple(x.shape)}")
    if tuple(lens.shape) != (x.shape[0],):
        raise ValueError(f"masked_softmax: x {tuple(x.shape)} takes lengths "
                         f"[B], not {tuple(lens.shape)}")
    if lens.device != x.device:
        raise ValueError(f"masked_softmax: x on {x.device}, lengths on "
                         f"{lens.device}")


def masked_softmax_fwd(x, lens):
    """K7 on CUDA tensors, its plain version on CPU tensors; not
    differentiable."""
    _check(x, lens)
    if x.device.type == "cpu":
        return masked_softmax_reference(x, length_mask(lens, x.shape[1],
                                                       x.dtype))
    if x.device.type != "cuda":
        raise ValueError(f"masked_softmax runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"masked_softmax kernel takes float32, not {x.dtype}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError("masked_softmax: x must have unit stride along T")
    b, t = x.shape
    out = torch.empty((b, t), dtype=torch.float32, device=x.device)
    if b == 0 or t == 0:
        return out
    lens = lens.to(torch.int32).contiguous()
    fn, err_str = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), x.stride(0) if b > 1 else t, lens.data_ptr(),
                out.data_ptr(), b, t, stream)
    if rc != 0:
        raise RuntimeError(f"masked_softmax launch failed: "
                           f"{err_str(rc).decode()}")
    masked_softmax.launches += 1
    return out


class _MaskedSoftmax(torch.autograd.Function):
    """K7 forward; the plain version's vjp backward (the reference's
    ``_masked_softmax_bwd``, :1387)."""

    @staticmethod
    def forward(ctx, x, lens):
        ctx.save_for_backward(x, lens)
        return masked_softmax_fwd(x, lens)

    @staticmethod
    def backward(ctx, dout):
        x, lens = ctx.saved_tensors
        with torch.enable_grad():
            leaf = x.detach().requires_grad_()
            out = masked_softmax_reference(
                leaf, length_mask(lens, x.shape[1], x.dtype))
            (dx,) = torch.autograd.grad(out, leaf, dout)
        return dx, None


def masked_softmax(x, lens):
    """Row softmax of x [B, T] over its valid positions ``t < lens[b]``
    (lengths [B]); differentiable in x."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaskedSoftmax.apply(x, lens)
    return masked_softmax_fwd(x, lens)


masked_softmax.launches = 0
