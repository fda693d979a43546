"""Quantized matmul — the port of the K6 half of
``paddle_tpu/ops/quant_kernels.py``: the TPU kernel ``_quant_matmul_kernel``
(:64, reached through ``_quant_matmul_call`` -> ``pl.pallas_call`` :82)
becomes ``csrc/quant_matmul.cu``, written by hand for Hopper.

- :func:`int8_matmul` ``(xq, wq, colscale)`` is the kernel's wrapper: the
  exact int32 product of int8 ``xq [M, K]`` and ``wq [K, N]``, converted to
  fp32 and times ``colscale [N]``.  On a CUDA tensor it launches K6
  (counted in ``int8_matmul.launches``) or raises; on a CPU tensor it runs
  the plain version :func:`int8_matmul_reference`.  Every shape runs: the
  TPU arm's m % 32 / k % 128 / n % 128 fallback (:158-159) and its
  measured kernel selection are not ported, by design.
- :func:`quant_matmul` ``(x, wq, wscale)`` is the reference's: a dynamic
  per-tensor activation scale and int8 codes computed with torch ops
  around the kernel (as XLA ops surround the Pallas call), then K6.
- :func:`make_quant_kernel` is the ``__quant__`` dispatch target of
  ``registry.get_kernel``.

The weights' int8 codes and per-channel scales are never computed here:
``passes/quantize.apply_to_scope`` makes them once at Predictor load.
``quantize_kv`` and the paged-attention half (K5) wait for the decode
slice.
"""

import ctypes

import torch

from . import cuda_build
from .registry import as_out, first

_SOURCE = "quant_matmul"
_libs = {}


def int8_matmul_reference(xq, wq, colscale):
    """Plain version of K6: the float64 sum of int8 products is exact far
    past any K here (|sum| < 2**53), and ``.float()`` rounds it to nearest
    as the kernel's int32 -> fp32 conversion does, so both give the same
    bits."""
    return (xq.double() @ wq.double()).float() * colscale


def _kernel():
    """(entry point, error-string function), built and loaded at first
    use."""
    fn = _libs.get(_SOURCE)
    if fn is None:
        lib = cuda_build.load(_SOURCE)
        entry = lib.quant_matmul_int8
        entry.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        entry.restype = ctypes.c_int
        lib.quant_matmul_error_string.argtypes = [ctypes.c_int]
        lib.quant_matmul_error_string.restype = ctypes.c_char_p
        fn = _libs[_SOURCE] = (entry, lib.quant_matmul_error_string)
    return fn


def _check(xq, wq, colscale):
    if xq.dim() != 2 or wq.dim() != 2 or colscale.dim() != 1:
        raise ValueError(f"int8_matmul takes xq [M, K], wq [K, N] and "
                         f"colscale [N], not {tuple(xq.shape)}, "
                         f"{tuple(wq.shape)}, {tuple(colscale.shape)}")
    if xq.shape[1] != wq.shape[0] or colscale.shape[0] != wq.shape[1]:
        raise ValueError(f"int8_matmul: xq {tuple(xq.shape)}, wq "
                         f"{tuple(wq.shape)}, colscale "
                         f"{tuple(colscale.shape)} do not match")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 \
            or colscale.dtype != torch.float32:
        raise TypeError(f"int8_matmul takes int8 xq and wq and float32 "
                        f"colscale, not {xq.dtype}, {wq.dtype}, "
                        f"{colscale.dtype}")
    for name, t in (("wq", wq), ("colscale", colscale)):
        if t.device != xq.device:
            raise ValueError(f"int8_matmul: {name} is on {t.device}, xq on "
                             f"{xq.device}")


def int8_matmul(xq, wq, colscale):
    """K6 on CUDA tensors, its plain version on CPU tensors: ``xq`` int8
    [M, K], ``wq`` int8 [K, N], ``colscale`` fp32 [N] -> fp32 [M, N]."""
    _check(xq, wq, colscale)
    if xq.device.type == "cpu":
        return int8_matmul_reference(xq, wq, colscale)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on CUDA or CPU tensors, not "
                         f"{xq.device}")
    for name, t in (("xq", xq), ("wq", wq), ("colscale", colscale)):
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")
    m, k = xq.shape
    n = wq.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if m == 0 or n == 0:
        return out
    fn, err_str = _kernel()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    with torch.cuda.device(xq.device):
        rc = fn(xq.data_ptr(), wq.data_ptr(), colscale.data_ptr(),
                out.data_ptr(), m, n, k, stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul launch failed: "
                           f"{err_str(rc).decode()}")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def quantize_activation(x):
    """Dynamic per-tensor activation quantization (the reference's
    :154-155): ``xs = max(amax(|x|) / 127, 1e-12)``, ``xq = clip(round(x /
    xs), -127, 127)`` as int8 (``torch.round`` rounds half to even, as
    ``jnp.round``).  Returns (xq, xs)."""
    xs = torch.clamp_min(x.abs().amax() / 127.0, 1e-12)
    xq = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)
    return xq, xs


def quant_matmul(x, wq, wscale):
    """``x [M, K]`` float activation, ``wq [K, N]`` int8 weight, ``wscale
    [N]`` fp32 per-output-channel scale (made at load by
    passes/quantize.py) -> ``[M, N]`` fp32: the activation's int8 codes
    and the combined scale ``xs * wscale`` in torch ops, the product in
    K6."""
    x = x.float()
    m, k = x.shape
    n = wq.shape[-1] if wq.dim() == 2 else int(wscale.shape[0])
    wq = wq.reshape(k, n)
    if wq.dtype != torch.int8:
        raise NotImplementedError(
            f"quant_matmul: {wq.dtype} weights are not ported (the JAX "
            f"package's fp8 arm is ROADMAP queue 1 item 9)")
    xq, xs = quantize_activation(x)
    return int8_matmul(xq, wq.contiguous(), xs * wscale)


def _prod(t):
    r = 1
    for v in t:
        r *= v
    return r


def make_quant_kernel(op_type, spec):
    """Kernel for a ``__quant__``-annotated mul/matmul: the weight
    arrives int8 from the scope (passes/quantize.apply_to_scope), the
    scale rides the ``Scale`` input slot, and the output keeps the
    activation's dtype."""

    def kernel(ins, attrs):
        x, wq = first(ins, "X"), first(ins, "Y")
        sc = first(ins, "Scale")
        if sc is None:
            raise KeyError(
                f"quantized {op_type!r} is missing its Scale operand "
                f"({spec.get('scale')!r}) — run "
                f"passes.quantize.apply_to_scope on the serving scope "
                f"before executing a quantized program")
        out_dtype = x.dtype
        if op_type == "mul":
            xnc = int(attrs.get("x_num_col_dims", 1))
            xs_ = tuple(x.shape)
            xm = x.reshape(_prod(xs_[:xnc]), _prod(xs_[xnc:]))
            out = quant_matmul(xm, wq, sc)
            ync = int(attrs.get("y_num_col_dims", 1))
            out = out.reshape(xs_[:xnc] + tuple(wq.shape[ync:]))
        else:                        # matmul, rank-2 non-transposed Y
            xm = x.transpose(-1, -2) \
                if attrs.get("transpose_X", False) and x.dim() > 1 else x
            lead = tuple(xm.shape[:-1])
            out = quant_matmul(xm.reshape(-1, xm.shape[-1]), wq, sc)
            out = out.reshape(lead + (wq.shape[-1],))
            alpha = attrs.get("alpha", 1.0)
            if alpha != 1.0:
                out = out * alpha
        return as_out(out.to(out_dtype))

    return kernel
