"""Flash-attention forward — the port of the TPU kernel
``paddle_tpu/ops/pallas_kernels.py::_flash_kernel`` (reached through
``_flash_call`` -> ``pl.pallas_call`` at :481 from ``flash_attention``
:188), in its forward arm without dropout and without lse.

:func:`flash_attention` launches the hand-written CUDA kernel
``csrc/flash_attention_fwd.cu`` on a CUDA tensor and takes the plain
PyTorch version :func:`flash_attention_reference` only for a CPU tensor.
On a CUDA tensor it launches the kernel or raises: there is no fallback.
``flash_attention.launches`` counts the kernel's launches.
"""

import ctypes

import torch

from . import cuda_build

_SOURCE = "flash_attention_fwd"
_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def flash_attention_reference(q, k, v, bias=None, causal=False, scale=None):
    """Plain PyTorch attention over [B, H, T, D], the counterpart of the
    reference's ``_attn_reference`` computed the kernel's way: scores and
    softmax in fp32, a -inf causal mask (top-left aligned), rows whose
    every score is -inf give 0, output in the input dtype."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return (torch.matmul(p, v.float()) / denom).to(q.dtype)


def _kernel():
    global _fn
    if _fn is None:
        lib = cuda_build.load(_SOURCE)
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def _check(q, k, v, bias):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q, k, v of rank 4 "
                         "[B, H, T, D]")
    b, h, _, d = q.shape
    if k.shape != v.shape or tuple(k.shape[:2]) != (b, h) \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match as [B,H,Tq,D], [B,H,Tk,D], [B,H,Tk,D]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, "
                            f"q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim "
                         f"{_HEAD_DIMS}, not {d}")
    if bias is not None and bias.device != q.device:
        raise ValueError(f"flash_attention: bias is on {bias.device}, "
                         f"q on {q.device}")


def flash_attention(q, k, v, bias=None, causal=False, scale=None):
    """softmax(q·kᵀ·scale + bias [+ causal mask])·v over q [B,H,Tq,D],
    k and v [B,H,Tk,D].  `bias` is any tensor that broadcasts to
    [B,H,Tq,Tk]; a [B|1,1,1,Tk] padding mask is read as a row, never
    broadcast in memory.  `scale` defaults to 1/sqrt(D)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"not {q.device}")
    _check(q, k, v, bias)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if bias is None:
        bias_ptr, strides = None, (0, 0, 0, 0)
    else:
        bb = bias.to(torch.float32)
        bb = bb.reshape((1,) * (4 - bb.dim()) + tuple(bb.shape))
        bb = bb.expand(b, h, tq, tk)        # a view: stride 0 where broadcast
        bias_ptr, strides = bb.data_ptr(), bb.stride()
    out = torch.empty_like(q)
    fn, err_str = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                out.data_ptr(), b, h, tq, tk, d, _DTYPE_CODES[q.dtype],
                *strides, float(scale), int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{err_str(rc).decode()}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
