"""Quantized kernels — the port of ``paddle_tpu/ops/quant_kernels.py``:
the TPU kernel ``_quant_matmul_kernel`` (K6, :64, reached through
``_quant_matmul_call`` -> ``pl.pallas_call`` :82) becomes
``csrc/quant_matmul.cu``, and the int8 arm of paged attention (K5,
``_paged_attn_quant_call`` :257 -> ``pl.pallas_call`` :299) runs the
loop of ``csrc/paged_attention.cu`` that K4 runs, both written by hand
for Hopper.

- :func:`int8_matmul` ``(xq, wq, colscale)`` is the kernel's wrapper: the
  exact int32 product of int8 ``xq [M, K]`` and ``wq [K, N]``, converted to
  fp32 and times ``colscale [N]``.  On a CUDA tensor it launches K6
  (counted in ``int8_matmul.launches``) or raises; on a CPU tensor it runs
  the plain version :func:`int8_matmul_reference`.  Every shape runs: the
  TPU arm's m % 32 / k % 128 / n % 128 fallback (:158-159) and its
  measured kernel selection are not ported, by design.
- The kernel reads the weight K-major (8-bit ``wgmma`` takes no
  transposed operand): :func:`k_major` lays a [K, N] weight out as a
  zero-padded K-major ``[N, Kp]`` buffer (Kp = K rounded up to 16 bytes,
  TMA's row-stride unit) and returns its [K, N] view, which holds the same
  values; ``passes/quantize.apply_to_scope`` stores every rank-2 weight
  so, once at load, and :func:`int8_matmul` takes that view as it stands
  (:func:`is_k_major`).  Any other weight (tests, a caller's own) is laid
  out by the wrapper on every call.
- :func:`quant_matmul` ``(x, wq, wscale)`` is the reference's: a dynamic
  per-tensor activation scale and int8 codes computed with torch ops
  around the kernel (as XLA ops surround the Pallas call), then K6.
- :func:`make_quant_kernel` is the ``__quant__`` dispatch target of
  ``registry.get_kernel``.

- :func:`quantize_kv` is the reference's host numpy, byte for byte: one
  symmetric int8 scale per token, the layout of a
  ``PagedKVConfig(kv_dtype="int8")`` pool's planes.
- :func:`paged_attention_quant` ``(q, k_arena, v_arena, k_scale,
  v_scale, block_table, lengths)`` is K5's wrapper: paged attention over
  int8 ``[N, Bs, H, D]`` arenas whose tokens are dequantized by their
  fp32 ``[N, Bs]`` scale rows inside the kernel.  On a CUDA ``q`` it
  launches the kernel (counted in ``paged_attention_quant.launches``) or
  raises; on a CPU ``q`` it runs :func:`paged_attention_quant_reference`.
  ``select``/``interpret`` change nothing (the reference composed unless
  ``d % 128 == 0`` and ``bs % 8 == 0``, :363, and measured the rest).

The weights' int8 codes and per-channel scales are never computed here:
``passes/quantize.apply_to_scope`` makes them once at Predictor load.
"""

import ctypes

import numpy as np
import torch

from . import cuda_build
from . import paged_kernels
from .registry import as_out, first

_SOURCE = "quant_matmul"
_libs = {}


def int8_matmul_reference(xq, wq, colscale):
    """Plain version of K6: the float64 sum of int8 products is exact far
    past any K here (|sum| < 2**53), and ``.float()`` rounds it to nearest
    as the kernel's int32 -> fp32 conversion does, so both give the same
    bits."""
    return (xq.double() @ wq.double()).float() * colscale


_ROW_ALIGN = 16     # bytes: TMA's row-stride and base-address unit


def _padded_k(k):
    return -(-max(k, 1) // _ROW_ALIGN) * _ROW_ALIGN


def k_major(wq):
    """A [K, N] weight as the kernel reads it: a K-major ``[N, Kp]``
    buffer (Kp = K rounded up to 16, the pad zeros) holding ``wq``'s
    values, returned as its ``[K, N]`` view (strides ``(1, Kp)``)."""
    k, n = wq.shape
    buf = torch.zeros((n, _padded_k(k)), dtype=wq.dtype, device=wq.device)
    buf[:, :k] = wq.t()
    return buf[:, :k].t()


def is_k_major(wq):
    """Whether a [K, N] weight is laid out as :func:`k_major` lays it out
    (K contiguous, a row stride of whole 16 bytes, a 16-byte aligned
    base): the kernel then reads it where it lies."""
    return wq.stride(0) == 1 and wq.stride(1) >= wq.shape[0] \
        and wq.stride(1) % _ROW_ALIGN == 0 \
        and wq.data_ptr() % _ROW_ALIGN == 0


def _padded_rows(m, k, device):
    """An int8 [m, k] view of [m, Kp] rows (Kp = k rounded up to 16): the
    rows TMA reads.  The pad is never read (the kernel's tensor map ends
    at k and fills zeros past it), so it is left unwritten."""
    return torch.empty((m, _padded_k(k)), dtype=torch.int8,
                       device=device)[:, :k]


def _rows_aligned(xq):
    """xq [M, K] as TMA reads it: K contiguous, a row stride of whole 16
    bytes, a 16-byte aligned base; copied into such rows when it is not
    (quantize_activation writes its codes so)."""
    m, k = xq.shape
    if xq.stride(1) == 1 and xq.stride(0) >= k \
            and xq.stride(0) % _ROW_ALIGN == 0 \
            and xq.data_ptr() % _ROW_ALIGN == 0:
        return xq
    return _padded_rows(m, k, xq.device).copy_(xq)


def _kernel():
    """(entry point, error-string function), built and loaded at first
    use."""
    fn = _libs.get(_SOURCE)
    if fn is None:
        lib = cuda_build.load(_SOURCE)
        entry = lib.quant_matmul_int8
        # xq, its row stride, wt [N, K], its row stride, colscale, out,
        # M, N, K, the stream
        entry.argtypes = [ctypes.c_void_p, ctypes.c_longlong] * 2 + \
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
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
    [M, K], ``wq`` int8 [K, N] (K-major as :func:`k_major` lays it out, or
    laid out so here), ``colscale`` fp32 [N] -> fp32 [M, N]."""
    _check(xq, wq, colscale)
    if xq.device.type == "cpu":
        return int8_matmul_reference(xq, wq, colscale)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on CUDA or CPU tensors, not "
                         f"{xq.device}")
    if not colscale.is_contiguous():
        raise ValueError("int8_matmul: colscale must be contiguous")
    m, k = xq.shape
    n = wq.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if m == 0 or n == 0:
        return out
    if k == 0:      # a sum of nothing: K padded with zeros to one row unit
        xq = xq.new_zeros((m, _ROW_ALIGN))
        wq = xq.new_zeros((_ROW_ALIGN, n))
        k = _ROW_ALIGN
    xq = _rows_aligned(xq)
    if not is_k_major(wq):
        wq = k_major(wq)
    fn, err_str = _kernel()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    with torch.cuda.device(xq.device):
        # wq's base and column stride are its K-major [N, K] buffer's base
        # and row stride
        rc = fn(xq.data_ptr(), xq.stride(0), wq.data_ptr(), wq.stride(1),
                colscale.data_ptr(), out.data_ptr(), m, n, k, stream)
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
    ``jnp.round``).  ``x [M, K]``; the codes are written into rows of a
    whole 16 bytes (K padded, the pad unwritten), which K6's TMA reads
    where they lie.  Returns (xq, xs)."""
    xs = torch.clamp_min(x.abs().amax() / 127.0, 1e-12)
    codes = torch.clamp(torch.round(x / xs), -127, 127)
    return _padded_rows(*x.shape, x.device).copy_(codes), xs


def quant_matmul(x, wq, wscale):
    """``x [M, K]`` float activation, ``wq [K, N]`` int8 weight, ``wscale
    [N]`` fp32 per-output-channel scale (made at load by
    passes/quantize.py, the weight K-major) -> ``[M, N]`` fp32: the
    activation's int8 codes and the combined scale ``xs * wscale`` in
    torch ops, the product in K6.  The weight is read where it lies: no
    copy a call."""
    x = x.float()
    m, k = x.shape
    n = wq.shape[-1] if wq.dim() == 2 else int(wscale.shape[0])
    wq = wq.reshape(k, n)
    if wq.dtype != torch.int8:
        raise NotImplementedError(
            f"quant_matmul: {wq.dtype} weights are not ported (the JAX "
            f"package's fp8 arm is ROADMAP queue 1 item 9)")
    xq, xs = quantize_activation(x)
    return int8_matmul(xq, wq, xs * wscale)


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


# ---------------------------------------------------------------------------
# Quantized paged attention (K5): int8 K/V arenas + fp32 scale planes
# ---------------------------------------------------------------------------

def quantize_kv(kv, bits=8):
    """Per-token symmetric int8 quantization of K/V rows: ``kv``
    ``[..., H, D]`` fp32 -> (int8 values, fp32 scale ``[...]``), one
    scale per token (amax over the head and dim axes) — the planes of a
    ``PagedKVConfig(kv_dtype="int8")`` pool.  Host numpy, as the
    reference's (``np.round`` rounds half to even)."""
    kv = np.asarray(kv, np.float32)
    qmax = float((1 << (bits - 1)) - 1)
    amax = np.max(np.abs(kv), axis=(-2, -1))
    scale = np.maximum(amax / qmax, 1e-12).astype(np.float32)
    q = np.clip(np.round(kv / scale[..., None, None]), -qmax, qmax)
    return q.astype(np.int8), scale


def _dequant_arena(arena, scale):
    return arena.float() * scale[..., None, None]


def paged_attention_quant_reference(q, k_arena, v_arena, k_scale, v_scale,
                                    block_table, lengths, scale):
    """Plain version of K5, the reference's
    ``_paged_attn_quant_reference`` (:246): dequantize the whole arena,
    then the plain K4."""
    return paged_kernels.paged_attention_reference(
        q, _dequant_arena(k_arena, k_scale),
        _dequant_arena(v_arena, v_scale), block_table, lengths, scale)


def paged_attention_quant(q, k_arena, v_arena, k_scale, v_scale,
                          block_table, lengths, scale=None, select=True,
                          interpret=None):
    """Paged decode attention over int8 arenas (K5): ``q [S, H, D]``
    float32 or bfloat16, ``k_arena``/``v_arena`` int8 ``[N, Bs, H, D]``,
    ``k_scale``/``v_scale`` fp32 ``[N, Bs]``, ``block_table [S, MB]``,
    ``lengths [S]`` -> ``[S, H, D]`` in q's dtype; ``scale`` defaults to
    1/sqrt(D).  On a CUDA ``q`` one launch of csrc/paged_attention.cu: the
    split-KV kernel up to D 256 (each slot's chain cut into
    ``paged_kernels.split_plan(...).splits`` parts walked a block at a
    time, the parts merged in the same launch), the wide loop above; the
    plain version on a CPU ``q``; numpy operands move to q's device."""
    del select, interpret
    k, v, table, lens, (ks, vs) = paged_kernels.operands(
        q, k_arena, v_arena, block_table, lengths, (k_scale, v_scale))
    if k.dtype != torch.int8:
        raise TypeError(f"paged_attention_quant takes int8 arenas, not "
                        f"{k.dtype}")
    scale = 1.0 / (q.shape[-1] ** 0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return paged_attention_quant_reference(q, k, v, ks, vs, table,
                                               lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_quant runs on CUDA or CPU "
                         f"tensors, not {q.device}")
    out = paged_kernels.launch(q, k, v, table, lens, scale, ks, vs)
    paged_attention_quant.launches += 1
    return out


paged_attention_quant.launches = 0
