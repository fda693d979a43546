"""Flash attention, forward and FlashAttention-2 backward — the port of the
TPU kernels of ``paddle_tpu/ops/pallas_kernels.py``:

- K1 ``_flash_kernel`` (:74, reached through ``_flash_call`` ->
  ``pl.pallas_call`` :481) with its lse output (:135-142) and its dropout
  arm (:114-124): ``csrc/flash_attention_fwd.cu``;
- K2a ``_flash_bwd_dkv_kernel`` (:558, ``pl.pallas_call`` :791) and K2b
  ``_flash_bwd_dq_kernel`` (:625, ``pl.pallas_call`` :835), the two
  backward kernels of ``_flash_bwd_impl`` (:733):
  ``csrc/flash_attention_bwd.cu``;
- K3 ``flash_attention_with_lse`` (:883, K1's ``pl.pallas_call`` returning
  (out, lse), with a custom_vjp that carries the lse cotangent into the
  backward as ``delta - dlse``, :893-913): :func:`flash_attention_with_lse`,
  the same two sources.

:func:`flash_attention` is differentiable: under grad its forward asks
K1 for the per-row lse and its backward launches K2a (dK, dV) and K2b
(dQ, and dBias when the bias needs a grad).  Each wrapper launches its
hand-written CUDA kernel on a CUDA tensor and takes its plain PyTorch
version only for a CPU tensor; on a CUDA tensor it launches or raises,
with no fallback.  The kernels take every head dim in float32 and
bfloat16, as the reference does (:func:`padded_head_dim`): up to 256 on
the tensor cores at the widths of :func:`kernel_widths`, above it in a
wide arm that splits the output columns into groups of 256 over a grid
axis (every group forms the scores over the whole head dim).
``flash_attention.launches``,
``flash_attention_bwd_dkv.launches`` and ``flash_attention_bwd_dq.
launches`` count the kernels' launches; ``flash_attention_with_lse.
launches`` counts the forward launches made for K3.

K1's forward is the ``torch.library`` custom op
``paddle_tpu_torch::flash_attention_fwd`` (registered at import, with a
fake implementation that gives its output shapes), so ``torch.export``
records each call as one node and an exported program launches the
kernel, counted at run time inside the op's body; an eager call runs
the body directly.  The backward kernels have no custom op and refuse
an export trace (``cuda_build.refuse_export``).

Dropout on the softmax weights draws its bits from counter-based Philox
(Random123's philox4x32-10) keyed by (seed) with the element's
coordinates (k, q, b·h, 0) as the counter, so the forward and both
backward kernels — which walk different tilings — regenerate the same
mask, and :func:`philox_keep_mask` gives the same bits in plain torch.
A `seed` is an int, or a ``registry.DeviceSeed`` whose step the kernels
read from device memory (the Executor's step word in a captured CUDA
graph): the same key, and so the same bits, at the same step.  The TPU
drew its bits per tile from its hardware generator; those bits are not
reproduced.
"""

import ctypes
import os
import re
from typing import Optional, Tuple

import torch

from . import cuda_build
from .registry import (DeviceSeed, keep_threshold, launch_key, philox4x32,
                       seed_key)

_FWD, _BWD = "flash_attention_fwd", "flash_attention_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = {torch.float32: 4, torch.bfloat16: 8}  # values in 16 bytes
_libs = {}


# ---------------------------------------------------------------------------
# plain versions: the CPU path and the kernels' oracle
# ---------------------------------------------------------------------------

def philox_keep_mask(seed, bh, tq, tk, p, device=None):
    """Keep mask [bh, tq, tk] of attention dropout: element (i, q, k) is
    kept when word 0 of Philox4x32-10 at counter (k, q, i, 0) under key
    ``seed_key(seed)`` is below ``keep_threshold(p)`` — the bits the
    kernels draw."""
    ar = torch.arange
    kk = ar(tk, device=device).reshape(1, 1, tk).expand(bh, tq, tk)
    qq = ar(tq, device=device).reshape(1, tq, 1).expand(bh, tq, tk)
    ii = ar(bh, device=device).reshape(bh, 1, 1).expand(bh, tq, tk)
    ctr = torch.stack([kk, qq, ii, torch.zeros_like(kk)])
    return philox4x32(ctr, seed_key(seed))[0] < keep_threshold(p)


def _scores(q, k, bias, causal, scale, dtype=torch.float32):
    """Scores q·kᵀ·scale + bias in `dtype` (fp32 unless a caller asks for
    a wider answer) with the causal mask at -inf."""
    s = torch.matmul(q.to(dtype), k.to(dtype).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(dtype)
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def _keep(q, k, dropout_p, seed):
    b, h, tq, _ = q.shape
    return philox_keep_mask(seed, b * h, tq, k.shape[2], dropout_p,
                            q.device).reshape(b, h, tq, k.shape[2])


def flash_attention_reference(q, k, v, bias=None, causal=False, scale=None,
                              dropout_p=0.0, seed=0, return_lse=False,
                              dtype=torch.float32):
    """Plain PyTorch attention over [B, H, T, D], computed the kernel's
    way: scores and softmax in `dtype` (fp32; float64 inputs with float64
    give the kernel's precision check its answer), a -inf causal mask
    (top-left aligned), rows whose every score is -inf give 0 (and lse
    -inf), the denominator sums the undropped weights, the kept weights
    are scaled by 1/(1-p), output in the input dtype.  With `return_lse`,
    also the per-row log-sum-exp [B, H, Tq] in `dtype`."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _scores(q, k, bias, causal, scale, dtype)
    m = s.amax(dim=-1, keepdim=True)
    fin = torch.isfinite(m)
    m = torch.where(fin, m, torch.zeros_like(m))
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    if dropout_p:
        p = torch.where(_keep(q, k, dropout_p, seed), p,
                        torch.zeros_like(p)) * (1.0 / (1.0 - dropout_p))
    out = (torch.matmul(p, v.to(dtype)) / denom).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(fin, m + torch.log(denom),
                      torch.full_like(m, float("-inf")))
    return out, lse.squeeze(-1)


def _unbroadcast(dbias, bias):
    """[B, H, Tq, Tk] fp32 grad -> the bias's own shape and dtype, summed
    over the dims the bias broadcast (right-aligned, as numpy)."""
    ps = (1,) * (4 - bias.dim()) + tuple(bias.shape)
    dims = tuple(i for i, (bd, fd) in enumerate(zip(ps, dbias.shape))
                 if bd == 1 and fd != 1)
    if dims:
        dbias = dbias.sum(dim=dims, keepdim=True)
    return dbias.reshape(bias.shape).to(bias.dtype)


def _backward_plain(q, k, v, bias, dout, lse, delta, causal, scale,
                    dropout_p, seed, dtype=torch.float32):
    """The FlashAttention-2 backward from the forward's lse, step by step
    (``_flash_bwd_dkv_kernel`` / ``_flash_bwd_dq_kernel``): P = exp(S -
    lse), dP = dO·Vᵀ, dV = drop(P)ᵀ·dO, dS = P·(drop(dP) - delta),
    dK = dSᵀ·Q·scale, dQ = dS·K·scale, dBias = dS, computed in `dtype`
    (fp32; float64 inputs with float64 give the kernels' precision
    check its answer).  Returns dq, dk, dv in the input dtype and dS
    [B, H, Tq, Tk] in `dtype`."""
    s = _scores(q, k, bias, causal, scale, dtype)
    lse = lse.to(dtype).unsqueeze(-1)
    lse_fin = torch.isfinite(lse)
    lse_safe = torch.where(lse_fin, lse, torch.zeros_like(lse))
    p = torch.where(torch.isfinite(s) & lse_fin, torch.exp(s - lse_safe),
                    torch.zeros_like(s))
    do = dout.to(dtype)
    dp = torch.matmul(do, v.to(dtype).transpose(-1, -2))
    if dropout_p:
        keep = _keep(q, k, dropout_p, seed)
        inv = 1.0 / (1.0 - dropout_p)
        zero = torch.zeros_like(p)
        pd = torch.where(keep, p, zero) * inv
        dp = torch.where(keep, dp, zero) * inv
    else:
        pd = p
    ds = p * (dp - delta.to(dtype).unsqueeze(-1))
    dv = torch.matmul(pd.transpose(-1, -2), do)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(dtype)) * scale
    dq = torch.matmul(ds, k.to(dtype)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds


def attention_delta(dout, out):
    """delta = rowsum(dO·O) [B, H, Tq] in fp32 (the reference computes it
    with XLA before its backward kernels, :751-753)."""
    return (dout.float() * out.float()).sum(dim=-1)


def flash_attention_backward_reference(q, k, v, bias, out, lse, dout,
                                       causal=False, scale=None,
                                       dropout_p=0.0, seed=0, dlse=None):
    """Plain FlashAttention-2 backward: (dq, dk, dv, dbias) with dbias in
    the bias's shape (None without a bias).  `lse` is the forward's
    [B, H, Tq] log-sum-exp; `dlse`, a cotangent on it (K3's backward),
    enters as delta - dlse."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    delta = attention_delta(dout, out)
    if dlse is not None:
        delta = delta - dlse.float()
    dq, dk, dv, ds = _backward_plain(q, k, v, bias, dout, lse, delta,
                                     causal, scale, dropout_p, seed)
    return dq, dk, dv, None if bias is None else _unbroadcast(ds, bias)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _L, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_uint)
# pointers, then (B, H, Tq, Tk, D, dtype), the bias strides, scale and
# causal, then the dropout arm (on, threshold, key0, key1, the step
# word's address or null, 1/(1-p)), and the stream
_SHAPE = [_I] * 6 + [_L] * 4 + [_F, _I] + [_I, _U, _U, _U, _P, _F] + [_P]
_SIGNATURES = {
    "flash_attention_fwd": (_FWD, [_P] * 6 + _SHAPE),
    "flash_attention_bwd_dkv": (_BWD, [_P] * 9 + _SHAPE),
    "flash_attention_bwd_dq": (_BWD, [_P] * 9 + [_I] + _SHAPE),
}


def padded_head_dim(d, dtype=torch.float32):
    """The head dim the kernels run head dim `d` of `dtype` (float32 or
    bfloat16) at: `d` padded with zero columns to a whole 16-byte chunk
    (4 float32 or 8 bfloat16 values, what cp.async copies).  Every d >= 1
    runs; raises ValueError below 1."""
    if d < 1:
        raise ValueError(f"flash_attention kernels take head dims of 1 and "
                         f"more, not {d}")
    chunk = _CHUNK[dtype]
    return -(-d // chunk) * chunk


def kernel_widths():
    """The head widths the tensor-core kernels are instantiated at,
    narrowest first: ``HeadWidths`` of ``csrc/flash_attention_mma.cuh``,
    whose ``with_width`` runs a head dim at the smallest width that holds
    it.  A head dim above the widest runs in the wide arm."""
    with open(os.path.join(cuda_build.CSRC, "flash_attention_mma.cuh")) as f:
        m = re.search(r"using HeadWidths = Widths<([\d,\s]+)>;", f.read())
    return tuple(int(w) for w in m.group(1).split(","))


def _dense(t, dp):
    """`t` [..., d] with zero columns up to dp, on a 16-byte aligned
    address (cp.async copies 16 bytes)."""
    if t.shape[-1] != dp:
        return torch.nn.functional.pad(t, (0, dp - t.shape[-1]))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel(name):
    """(entry point, error-string function) of one kernel, built and
    loaded at first use."""
    fn = _libs.get(name)
    if fn is None:
        source, argtypes = _SIGNATURES[name]
        lib = cuda_build.load(source)
        entry = getattr(lib, name)
        entry.argtypes = argtypes
        entry.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        fn = _libs[name] = (entry, lib.flash_attention_error_string)
    return fn


def _check(q, k, v, bias, *more):
    """Raises on what the kernels do not take; returns the padded head
    dim they run at."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q, k, v of rank 4 "
                         "[B, H, T, D]")
    b, h, _, d = q.shape
    if k.shape != v.shape or tuple(k.shape[:2]) != (b, h) \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match as [B,H,Tq,D], [B,H,Tk,D], [B,H,Tk,D]")
    for name, t in (("q", q), ("k", k), ("v", v)) + more:
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype and name not in ("lse", "delta"):
            raise TypeError(f"flash_attention: {name} is {t.dtype}, "
                            f"q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    for name, t in more:
        if name in ("lse", "delta") and (
                t.dtype != torch.float32
                or tuple(t.shape) != tuple(q.shape[:3])):
            raise ValueError(f"flash_attention: {name} must be float32 "
                             f"{tuple(q.shape[:3])}")
        if name == "dout" and t.shape != q.shape:
            raise ValueError("flash_attention: dout must match q")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if bias is not None and bias.device != q.device:
        raise ValueError(f"flash_attention: bias is on {bias.device}, "
                         f"q on {q.device}")
    return padded_head_dim(d, q.dtype)


def _on_cuda(q, dropout_p):
    """Whether to launch the kernel (a CUDA tensor) or run the plain
    version (a CPU tensor); raises on any other device."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"flash_attention: dropout_p must be in [0, 1), "
                         f"not {dropout_p}")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"not {q.device}")
    return True


def _launch(name, q, k, bias, pointers, causal, scale, dropout_p, seed):
    """Call kernel `name` with its pointers, then the shape, the bias (a
    float32 view expanded to [B,H,Tq,Tk]: stride 0 where it broadcasts,
    so a [B|1,1,1,Tk] mask is read from its own storage), the scalars,
    the dropout arm (an int seed's key, or a ``registry.DeviceSeed``'s
    base key and step word, from which the kernel takes the key at the
    step) and torch's current stream."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if bias is None:
        bias_ptr, strides = None, (0, 0, 0, 0)
    else:
        bb = bias.to(torch.float32)
        bb = bb.reshape((1,) * (4 - bb.dim()) + tuple(bb.shape))
        bb = bb.expand(b, h, tq, tk)
        bias_ptr, strides = bb.data_ptr(), bb.stride()
    k0, k1, step = launch_key(seed, q.device)
    drop = (1, keep_threshold(dropout_p), k0, k1, step,
            1.0 / (1.0 - dropout_p)) if dropout_p else \
        (0, 0, 0, 0, None, 1.0)
    fn, err_str = _kernel(name)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(*pointers[:3], bias_ptr, *pointers[3:], b, h, tq, tk, d,
                _DTYPE_CODES[q.dtype], *strides, float(scale),
                int(bool(causal)), *drop, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err_str(rc).decode()}")


def _ptrs(*ts):
    return [None if t is None else t.data_ptr() for t in ts]


def _cut(t, d):
    """A kernel output [..., dp] cut back to the caller's head dim."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _flash_attention_fwd_impl(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: Optional[torch.Tensor],
                              causal: bool, scale: float, dropout_p: float,
                              seed: int, step_word: Optional[torch.Tensor],
                              with_lse: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's custom op body: on a CUDA tensor the hand kernel (counted in
    ``flash_attention.launches`` here, at run time), on a CPU tensor its
    plain version.  `seed` is an int key, or with `step_word` a
    ``registry.DeviceSeed``'s base.  Returns (out, lse [B,H,Tq] fp32),
    lse empty without `with_lse`."""
    seed = DeviceSeed(seed, step_word) if step_word is not None else seed
    if not _on_cuda(q, dropout_p):
        got = flash_attention_reference(q, k, v, bias, causal, scale,
                                        dropout_p, seed, with_lse)
        return got if with_lse else (got, _no_lse(q))
    dp = _check(q, k, v, bias)
    q_, k_, v_ = (_dense(t, dp) for t in (q, k, v))
    out = torch.empty_like(q_)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) \
        if with_lse else None
    _launch("flash_attention_fwd", q_, k_, bias,
            _ptrs(q_, k_, v_, out, lse), causal, scale, dropout_p, seed)
    flash_attention.launches += 1
    return _cut(out, q.shape[-1]), lse if with_lse else _no_lse(q)


def _no_lse(q):
    return q.new_empty((0,), dtype=torch.float32)


# K1 as a torch.library custom op, so torch.export records a call as one
# graph node and an exported program launches the kernel
_flash_attention_fwd_op = torch.library.custom_op(
    "paddle_tpu_torch::flash_attention_fwd",
    mutates_args=())(_flash_attention_fwd_impl)


@_flash_attention_fwd_op.register_fake
def _flash_attention_fwd_shapes(q, k, v, bias, causal, scale, dropout_p,
                                seed, step_word, with_lse):
    lse = q.new_empty(q.shape[:3], dtype=torch.float32) if with_lse \
        else _no_lse(q)
    return q.new_empty(q.shape), lse


def flash_attention_fwd(q, k, v, bias=None, causal=False, scale=None,
                        dropout_p=0.0, seed=0, with_lse=False):
    """K1 on a CUDA tensor (counted in ``flash_attention.launches``), its
    plain version on a CPU tensor; not differentiable.  Returns out, or
    (out, lse [B,H,Tq] fp32) with `with_lse`.  Under ``torch.export`` (or
    ``torch.compile``) a call of the custom op
    ``paddle_tpu_torch::flash_attention_fwd``; run eagerly, its body
    without the dispatcher's host time (chip_smoke measures both)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if isinstance(seed, DeviceSeed):
        base, word = int(seed.base), seed.step
    else:
        base, word = int(seed), None
    op = _flash_attention_fwd_op if torch.compiler.is_compiling() else \
        _flash_attention_fwd_impl
    out, lse = op(q, k, v, bias, bool(causal), float(scale),
                  float(dropout_p), base, word, bool(with_lse))
    return (out, lse) if with_lse else out


def flash_attention_bwd_dkv(q, k, v, bias, dout, lse, delta, causal=False,
                            scale=None, dropout_p=0.0, seed=0):
    """K2a: (dk, dv) from the forward's lse [B,H,Tq] and delta =
    rowsum(dO·O) [B,H,Tq], both fp32."""
    cuda_build.refuse_export("K2a (flash_attention_bwd_dkv)")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if not _on_cuda(q, dropout_p):
        return _backward_plain(q, k, v, bias, dout, lse, delta, causal,
                               scale, dropout_p, seed)[1:3]
    dp = _check(q, k, v, bias, ("dout", dout), ("lse", lse),
                ("delta", delta))
    q_, k_, v_, do_ = (_dense(t, dp) for t in (q, k, v, dout))
    dk, dv = torch.empty_like(k_), torch.empty_like(v_)
    _launch("flash_attention_bwd_dkv", q_, k_, bias,
            _ptrs(q_, k_, v_, do_, lse, delta, dk, dv), causal, scale,
            dropout_p, seed)
    flash_attention_bwd_dkv.launches += 1
    return _cut(dk, k.shape[-1]), _cut(dv, v.shape[-1])


def _bias_is_row(bias, b, tk):
    """True when `bias` broadcasts as [B|1, 1, 1, Tk] (BERT's padding
    mask): its grad is summed over heads and q rows inside K2b."""
    ps = (1,) * (4 - bias.dim()) + tuple(bias.shape)
    return len(ps) == 4 and ps[1] == 1 and ps[2] == 1 and ps[3] == tk \
        and ps[0] in (1, b)


def flash_attention_bwd_dq(q, k, v, bias, dout, lse, delta, causal=False,
                           scale=None, dropout_p=0.0, seed=0, dbias=False):
    """K2b: (dq, dbias) with dbias in the bias's shape when `dbias` is set
    (else None).  A [B|1,1,1,Tk] bias's grad is reduced over heads and q
    rows in the kernel, by fp32 atomics into a [B, Tk] buffer; any other
    bias's grad is written whole, [B·H, Tq, Tk], and summed down to the
    bias's shape here."""
    cuda_build.refuse_export("K2b (flash_attention_bwd_dq)")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if not _on_cuda(q, dropout_p):
        dq, _, _, ds = _backward_plain(q, k, v, bias, dout, lse, delta,
                                       causal, scale, dropout_p, seed)
        return dq, _unbroadcast(ds, bias) if dbias else None
    dp = _check(q, k, v, bias, ("dout", dout), ("lse", lse),
                ("delta", delta))
    q_, k_, v_, do_ = (_dense(t, dp) for t in (q, k, v, dout))
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    dq = torch.empty_like(q_)
    mode, buf = 0, None
    if dbias:
        row = _bias_is_row(bias, b, tk)
        mode = 1 if row else 2
        # zeros: atomics accumulate into the row buffer, and a causal run
        # never visits the full buffer's tiles above the diagonal
        buf = torch.zeros((b, tk) if row else (b * h, tq, tk),
                          dtype=torch.float32, device=q.device)
    _launch("flash_attention_bwd_dq", q_, k_, bias,
            _ptrs(q_, k_, v_, do_, lse, delta, dq, buf) + [mode], causal,
            scale, dropout_p, seed)
    flash_attention_bwd_dq.launches += 1
    dq = _cut(dq, q.shape[-1])
    if not dbias:
        return dq, None
    return dq, _unbroadcast(buf.reshape((b, 1, 1, tk) if row
                                        else (b, h, tq, tk)), bias)


class _FlashAttention(torch.autograd.Function):
    """K1 with lse forward; K2a and K2b backward (the reference's
    ``_flash_p`` custom_vjp, :495)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, dropout_p, seed):
        out, lse = flash_attention_fwd(q, k, v, bias, causal, scale,
                                       dropout_p, seed, with_lse=True)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (causal, scale, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(dout, out)
        dk, dv = flash_attention_bwd_dkv(q, k, v, bias, dout, lse, delta,
                                         *ctx.args)
        dq, dbias = flash_attention_bwd_dq(
            q, k, v, bias, dout, lse, delta, *ctx.args,
            dbias=bias is not None and ctx.needs_input_grad[3])
        return dq, dk, dv, dbias, None, None, None, None


def flash_attention(q, k, v, bias=None, causal=False, scale=None,
                    dropout_p=0.0, seed=0):
    """softmax(q·kᵀ·scale + bias [+ causal mask])·v over q [B,H,Tq,D],
    k and v [B,H,Tk,D], with dropout of probability `dropout_p` on the
    softmax weights keyed by `seed`.  `bias` is any tensor that
    broadcasts to [B,H,Tq,Tk]; a [B|1,1,1,Tk] padding mask is read as a
    row, never broadcast in memory.  `scale` defaults to 1/sqrt(D).
    Differentiable in q, k, v and bias: under grad the forward saves the
    lse and the backward runs the FlashAttention-2 kernels."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return _FlashAttention.apply(q, k, v, bias, causal, scale,
                                     dropout_p, seed)
    return flash_attention_fwd(q, k, v, bias, causal, scale, dropout_p,
                               seed)


class _FlashAttentionLse(torch.autograd.Function):
    """K3: K1 with lse forward, returning (out, lse); backward K2a and K2b
    with the lse cotangent folded into delta (the reference's
    ``flash_attention_with_lse`` custom_vjp, :883-913)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, None, causal, scale,
                                       with_lse=True)
        if q.device.type == "cuda":
            flash_attention_with_lse.launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = torch.zeros_like(out) if dout is None else dout.contiguous()
        # d lse_i / d s_ij = P_ij, so dS = P·(dP - delta + dlse): the
        # kernels take delta - dlse where they took delta
        delta = attention_delta(dout, out)
        if dlse is not None:
            delta = delta - dlse.float()
        args = (q, k, v, None, dout, lse, delta.contiguous(), *ctx.args)
        dk, dv = flash_attention_bwd_dkv(*args)
        dq, _ = flash_attention_bwd_dq(*args)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal=False, scale=None):
    """K3: attention over [B,H,T,D] returning (out, lse [B,H,Tq] fp32),
    with no bias and no dropout (ring attention's in-shard tier needs
    neither).  Differentiable in q, k and v, through lse too: a None
    lse cotangent counts as zero.  On a CUDA tensor the forward launches
    K1 with lse (counted here and in ``flash_attention.launches``) and
    the backward K2a and K2b; on a CPU tensor the plain versions run."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttentionLse.apply(q, k, v, causal, scale)


flash_attention.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_with_lse.launches = 0
