"""LSTM cell and GRU output gate — the port of two TPU kernels of
``paddle_tpu/ops/pallas_kernels.py``:

- K8 ``_lstm_cell_kernel`` (:1194, reached through ``_fused_lstm_cell_p``
  -> ``pl.pallas_call`` :1245): :func:`fused_lstm_cell`;
- K9 ``_gru_cell_kernel`` (:1267, reached through ``_fused_gru_p`` ->
  ``pl.pallas_call`` :1310): :func:`fused_gru_output`.

Both become ``csrc/rnn_cells.cu``, written by hand for Hopper.  Each
wrapper launches its CUDA kernel on a CUDA tensor (counted in
``fused_lstm_cell.launches`` / ``fused_gru_output.launches``) and takes its
plain PyTorch version (:func:`lstm_cell_reference`,
:func:`gru_output_reference`) only for a CPU tensor; on a CUDA tensor it
launches or raises.  Both are differentiable through a
``torch.autograd.Function`` whose backward is the plain version's
vector-Jacobian product, recomputed from the saved inputs, as the
reference's ``custom_vjp`` (:1253-1264, :1317-1332) has no backward
kernel.  Every B and D runs: the TPU arm's D % 128 fallback (:1229,
:1293) is not ported, by design.
"""

import ctypes

import torch

from . import cuda_build

_SOURCE = "rnn_cells"
_libs = {}


def lstm_cell_reference(gates, c_prev):
    """Plain version of K8 (``_lstm_cell_composed``, :1208): gates [B, 4D]
    in (c, i, f, o) order, c_prev [B, D] -> (h, c)."""
    gc, gi, gf, go = torch.chunk(gates, 4, dim=-1)
    i = torch.sigmoid(gi)
    f = torch.sigmoid(gf)
    o = torch.sigmoid(go)
    c = f * c_prev + i * torch.tanh(gc)
    return o * torch.tanh(c), c


def gru_output_reference(gu, gc, h_prev, origin_mode=False):
    """Plain version of K9 (``_gru_output_composed``, :1280)."""
    u = torch.sigmoid(gu)
    c = torch.tanh(gc)
    return u * h_prev + (1 - u) * c if origin_mode \
        else (1 - u) * h_prev + u * c


def _kernel(name):
    """(entry point, error-string function), built and loaded at first
    use."""
    fn = _libs.get(name)
    if fn is None:
        lib = cuda_build.load(_SOURCE)
        entry = getattr(lib, name)
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        entry.argtypes = {
            "lstm_cell_fwd": [p, ll, p, ll, p, p, i, i, p],
            "gru_output_fwd": [p, ll, p, ll, p, ll, p, i, i, i, p],
        }[name]
        entry.restype = ctypes.c_int
        lib.rnn_cells_error_string.argtypes = [ctypes.c_int]
        lib.rnn_cells_error_string.restype = ctypes.c_char_p
        fn = _libs[name] = (entry, lib.rnn_cells_error_string)
    return fn


def _on_cuda(name, *ts):
    """Whether to launch the kernel (CUDA tensors) or run the plain
    version (CPU tensors).  Raises on mixed devices, other devices, or what
    the kernel does not take: fp32 matrices with unit stride along the
    row."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {dev}")
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32, not {t.dtype}")
        if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
            raise ValueError(f"{name} kernel takes [B, N] matrices with "
                             f"unit stride along the row, not shape "
                             f"{tuple(t.shape)} stride {t.stride()}")
    return True


def _launch(name, dev, *args):
    fn, err_str = _kernel(name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err_str(rc).decode()}")


def _ld(t):
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def lstm_cell_fwd(gates, c_prev):
    """K8 on CUDA tensors, its plain version on CPU tensors; not
    differentiable.  gates fp32 [B, 4D], c_prev fp32 [B, D] -> (h, c)."""
    b, four_d = gates.shape
    d = four_d // 4
    if four_d != 4 * d or tuple(c_prev.shape) != (b, d):
        raise ValueError(f"fused_lstm_cell: gates {tuple(gates.shape)} and "
                         f"c_prev {tuple(c_prev.shape)} are not [B, 4D] "
                         f"and [B, D]")
    if not _on_cuda("fused_lstm_cell", gates, c_prev):
        return lstm_cell_reference(gates, c_prev)
    h = torch.empty((b, d), dtype=torch.float32, device=gates.device)
    c = torch.empty_like(h)
    if b and d:
        _launch("lstm_cell_fwd", gates.device, gates.data_ptr(),
                _ld(gates), c_prev.data_ptr(), _ld(c_prev), h.data_ptr(),
                c.data_ptr(), b, d)
        fused_lstm_cell.launches += 1
    return h, c


def gru_output_fwd(gu, gc, h_prev, origin_mode=False):
    """K9 on CUDA tensors, its plain version on CPU tensors; not
    differentiable.  gu, gc, h_prev fp32 [B, D] -> [B, D]."""
    if not (gu.shape == gc.shape == h_prev.shape) or gu.dim() != 2:
        raise ValueError(f"fused_gru_output: gu {tuple(gu.shape)}, gc "
                         f"{tuple(gc.shape)}, h_prev {tuple(h_prev.shape)} "
                         f"are not all [B, D]")
    if not _on_cuda("fused_gru_output", gu, gc, h_prev):
        return gru_output_reference(gu, gc, h_prev, origin_mode)
    b, d = gu.shape
    out = torch.empty((b, d), dtype=torch.float32, device=gu.device)
    if b and d:
        _launch("gru_output_fwd", gu.device, gu.data_ptr(), _ld(gu),
                gc.data_ptr(), _ld(gc), h_prev.data_ptr(), _ld(h_prev),
                out.data_ptr(), b, d, int(bool(origin_mode)))
        fused_gru_output.launches += 1
    return out


def _plain_vjp(fn, inputs, cotangents):
    """Grads of the plain version at `inputs` against `cotangents`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return torch.autograd.grad(outs, leaves, cotangents)


class _LstmCell(torch.autograd.Function):
    """K8 forward; the plain version's vjp backward (the reference's
    ``_fused_lstm_cell_bwd``, :1258)."""

    @staticmethod
    def forward(ctx, gates, c_prev):
        ctx.save_for_backward(gates, c_prev)
        return lstm_cell_fwd(gates, c_prev)

    @staticmethod
    def backward(ctx, dh, dc):
        return tuple(_plain_vjp(lstm_cell_reference, ctx.saved_tensors,
                                (dh, dc)))


class _GruOutput(torch.autograd.Function):
    """K9 forward; the plain version's vjp backward (the reference's
    ``_fused_gru_bwd``, :1324)."""

    @staticmethod
    def forward(ctx, gu, gc, h_prev, origin_mode):
        ctx.save_for_backward(gu, gc, h_prev)
        ctx.origin_mode = origin_mode
        return gru_output_fwd(gu, gc, h_prev, origin_mode)

    @staticmethod
    def backward(ctx, dout):
        mode = ctx.origin_mode
        grads = _plain_vjp(
            lambda a, b, c: gru_output_reference(a, b, c, mode),
            ctx.saved_tensors, (dout,))
        return (*grads, None)


def _needs_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def fused_lstm_cell(gates, c_prev):
    """gates fp32 [B, 4D] (c, i, f, o pre-activations), c_prev [B, D] ->
    (h, c), differentiable in both."""
    if _needs_grad(gates, c_prev):
        return _LstmCell.apply(gates, c_prev)
    return lstm_cell_fwd(gates, c_prev)


def fused_gru_output(gu, gc, h_prev, origin_mode=False):
    """GRU final output from the update-gate and candidate pre-activations
    gu, gc and h_prev, all fp32 [B, D]; differentiable in all three."""
    if _needs_grad(gu, gc, h_prev):
        return _GruOutput.apply(gu, gc, h_prev, bool(origin_mode))
    return gru_output_fwd(gu, gc, h_prev, origin_mode)


fused_lstm_cell.launches = 0
fused_gru_output.launches = 0
