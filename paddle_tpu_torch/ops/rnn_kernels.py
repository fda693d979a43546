"""LSTM and GRU time steps — the port of two TPU kernels of
``paddle_tpu/ops/pallas_kernels.py`` with the product and the length mask
around each in the reference's scan body (``paddle_tpu/ops/rnn_ops.py``
:63-93, :165-189):

- K8 ``_lstm_cell_kernel`` (:1194, reached through ``_fused_lstm_cell_p``
  -> ``pl.pallas_call`` :1245): :func:`lstm_step`, one LSTM time step, and
  :func:`fused_lstm_cell`, the cell alone;
- K9 ``_gru_cell_kernel`` (:1267, reached through ``_fused_gru_p`` ->
  ``pl.pallas_call`` :1310): :func:`gru_step`, the GRU step's candidate
  product, output gate and mask, and :func:`fused_gru_output`, the output
  gate alone.

Each pair runs one hand-written kernel of ``csrc/rnn_cells.cu``: the cell
entries pass it no weight and no lengths.  Each wrapper launches the kernel
on a CUDA tensor (every launch of K8 counted in
``fused_lstm_cell.launches``, of K9 in ``fused_gru_output.launches``) and
takes its plain PyTorch version (:func:`lstm_step_reference`,
:func:`gru_step_reference`, :func:`lstm_cell_reference`,
:func:`gru_output_reference`) only for a CPU tensor; on a CUDA tensor it
launches or raises.  All are differentiable through a
``torch.autograd.Function`` whose backward is the plain version's
vector-Jacobian product, recomputed from the saved inputs, as the
reference's ``custom_vjp`` (:1253-1264, :1317-1332) has no backward
kernel.  Every B and D runs: the TPU arm's D % 128 fallback (:1229,
:1293) is not ported, by design.  K8's step also takes the ``lstm`` op's
peepholes (``peep``, the [3, D] tail of its Bias) and every activation
set of the op (``acts``: gate, cell and candidate activations, each one of
:data:`ACTIVATIONS`), which the reference leaves to its composed cell
(``rnn_ops._pallas_cell_ok``).
"""

import ctypes

import torch

from . import cuda_build

_SOURCE = "rnn_cells"
_libs = {}

# the ``lstm`` op's activations (the reference's rnn_ops.py:25-30 _ACT), in
# the order of the kernel's codes (csrc/rnn_cells.cu, Act)
ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}
# (gate, cell, candidate) activations: the op's defaults
DEFAULT_ACTS = ("sigmoid", "tanh", "tanh")


def act_code(acts):
    """The kernel's code of an activation set (gate, cell, candidate):
    2 bits each, gate | cell << 2 | candidate << 4.  Raises KeyError for
    a name outside :data:`ACTIVATIONS`, as the composed cell does."""
    names = list(ACTIVATIONS)
    code = 0
    for shift, name in zip((0, 2, 4), acts):
        if name not in ACTIVATIONS:
            raise KeyError(f"LSTM activation {name!r} is not one of "
                           f"{names}")
        code |= names.index(name) << shift
    return code


def lstm_cell_reference(gates, c_prev, peep=None, acts=DEFAULT_ACTS):
    """Plain version of K8's cell (``_lstm_cell_composed``, :1208): gates
    [B, 4D] in (c, i, f, o) order, c_prev [B, D] -> (h, c).  With `peep`
    [3D] (w_ic | w_fc | w_oc), the peepholes of the ``lstm`` op's composed
    cell (``rnn_ops.py``): gi + c_prev * w_ic, gf + c_prev * w_fc, and
    go + c * w_oc.  `acts`: the (gate, cell, candidate) activations."""
    gate_act, cell_act, cand_act = (ACTIVATIONS[a] for a in acts)
    gc, gi, gf, go = torch.chunk(gates, 4, dim=-1)
    if peep is not None:
        w_ic, w_fc, w_oc = peep.reshape(3, -1)
        gi = gi + c_prev * w_ic
        gf = gf + c_prev * w_fc
    i = gate_act(gi)
    f = gate_act(gf)
    c = f * c_prev + i * cand_act(gc)
    if peep is not None:
        go = go + c * w_oc
    o = gate_act(go)
    return o * cell_act(c), c


def gru_output_reference(gu, gc, h_prev, origin_mode=False):
    """Plain version of K9's output gate (``_gru_output_composed``,
    :1280)."""
    u = torch.sigmoid(gu)
    c = torch.tanh(gc)
    return u * h_prev + (1 - u) * c if origin_mode \
        else (1 - u) * h_prev + u * c


def valid_mask(lens, step, dtype):
    """[B, 1] 0/1: whether time `step` lies inside each row."""
    return (step < lens).to(dtype)[:, None]


def lstm_step_reference(xg, h_prev, c_prev, w, lens, step, peep=None,
                        acts=DEFAULT_ACTS):
    """Plain version of one LSTM time step (the reference's scan body,
    rnn_ops.py:63-93): the product, the cell, the mask.  xg [B, 4D],
    h_prev, c_prev [B, D], w [D, 4D], lens [B], peep [3D] or None, acts
    the (gate, cell, candidate) activations -> the carries (h, c) and the
    emitted (h, c), zero past each row's length."""
    gates = xg + h_prev @ w
    h, c = lstm_cell_reference(gates, c_prev, peep, acts)
    valid = valid_mask(lens, step, xg.dtype)
    h = h * valid + h_prev * (1 - valid)
    c = c * valid + c_prev * (1 - valid)
    return h, c, h * valid, c * valid


def gru_step_reference(ur_pre, xg_c, h_prev, w_c, lens, step,
                       origin_mode=False):
    """Plain version of the GRU time step after its first product (the
    reference's scan body, rnn_ops.py:165-189): ur_pre [B, 2D] the update
    and reset pre-activations, xg_c [B, D] the candidate's input part,
    w_c [D, D] -> the carry h and the emitted h, zero past each row's
    length."""
    d = h_prev.shape[1]
    _, r = torch.chunk(torch.sigmoid(ur_pre), 2, dim=-1)
    cand_pre = xg_c + (r * h_prev) @ w_c
    h = gru_output_reference(ur_pre[:, :d], cand_pre, h_prev, origin_mode)
    valid = valid_mask(lens, step, h.dtype)
    h = h * valid + h_prev * (1 - valid)
    return h, h * valid


def gru_gate_pre(xg_ur, h_prev, w_ur):
    """The GRU step's first product, the update and reset pre-activations
    xg_ur + h_prev @ w_ur [B, 2D]: one ``torch.addmm`` on the card; on the
    CPU the sum of the product, as the CPU results have always been
    computed."""
    if xg_ur.device.type == "cpu":
        return xg_ur + h_prev @ w_ur
    return torch.addmm(xg_ur, h_prev, w_ur)


def _kernel(name):
    """(entry point, error-string function), built and loaded at first
    use."""
    fn = _libs.get(name)
    if fn is None:
        lib = cuda_build.load(_SOURCE)
        entry = getattr(lib, name)
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        entry.argtypes = {
            "lstm_step_fwd": [p, ll, p, ll, p, ll, p, ll, p, p, i, p, p, p,
                              p, i, i, i, p],
            "gru_step_fwd": [p, ll, p, ll, p, ll, p, ll, p, i, p, p, i, i,
                             i, p],
        }[name]
        entry.restype = ctypes.c_int
        lib.rnn_cells_error_string.argtypes = [ctypes.c_int]
        lib.rnn_cells_error_string.restype = ctypes.c_char_p
        fn = _libs[name] = (entry, lib.rnn_cells_error_string)
    return fn


def _on_cuda(name, *ts, lens=None):
    """Whether to launch the kernel (CUDA tensors) or run the plain
    version (CPU tensors).  Raises on mixed devices, other devices, or what
    the kernel does not take: fp32 matrices with unit stride along the
    row, and int32 lengths, one a row."""
    dev = ts[0].device
    for t in ts + ((lens,) if lens is not None else ()):
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
    if lens is not None and (lens.dtype != torch.int32
                             or not lens.is_contiguous()):
        raise TypeError(f"{name} kernel takes contiguous int32 lengths, "
                        f"not {lens.dtype} stride {lens.stride()}")
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, **shapes):
    """Raises unless each tensor (name -> (tensor, shape)) has its
    shape."""
    for arg, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} is not "
                             f"{want} " + ", ".join(
                                 f"{a} {tuple(x.shape)}"
                                 for a, (x, _) in shapes.items()))


def _lstm_launch(xg, h_prev, c_prev, w, lens, step, emit, peep=None,
                 acts=DEFAULT_ACTS):
    b, d = c_prev.shape
    outs = [torch.empty((b, d), dtype=torch.float32, device=c_prev.device)
            for _ in range(4 if emit else 2)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    if b and d:
        _launch("lstm_step_fwd", c_prev.device, xg.data_ptr(), _ld(xg),
                _ptr(h_prev), 0 if h_prev is None else _ld(h_prev),
                c_prev.data_ptr(), _ld(c_prev), _ptr(w),
                0 if w is None else _ld(w), _ptr(peep), _ptr(lens), step,
                *ptrs, b, d, act_code(acts))
        fused_lstm_cell.launches += 1
    return tuple(outs)


def _gru_launch(ur, xc, h_prev, w_c, lens, step, origin_mode, emit):
    b, d = h_prev.shape
    outs = [torch.empty((b, d), dtype=torch.float32, device=h_prev.device)
            for _ in range(2 if emit else 1)]
    if b and d:
        _launch("gru_step_fwd", h_prev.device, ur.data_ptr(), _ld(ur),
                xc.data_ptr(), _ld(xc), h_prev.data_ptr(), _ld(h_prev),
                _ptr(w_c), 0 if w_c is None else _ld(w_c), _ptr(lens), step,
                outs[0].data_ptr(), _ptr(outs[1]) if emit else None, b, d,
                int(bool(origin_mode)))
        fused_gru_output.launches += 1
    return tuple(outs)


def lstm_step_fwd(xg, h_prev, c_prev, w, lens, step, peep=None,
                  acts=DEFAULT_ACTS):
    """K8 on CUDA tensors, its plain version on CPU tensors; not
    differentiable.  xg fp32 [B, 4D] (any row stride: x[:, step] of the
    [B, T, 4D] input), h_prev, c_prev fp32 [B, D], w fp32 [D, 4D], lens
    int32 [B], peep fp32 [3D] contiguous or None, acts the (gate, cell,
    candidate) activations -> (h, c, h_emit, c_emit)."""
    b, d = c_prev.shape
    _check("lstm_step", xg=(xg, (b, 4 * d)), h_prev=(h_prev, (b, d)),
           c_prev=(c_prev, (b, d)), w=(w, (d, 4 * d)), lens=(lens, (b,)))
    if peep is not None:
        _check("lstm_step", peep=(peep, (3 * d,)))
    if not _on_cuda("lstm_step", xg, h_prev, c_prev, w, lens=lens):
        return lstm_step_reference(xg, h_prev, c_prev, w, lens, step, peep,
                                   acts)
    if peep is not None and (peep.device != xg.device
                             or peep.dtype != torch.float32
                             or not peep.is_contiguous()):
        raise ValueError(f"lstm_step kernel takes contiguous float32 "
                         f"peepholes on {xg.device}, not {peep.dtype} on "
                         f"{peep.device} stride {peep.stride()}")
    return _lstm_launch(xg, h_prev, c_prev, w, lens, step, emit=True,
                        peep=peep, acts=acts)


def gru_step_fwd(ur_pre, xg_c, h_prev, w_c, lens, step, origin_mode=False):
    """K9 on CUDA tensors, its plain version on CPU tensors; not
    differentiable.  ur_pre fp32 [B, 2D], xg_c fp32 [B, D] (any row
    stride: x[:, step, 2D:]), h_prev fp32 [B, D], w_c fp32 [D, D] (any row
    stride: w[:, 2D:]), lens int32 [B] -> (h, h_emit)."""
    b, d = h_prev.shape
    _check("gru_step", ur_pre=(ur_pre, (b, 2 * d)), xg_c=(xg_c, (b, d)),
           h_prev=(h_prev, (b, d)), w_c=(w_c, (d, d)), lens=(lens, (b,)))
    if not _on_cuda("gru_step", ur_pre, xg_c, h_prev, w_c, lens=lens):
        return gru_step_reference(ur_pre, xg_c, h_prev, w_c, lens, step,
                                  origin_mode)
    return _gru_launch(ur_pre, xg_c, h_prev, w_c, lens, step, origin_mode,
                       emit=True)


def lstm_cell_fwd(gates, c_prev):
    """K8 with no product and no mask on CUDA tensors, its plain version
    on CPU tensors; not differentiable.  gates fp32 [B, 4D], c_prev fp32
    [B, D] -> (h, c)."""
    b, four_d = gates.shape
    d = four_d // 4
    if four_d != 4 * d or tuple(c_prev.shape) != (b, d):
        raise ValueError(f"fused_lstm_cell: gates {tuple(gates.shape)} and "
                         f"c_prev {tuple(c_prev.shape)} are not [B, 4D] "
                         f"and [B, D]")
    if not _on_cuda("fused_lstm_cell", gates, c_prev):
        return lstm_cell_reference(gates, c_prev)
    return _lstm_launch(gates, None, c_prev, None, None, 0, emit=False)


def gru_output_fwd(gu, gc, h_prev, origin_mode=False):
    """K9 with no product and no mask on CUDA tensors, its plain version
    on CPU tensors; not differentiable.  gu, gc, h_prev fp32 [B, D] ->
    [B, D]."""
    if not (gu.shape == gc.shape == h_prev.shape) or gu.dim() != 2:
        raise ValueError(f"fused_gru_output: gu {tuple(gu.shape)}, gc "
                         f"{tuple(gc.shape)}, h_prev {tuple(h_prev.shape)} "
                         f"are not all [B, D]")
    if not _on_cuda("fused_gru_output", gu, gc, h_prev):
        return gru_output_reference(gu, gc, h_prev, origin_mode)
    return _gru_launch(gu, gc, h_prev, None, None, 0, origin_mode,
                       emit=False)[0]


def _plain_vjp(fn, inputs, cotangents, needs):
    """Grads of the plain version at `inputs` against `cotangents`, for
    the inputs flagged in `needs` (None for the others)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wanted = [x for x, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(outs, wanted, cotangents,
                                         allow_unused=True))
        return tuple(next(grads) if n else None for n in needs)


class _LstmStep(torch.autograd.Function):
    """K8 forward; the plain step's vjp backward."""

    @staticmethod
    def forward(ctx, xg, h_prev, c_prev, w, lens, step, peep, acts):
        ctx.save_for_backward(xg, h_prev, c_prev, w, lens, peep)
        ctx.step, ctx.acts = step, acts
        return lstm_step_fwd(xg, h_prev, c_prev, w, lens, step, peep, acts)

    @staticmethod
    def backward(ctx, *cots):
        xg, h_prev, c_prev, w, lens, peep = ctx.saved_tensors
        step, acts = ctx.step, ctx.acts
        extra = () if peep is None else (peep,)
        grads = _plain_vjp(
            lambda *a: lstm_step_reference(*a[:4], lens, step,
                                           *(a[4:] or (None,)), acts),
            (xg, h_prev, c_prev, w) + extra, cots,
            ctx.needs_input_grad[:4] + ctx.needs_input_grad[6:7][:len(extra)])
        return (*grads[:4], None, None, *(grads[4:] or (None,)), None)


class _GruStep(torch.autograd.Function):
    """K9 forward; the plain step's vjp backward."""

    @staticmethod
    def forward(ctx, ur_pre, xg_c, h_prev, w_c, lens, step, origin_mode):
        ctx.save_for_backward(ur_pre, xg_c, h_prev, w_c, lens)
        ctx.step, ctx.origin_mode = step, origin_mode
        return gru_step_fwd(ur_pre, xg_c, h_prev, w_c, lens, step,
                            origin_mode)

    @staticmethod
    def backward(ctx, *cots):
        ur_pre, xg_c, h_prev, w_c, lens = ctx.saved_tensors
        step, mode = ctx.step, ctx.origin_mode
        grads = _plain_vjp(
            lambda a, b, c, d: gru_step_reference(a, b, c, d, lens, step,
                                                  mode),
            (ur_pre, xg_c, h_prev, w_c), cots, ctx.needs_input_grad[:4])
        return (*grads, None, None, None)


class _LstmCell(torch.autograd.Function):
    """K8's cell forward; the plain version's vjp backward (the
    reference's ``_fused_lstm_cell_bwd``, :1258)."""

    @staticmethod
    def forward(ctx, gates, c_prev):
        ctx.save_for_backward(gates, c_prev)
        return lstm_cell_fwd(gates, c_prev)

    @staticmethod
    def backward(ctx, dh, dc):
        return _plain_vjp(lstm_cell_reference, ctx.saved_tensors, (dh, dc),
                          ctx.needs_input_grad)


class _GruOutput(torch.autograd.Function):
    """K9's output gate forward; the plain version's vjp backward (the
    reference's ``_fused_gru_bwd``, :1324)."""

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
            ctx.saved_tensors, (dout,), ctx.needs_input_grad[:3])
        return (*grads, None)


def _needs_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def lstm_step(xg, h_prev, c_prev, w, lens, step, peep=None,
              acts=DEFAULT_ACTS):
    """One LSTM time step: gates = xg + h_prev @ w in (c, i, f, o) order,
    the cell (with the peepholes `peep` [3D], w_ic | w_fc | w_oc, where
    given, and the (gate, cell, candidate) activations `acts`), then the
    mask step < lens.  xg fp32 [B, 4D], h_prev, c_prev [B, D], w [D, 4D],
    lens int32 [B] -> (h, c, h_emit, c_emit): the carries (h_prev, c_prev
    past a row's length) and the emitted pair (zero there);
    differentiable in xg, h_prev, c_prev, w and peep."""
    grads = (xg, h_prev, c_prev, w) + (() if peep is None else (peep,))
    if _needs_grad(*grads):
        return _LstmStep.apply(xg, h_prev, c_prev, w, lens, step, peep,
                               acts)
    return lstm_step_fwd(xg, h_prev, c_prev, w, lens, step, peep, acts)


def gru_step(ur_pre, xg_c, h_prev, w_c, lens, step, origin_mode=False):
    """The GRU time step after its first product (:func:`gru_gate_pre`):
    the candidate xg_c + (sigmoid(reset) * h_prev) @ w_c, the output gate
    with sigmoid(update), then the mask step < lens.  -> (h, h_emit);
    differentiable in ur_pre, xg_c, h_prev and w_c."""
    if _needs_grad(ur_pre, xg_c, h_prev, w_c):
        return _GruStep.apply(ur_pre, xg_c, h_prev, w_c, lens, step,
                              bool(origin_mode))
    return gru_step_fwd(ur_pre, xg_c, h_prev, w_c, lens, step, origin_mode)


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


# every launch of K8 (lstm_step and fused_lstm_cell) and of K9 (gru_step
# and fused_gru_output)
fused_lstm_cell.launches = 0
fused_gru_output.launches = 0
