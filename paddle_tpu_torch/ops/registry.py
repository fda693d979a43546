"""Op kernel registry — the port of ``paddle_tpu/ops/registry.py``.

Every op registers ONE kernel written over torch tensors::

    def kernel(ins: dict[str, list[torch.Tensor]], attrs: dict) -> dict[str, list]

The Executor (``core/executor.py``) interprets a block op by op and calls
:func:`run_op` for each, so a kernel may use ordinary Python control flow
on shapes and attrs.  Kernels allocate on the device of their inputs, or
on :func:`current` ``().device`` when they have none (initializers).

Per-run state the Executor exposes to kernels — the run's device, its
``torch.Generator``, the program seed, the step and ``is_test`` — lives in
a thread-local :class:`ExecContext` (the counterpart of the reference's
``TRACE_CTX``), so a serving worker thread and a caller thread never see
each other's run.

The registry also holds the generic reverse-mode grad kernel: ``*_grad``
ops recompute the forward op under torch autograd and take its vector-
Jacobian product (:func:`generic_grad_kernel`), where the reference
recomputes under ``jax.vjp``.  Ops may register a custom grad kernel with
:func:`register_grad`; the set of custom grads and of ops marked
``not_differentiable`` is the reference's, because ``append_backward``
reads both and so they shape the program, not only the numbers.  Kernels
never update a tensor in place: a grad op reads forward inputs after
later ops have run.
"""

import contextlib
import threading

import numpy as np
import torch

_KERNELS = {}
_CUSTOM_GRADS = {}
_NOT_DIFFERENTIABLE = set()

# The JAX package's bf16 AMP lists (paddle_tpu/ops/registry.py:82-97), as
# data: the passes (amp_propagate, the verifier's amp-dtype-mix rule) read
# them.  The AMP cast wrap around kernel dispatch is not ported yet.
_AMP_WHITE = {"conv2d", "depthwise_conv2d", "conv2d_transpose", "mul",
              "matmul"}
_AMP_BLACK = {"softmax", "cross_entropy",
              "sigmoid_cross_entropy_with_logits", "mean", "reduce_mean",
              "reduce_sum", "sum", "exp", "log", "square", "cos_sim",
              "sqrt", "rsqrt", "pow"}
_AMP_EXEMPT = {"batch_norm", "layer_norm", "softmax_with_cross_entropy"}


class ExecContext:
    """State of the run in progress on this thread.  `masks`, when given,
    keeps each dropout mask the run draws, so the generic grad's
    recompute of a dropout op reuses the forward's mask instead of
    drawing the same bits again (the mask is a pure function of its
    key, so this changes no result)."""

    def __init__(self, device=None, generator=None, seed=0, step=0,
                 is_test=False, masks=None):
        self.device = device if device is not None else torch.device("cpu")
        self.generator = generator
        self.seed = seed            # program.random_seed
        self.step = step            # executor step counter
        self.is_test = is_test
        self.masks = masks


_LOCAL = threading.local()


def current():
    """The ExecContext of the run in progress on this thread (a CPU,
    train-mode default outside any run — what direct run_op calls see)."""
    ctx = getattr(_LOCAL, "ctx", None)
    if ctx is None:
        ctx = _LOCAL.ctx = ExecContext()
    return ctx


@contextlib.contextmanager
def exec_context(ctx):
    """Make `ctx` current on this thread for the duration of a run."""
    prev = getattr(_LOCAL, "ctx", None)
    _LOCAL.ctx = ctx
    try:
        yield ctx
    finally:
        _LOCAL.ctx = prev


@contextlib.contextmanager
def test_mode():
    """Run everything inside in inference mode (``is_test``): what the
    Predictor sets around its runs, as the reference's Predictor runs
    programs whose ``_is_test`` is set."""
    prev = getattr(_LOCAL, "test_mode", False)
    _LOCAL.test_mode = True
    try:
        yield
    finally:
        _LOCAL.test_mode = prev


def in_test_mode():
    return getattr(_LOCAL, "test_mode", False)


def op_seed(attrs):
    """Seed of one random op's draw: the reference's key recipe
    (``nn_ops._rng`` / ``_op_seed_scalar``) over (program seed, op seed,
    step).  The draws differ from the JAX package's by design — torch and
    jax generators are different streams."""
    ctx = current()
    seed = attrs.get("seed", 0) or attrs.get("op_seed", 0)
    base = (ctx.seed * 1000003 + seed * 7919 + 17) % (2**31 - 1)
    return base ^ (ctx.step * 40503)


_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def philox4x32(ctr, key):
    """Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32) over
    int64 tensors holding 32-bit words: `ctr` [4, ...] counters, `key`
    two Python ints.  Returns the four output words [4, ...].  The same
    bits on every device, and the same bits the port's CUDA kernels
    generate, so a mask drawn on the CPU equals the one drawn on the
    card.  Every product stays below 2**63: c·M is taken as 2·c·(M>>1)
    + c (both multipliers are odd).  The round keys and multipliers are
    made on the device (no host-to-device copy, which would wait for
    the card)."""
    dev, shape = ctr.device, (2,) + (1,) * (ctr.dim() - 1)
    two = torch.arange(2, dtype=torch.int64, device=dev)
    half = (two * ((_PHILOX_M[1] >> 1) - (_PHILOX_M[0] >> 1))
            + (_PHILOX_M[0] >> 1)).reshape(shape)
    rounds = torch.arange(10, dtype=torch.int64, device=dev)
    keys = torch.stack([(rounds * w + (k & _MASK32)) & _MASK32
                        for w, k in zip(_PHILOX_W, key)], dim=1)
    a, b = ctr[0::2], ctr[1::2]                 # [c0, c2], [c1, c3]
    for r in range(10):
        p = a * half
        t = ((p & 0x7FFFFFFF) << 1) + a
        hi = (p >> 31) + (t >> 32)              # [hi(c0·M0), hi(c2·M1)]
        lo = (t & _MASK32).flip(0)              # [lo(c2·M1), lo(c0·M0)]
        a = hi.flip(0) ^ b ^ keys[r].reshape(shape)
        b = lo
    return torch.stack([a[0], b[0], a[1], b[1]])


def keep_threshold(p):
    """uint32 threshold t with P(bits < t) = 1 - p: the reference's
    ``pallas_kernels._keep_threshold``."""
    return min(2**32 - 1, round((1.0 - p) * 2**32))


def seed_key(seed):
    """A (non-negative) op seed as a Philox key of two 32-bit words."""
    return seed & _MASK32, (seed >> 32) & _MASK32


def dropout_keep(seed, shape, p, device):
    """Keep mask of one dropout draw: element i (row-major) takes word
    i % 4 of Philox at counter (i // 4, 0, 0, 0) under key `seed`, and
    is kept when that word is below :func:`keep_threshold` (p)."""
    n = 1
    for s in shape:
        n *= s
    j = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(j)
    bits = philox4x32(torch.stack([j & _MASK32, j >> 32, zero, zero]),
                      seed_key(seed))
    return (bits.t().reshape(-1)[:n] < keep_threshold(p)).reshape(shape)


def generator_for(attrs):
    """The run's generator, reseeded for this op (so a draw depends only
    on the op and the step, not on the order other ops drew in)."""
    ctx = current()
    gen = ctx.generator
    if gen is None or gen.device != ctx.device:
        gen = ctx.generator = torch.Generator(device=ctx.device)
    gen.manual_seed(op_seed(attrs))
    return gen


def register(op_type, not_differentiable=False):
    def deco(fn):
        _KERNELS[op_type] = fn
        if not_differentiable:
            _NOT_DIFFERENTIABLE.add(op_type)
        return fn
    return deco


def register_grad(op_type):
    """Register a custom grad kernel for `op_type` (overrides the generic
    recompute-and-autograd kernel)."""
    def deco(fn):
        _CUSTOM_GRADS[op_type] = fn
        return fn
    return deco


def get_kernel(op_type, attrs=None):
    """The kernel of `op_type`.  An op the quantize pass annotated
    (``__quant__`` in `attrs`, passes/quantize.py) runs the quantized
    matmul over its int8 weight and Scale operand instead
    (``ops/quant_kernels.make_quant_kernel``).  Other annotations
    (``__isolate__``, ``__amp__``) change nothing here."""
    if op_type not in _KERNELS:
        raise NotImplementedError(
            f"No kernel registered for op {op_type!r} in the PyTorch port. "
            f"Known: {sorted(_KERNELS)}")
    quant = attrs.get("__quant__") if isinstance(attrs, dict) else None
    if quant is not None:
        from . import quant_kernels

        return quant_kernels.make_quant_kernel(op_type, quant)
    return _KERNELS[op_type]


def get_custom_grad(op_type):
    return _CUSTOM_GRADS.get(op_type)


def is_differentiable(op_type):
    return op_type not in _NOT_DIFFERENTIABLE


def first(ins, slot):
    vs = ins.get(slot) or []
    return vs[0] if vs else None


def as_out(x):
    return {"Out": [x]}


def has_out_grad(ins, slot):
    """Whether a grad op was handed an incoming grad for forward output
    `slot` (custom grads fall back to the generic kernel when one of the
    outputs they do not handle carries a grad)."""
    vs = ins.get(f"{slot}@GRAD_OUT")
    return bool(vs) and vs[0] is not None


# ---------------------------------------------------------------------------
# Generic grad kernel.  backward.append_backward emits ops of type
# "generic_grad" with attrs describing the forward op; this kernel reruns
# the forward kernel under torch autograd w.r.t. the inputs that need
# grads and takes the vector-Jacobian product with the incoming grads.
# ---------------------------------------------------------------------------

def generic_grad_kernel(ins, attrs):
    from ..core.framework import Block

    fw_type = attrs["fw_type"]
    fw_attrs = attrs["fw_attrs"]
    # Block-valued attrs (dynamic_rnn's step block) ride as top-level
    # grad-op attrs (core/backward.py); fold them back for the recompute
    blocks = {k: v for k, v in attrs.items() if isinstance(v, Block)}
    if blocks:
        fw_attrs = dict(fw_attrs, **blocks)
    fw_out_slots = attrs["fw_out_slots"]    # [(slot, arity), ...]
    needs = attrs["needs_input_grad"]       # [(slot, idx), ...]
    has_ograd = attrs["has_out_grad"]       # [(slot, idx), ...] with grads fed

    fw_ins = {slot: list(ins.get(slot, [])) for slot, _ in
              attrs["fw_in_slots"]}
    # detached leaves: the Executor runs under no_grad, and a forward
    # input may be the output of an earlier op's graph
    primals = [fw_ins[slot][idx].detach().requires_grad_()
               for slot, idx in needs]
    for (slot, idx), p in zip(needs, primals):
        fw_ins[slot][idx] = p
    with torch.enable_grad():
        outs = get_kernel(fw_type, fw_attrs)(fw_ins, fw_attrs)

    # Out-grads for slot s are packed into input slot "s@GRAD_OUT" in the
    # order their (slot, idx) entries appear in has_out_grad.  Outputs
    # with no incoming grad contribute a zero cotangent, which is the
    # same as leaving them out of the product; so do outputs that do not
    # depend on the primals (integer outputs, a dropout Mask, XShape).
    arity = dict(fw_out_slots)
    seen = {}
    ys, cots = [], []
    for slot, idx in has_ograd:
        k = seen.get(slot, 0)
        seen[slot] = k + 1
        vs = outs.get(slot, [])
        y = vs[idx] if idx < min(len(vs), arity.get(slot, 0)) else None
        if y is None or not y.requires_grad:
            continue
        g = ins[f"{slot}@GRAD_OUT"][k]
        ys.append(y)
        cots.append(g.to(y.dtype) if g.dtype != y.dtype else g)
    grads = torch.autograd.grad(ys, primals, cots, allow_unused=True) \
        if ys else [None] * len(primals)

    res = {}
    for (slot, _), p, g in zip(needs, primals, grads):
        res.setdefault(f"{slot}@GRAD", []).append(
            torch.zeros_like(p.detach()) if g is None else g)
    return res


def run_op(op_type, ins, attrs):
    """Run one op's kernel (the Executor's interpreter loop calls this).

    ``generic_grad`` recomputes the forward under torch autograd;
    ``<fw>_grad`` dispatches to the custom grad kernel registered with
    :func:`register_grad` (emitted by backward.append_backward when one
    exists).  Custom grad kernels receive the same ins/attrs contract as
    the generic kernel (fw inputs + ``<slot>@GRAD_OUT`` out-grads)."""
    if op_type == "generic_grad":
        return generic_grad_kernel(ins, attrs)
    if op_type.endswith("_grad") and op_type[:-5] in _CUSTOM_GRADS:
        return _CUSTOM_GRADS[op_type[:-5]](ins, attrs)
    return get_kernel(op_type, attrs)(ins, attrs)


_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}


def torch_dtype(name):
    """IR dtype -> torch dtype.  Unlike the JAX package (whose 64-bit IR
    dtypes run as 32-bit unless FLAGS_enable_64bit), the port keeps every
    IR dtype as declared: the card has an int64 path."""
    name = str(name)
    if name not in _TORCH_DTYPES:
        raise TypeError(f"IR dtype {name!r} has no torch counterpart")
    return _TORCH_DTYPES[name]


def np_dtype(name):
    """IR dtype -> host numpy dtype of a feed (bfloat16 feeds stage as
    float32 on the host and are cast on the device)."""
    name = str(name)
    return np.dtype(np.float32) if name == "bfloat16" else np.dtype(name)


def cast_feed(value, ir_dtype, device):
    """Host (or torch) feed value -> tensor of the IR dtype on `device`."""
    dt = torch_dtype(ir_dtype)
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dt)
    arr = np.asarray(value)
    if arr.dtype != np_dtype(ir_dtype):
        arr = arr.astype(np_dtype(ir_dtype))
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device,
                                                         dtype=dt)
