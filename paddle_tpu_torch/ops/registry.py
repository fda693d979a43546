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
"""

import contextlib
import threading

import numpy as np
import torch

_KERNELS = {}


class ExecContext:
    """State of the run in progress on this thread."""

    def __init__(self, device=None, generator=None, seed=0, step=0,
                 is_test=False):
        self.device = device if device is not None else torch.device("cpu")
        self.generator = generator
        self.seed = seed            # program.random_seed
        self.step = step            # executor step counter
        self.is_test = is_test


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


def generator_for(attrs):
    """The run's generator, reseeded for this op (so a draw depends only
    on the op and the step, not on the order other ops drew in)."""
    ctx = current()
    gen = ctx.generator
    if gen is None or gen.device != ctx.device:
        gen = ctx.generator = torch.Generator(device=ctx.device)
    gen.manual_seed(op_seed(attrs))
    return gen


def register(op_type):
    def deco(fn):
        _KERNELS[op_type] = fn
        return fn
    return deco


def get_kernel(op_type):
    if op_type not in _KERNELS:
        raise NotImplementedError(
            f"No kernel registered for op {op_type!r} in the PyTorch port. "
            f"Known: {sorted(_KERNELS)}")
    return _KERNELS[op_type]


def first(ins, slot):
    vs = ins.get(slot) or []
    return vs[0] if vs else None


def as_out(x):
    return {"Out": [x]}


def run_op(op_type, ins, attrs):
    """Run one op's kernel (the Executor's interpreter loop calls this)."""
    if op_type == "generic_grad" or op_type.endswith("_grad"):
        raise NotImplementedError(
            f"op {op_type!r}: backward ops run in the training slice of "
            "the port, which has not landed yet")
    return get_kernel(op_type)(ins, attrs)


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
