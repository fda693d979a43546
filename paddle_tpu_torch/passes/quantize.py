"""Quantized inference as a pass: per-channel int8 weights + dynamic
activation scales.

A copy of ``paddle_tpu/passes/quantize.py`` with four changes: no
platform probe (``FLAGS_quant_dtype`` is "int8"; "fp8" raises, it is not
ported), :func:`apply_to_scope` writes torch tensors on the device the
fp32 weight lived on (the Executor refuses a scope tensor on another
device), a rank-2 int8 weight is stored K-major (the [K, N] view of a
zero-padded [N, Kp] buffer, ``ops/quant_kernels.k_major``: the values are
the reference's, the layout is the one K6's ``wgmma`` reads, so no call
transposes it), and the metrics ride the port's observability registry.

* :func:`quantize_weights` marks matmul-class ops (``mul`` /
  ``matmul``) whose weight operand is a read-only persistable fp32
  parameter with a ``__quant__`` attr, wires a per-channel scale var
  (``<w>@QSCALE``, fp32 ``[out_channels]``) into a new ``Scale`` input
  slot, and flips the weight declaration to int8.  It shares one
  region-propagation traversal with amp (:mod:`passes.regions`).
* scale VALUES are computed ONCE, at Predictor load
  (:func:`apply_to_scope`) — never on the hot path.  Activations get
  dynamic per-tensor scales per call (``ops/quant_kernels.py``).
* dispatch: ``ops/registry.get_kernel`` turns an annotated op into
  ``ops/quant_kernels.make_quant_kernel``, whose int8 product is the
  hand-written kernel K6 on the card.

Training programs are never quantized: a weight with ANY writer
(optimizer update) is excluded, as is a weight any non-quantizable op
reads (the int8 array would leak into fp32 math).
"""

import threading

import numpy as np
import torch

from .base import clone_for_rewrite, program_pass
from .regions import walk_dataflow

QUANT_ATTR = "__quant__"
SCALE_SLOT = "Scale"
SCALE_SUFFIX = "@QSCALE"

# Ops whose weight operand quantizes: the matmul class the serving zoo
# actually runs through fc layers.  matmul with transpose_Y (or a
# rank != 2 weight) keeps full precision — the per-channel axis would
# not be the contraction-free one.
QUANT_OPS = frozenset({"mul", "matmul"})


def resolved_quant_dtype():
    """The weight dtype to quantize to: ``FLAGS_quant_dtype``, "int8"
    (the default and the only one ported).  The JAX package's "fp8" arm
    is a dequant-then-dot with no kernel of its own
    (``paddle_tpu/ops/quant_kernels.py:148-153``); it waits for ROADMAP
    queue 1 item 9."""
    from ..flags import get_flag

    want = str(get_flag("quant_dtype") or "int8")
    if want != "int8":
        raise NotImplementedError(
            f"FLAGS_quant_dtype={want!r}: only int8 weights are ported "
            f"(fp8 is ROADMAP queue 1 item 9)")
    return "int8"


# ---------------------------------------------------------------------------
# Planning (pure)
# ---------------------------------------------------------------------------

def _written_names(program):
    out = set()
    for blk in program.blocks:
        for op in blk.ops:
            out.update(op.output_arg_names)
    return out


def _find_var(program, name):
    for blk in program.blocks:
        if name in blk.vars:
            return blk.vars[name]
    return None


def _weight_cols(op, shape):
    """Static per-channel (output-column) count of the 2D view the mul/
    matmul kernel contracts over; None = not quantizable here."""
    dims = [int(d) for d in (shape or [])]
    if not dims or any(d <= 0 for d in dims):
        return None
    if op.type == "mul":
        ync = int(op.attrs.get("y_num_col_dims", 1))
        if not 0 < ync < len(dims) + 1:
            return None
        c = 1
        for d in dims[ync:]:
            c *= d
        return c
    # matmul: rank-2, non-transposed weight only
    if len(dims) != 2 or op.attrs.get("transpose_Y", False):
        return None
    return dims[-1]


def plan_quantize(program, ctx=None):
    """{(block_idx, op_idx): spec} of ops to annotate — pure planning.

    spec: {"w": name, "w_slot": "Y", "scale": name, "cols": C,
    "bits": 8, "dtype": "int8"}.  A weight is planned only when EVERY
    reader is a planned op (a second, non-matmul consumer would read
    the raw int8 array), nothing writes it (training state), and no
    string attr references it (control-flow kernels wire sub-block
    vars by name, invisible to dataflow — the DCE/CSE protected-name
    lesson); sub-block sites themselves never plan (their wrapper
    op's reads are invisible to the census below)."""
    from .base import attr_referenced_names

    written = _written_names(program)
    protected = set(ctx.fetch_names) if ctx is not None else set()
    protected |= attr_referenced_names(program)
    global_idx = program.global_block().idx
    dtype = resolved_quant_dtype()
    candidates = {}                  # (blk, idx) -> (w name, spec)
    readers = {}                     # w name -> [(blk, idx)]

    def visit(site):
        op = site.op
        for n in site.ins:
            readers.setdefault(n, []).append((site.block.idx, site.idx))
        if site.grad or site.skippable or op.type not in QUANT_OPS:
            return
        if site.block.idx != global_idx:
            return                   # sub-block sites never plan
        if op.attrs.get(QUANT_ATTR) is not None:
            return                   # already annotated (idempotence)
        ys = op.input("Y")
        if len(ys) != 1:
            return
        w = ys[0]
        v = _find_var(program, w)
        if v is None or not getattr(v, "persistable", False):
            return
        if str(v.dtype) != "float32" or w in written or w in protected:
            return
        cols = _weight_cols(op, v.shape)
        if cols is None:
            return
        candidates[(site.block.idx, site.idx)] = (w, {
            "w": w, "w_slot": "Y", "scale": w + SCALE_SUFFIX,
            "cols": cols, "bits": 8, "dtype": dtype})

    walk_dataflow(program, visit)
    planned_sites = {w: set() for w, _ in candidates.values()}
    for site, (w, _) in candidates.items():
        planned_sites[w].add(site)
    plans = {}
    for site, (w, spec) in candidates.items():
        if set(readers.get(w, [])) != planned_sites[w]:
            continue                 # a non-quantizable op reads w
        plans[site] = spec
    return plans


@program_pass("quantize_weights")
def quantize_weights(program, ctx):
    """Annotate quantizable matmul-class ops and rewrite the weight /
    scale declarations.  Identity unless ``program._quant`` is set
    (``AnalysisConfig.enable_quantize()``), and idempotent."""
    if not getattr(program, "_quant", False):
        return program
    plans = plan_quantize(program, ctx)
    if not plans:
        return program
    p = clone_for_rewrite(program)
    from ..core.framework import Variable

    for (b, i), spec in plans.items():
        op = p.blocks[b].ops[i]
        op.attrs[QUANT_ATTR] = dict(spec)
        op.inputs[SCALE_SLOT] = [spec["scale"]]
    gb = p.global_block()
    for spec in plans.values():
        w = spec["w"]
        for blk in p.blocks:
            if w in blk.vars:
                blk.vars[w].dtype = spec["dtype"]
                break
        sname = spec["scale"]
        if sname not in gb.vars:
            sv = Variable(gb, name=sname, shape=(spec["cols"],),
                          dtype="float32", persistable=True,
                          stop_gradient=True)
            gb.vars[sname] = sv
    return p


# ---------------------------------------------------------------------------
# Load/swap-time weight conversion (the only place scales are computed)
# ---------------------------------------------------------------------------

def quant_plan(program):
    """{weight name: spec} off a QUANTIZED program's annotations —
    what :func:`apply_to_scope` / :func:`quantize_values` convert."""
    out = {}
    for blk in program.blocks:
        for op in blk.ops:
            spec = op.attrs.get(QUANT_ATTR)
            if isinstance(spec, dict):
                out[spec["w"]] = spec
    return out


def _to_2d(w, op_spec):
    """The kernel's 2D view of the weight: columns are the per-channel
    axis."""
    c = int(op_spec["cols"])
    return np.asarray(w).reshape(-1, c)


def quantize_array(w, spec):
    """fp32 weight -> (quantized array, fp32 per-channel scale).
    Symmetric per-output-channel: ``scale[c] = amax(col c) / qmax``,
    ``wq = round(w / scale)`` (int8).  The same numpy arithmetic as the
    JAX package's, so both give equal codes and scales.  Shapes are
    preserved; the scale is ``[cols]``."""
    if spec["dtype"] != "int8":
        raise NotImplementedError(
            f"quantize: {spec['dtype']!r} weights are not ported "
            f"(ROADMAP queue 1 item 9)")
    w = np.asarray(w, np.float32)
    w2 = _to_2d(w, spec)
    qmax = float((1 << (int(spec["bits"]) - 1)) - 1)
    amax = np.max(np.abs(w2), axis=0)
    scale = np.maximum(amax / qmax, 1e-12).astype(np.float32)
    wq = np.clip(np.round(w2 / scale), -qmax, qmax).astype(np.int8)
    return wq.reshape(w.shape), scale


def _needs_requantize(arr):
    """Whether an incoming state value (numpy array or torch tensor) is
    a FULL-PRECISION float that must convert before landing in
    quantized state.  Already-quantized values (int8, e.g. state
    round-tripped through a checkpoint of a quantized predictor) pass
    through untouched; integer state never quantizes."""
    if isinstance(arr, torch.Tensor):
        return arr.dtype.is_floating_point
    dt = str(arr.dtype)
    if dt == "int8":
        return False
    return arr.dtype.kind == "f" or dt in ("bfloat16", "float16")


def quantize_values(program, values):
    """Quantize-at-swap: rewrite an incoming full-precision state dict
    (numpy values) so that every annotated weight arrives quantized WITH
    its recomputed scale.  Names the plan doesn't cover pass through
    untouched.  (The JAX package's warm reload calls this between
    batches; the port's engine has no warm reload yet.)"""
    plan = quant_plan(program)
    if not plan:
        return values
    out = dict(values)
    n = 0
    for w, spec in plan.items():
        v = out.get(w)
        if v is None or not _needs_requantize(np.asarray(v)):
            continue                 # already quantized / not swapped
        wq, scale = quantize_array(v, spec)
        out[w] = wq
        out[spec["scale"]] = scale
        METRICS.note_table(w, np.asarray(v).nbytes,
                           wq.nbytes + scale.nbytes, scale)
        n += 1
    if n:
        METRICS.inc("swap_requantized", n)
    return out


def apply_to_scope(program, scope):
    """ONE-TIME load-seam conversion: for every ``__quant__`` op, read
    the fp32 weight from `scope`, write the int8 weight back under the
    same name and the fp32 per-channel scale under ``<w>@QSCALE``, both
    as torch tensors on the device the fp32 weight lived on (the
    executor's), a rank-2 weight K-major (``quant_kernels.k_major``).
    Idempotent (a weight already int8 is skipped; one that arrived int8
    in row-major order, from a saved quantized scope, is laid out K-major
    once and not counted).  Returns the number of tables converted."""
    from ..ops.quant_kernels import is_k_major, k_major
    from ..profiler import record_event

    plan = quant_plan(program)
    if not plan:
        return 0
    n = 0
    with record_event("quant/quantize"):
        for w, spec in plan.items():
            v = scope.find_var(w)
            if v is None:
                raise KeyError(
                    f"quantize: weight {w!r} not found in scope — "
                    f"load the fp32 parameters before apply_to_scope")
            if not _needs_requantize(v):
                # already converted; a row-major int8 weight is laid out
                # K-major once
                if isinstance(v, torch.Tensor) and v.dim() == 2 \
                        and v.dtype == torch.int8 and not is_k_major(v):
                    scope.set_var(w, k_major(v))
                continue
            if isinstance(v, torch.Tensor):
                device, arr = v.device, v.detach().float().cpu().numpy()
            else:
                device, arr = torch.device("cpu"), np.asarray(v)
            wq, scale = quantize_array(arr, spec)
            wt = torch.from_numpy(wq).to(device)
            if wt.dim() == 2:
                wt = k_major(wt)
            scope.set_var(w, wt)
            scope.set_var(spec["scale"], torch.from_numpy(scale).to(device))
            # the bytes the device holds: the K-major buffer, pad included
            METRICS.note_table(w, arr.nbytes, wt.untyped_storage().nbytes()
                               + scale.nbytes, scale)
            n += 1
    if n:
        METRICS.inc("tables_quantized", n)
    return n


# ---------------------------------------------------------------------------
# Observability: the "quant" registry silo
# ---------------------------------------------------------------------------

class _QuantMetrics:
    """Process-global quantization counters: bytes saved by weight
    conversion and per-table scale ranges, riding
    ``observability.REGISTRY.snapshot()`` under ``"quant"``.  (The JAX
    package also counts its measured kernel selections; the port has no
    selection: K6 always runs on the card.)"""

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {"tables_quantized": 0, "swap_requantized": 0,
                   "bytes_fp32": 0, "bytes_quant": 0, "bytes_saved": 0}
        self._scales = {}            # table -> [min, max]

    def inc(self, name, n=1):
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n

    def note_table(self, name, fp32_bytes, quant_bytes, scale):
        with self._lock:
            self._c["bytes_fp32"] += int(fp32_bytes)
            self._c["bytes_quant"] += int(quant_bytes)
            self._c["bytes_saved"] += int(fp32_bytes) - int(quant_bytes)
            self._scales[name] = [float(np.min(scale)),
                                  float(np.max(scale))]

    def snapshot(self):
        with self._lock:
            return {"counters": dict(self._c),
                    "scale_ranges": {n: list(v)
                                     for n, v in self._scales.items()}}


METRICS = _QuantMetrics()

from ..observability import REGISTRY as _REGISTRY  # noqa: E402

_REGISTRY.register("quant", METRICS.snapshot)
