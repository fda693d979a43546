"""Executor: run a Program block over torch tensors, op by op or as a
captured CUDA graph.

The port of ``paddle_tpu/core/executor.py``.  Its interpreter is the
reference framework's own shape (``Executor::Run``, ``executor.cc:185``):
a loop that calls one registered kernel per op (``ops/registry.py``) on
tensors that live on the executor's device.  Persistable state the block
writes (an optimizer's ``ParamOut`` under the parameter's own name) is
stored back into the Scope after the run, so the next run reads it.
Kernels never update a tensor in place, because a grad op reads forward
inputs from the run's environment after later ops have run.

The compiled step: where the reference traces a (program, feeds,
fetches) into one jitted executable (``_CompiledBlock``, cached by
``_ProgramCache`` under ``FLAGS_executor_cache_capacity``), ``run`` on a
CUDA place runs it on the segmented runner below, whose device segments
are each captured as one CUDA graph per signature; a program with no op
that ends a segment (:func:`capturable`) is one segment, captured whole.
Every program on the CPU is interpreted.  The first run of a signature
is an ordinary op-by-op run (the warmup of cuBLAS, cuDNN and the
kernels' build), the second captures it and replays it, and later runs
replay.  A replay copies its inputs into the graph's static buffers (the
executor's device step word, the random ops' key: ``registry.
DeviceSeed``, is written once a run), replays, and hands on the graph's
outputs; the fetches are copies.  A graph ends by copying each
persistable it wrote into the Scope's own tensor (the reference's
donation plays that role), so the Scope's tensors keep their identity
from the capture on; a Scope tensor swapped in between runs is copied
into the static buffer before the replay (a new shape or dtype
recaptures).  ``compile_count`` counts captured signatures and
``precompile`` captures one of a whole program without running a step.

Control flow: a ``dynamic_rnn`` op runs its step block once per time
step through :func:`_run_block` (``ops/rnn_ops.py``), and a ``gpipe`` op
its stage block once per stage and tick (``ops/pipeline_ops.py``).  Both
loop a number of times fixed by static shapes and attributes (the feed's
padded length, the stage and micro-batch counts) and read nothing on the
host, so a capture holds them, as the reference's jit does.  A ``while``
op runs its sub-block on the host for as long as its condition holds, and
a ``conditional_block`` op runs its sub-block once if its condition holds
(:func:`_run_while`, :func:`_run_conditional`: the reference's
``_run_while`` and ``_run_conditional``, whose ``lax.while_loop`` and
``lax.cond`` become a host loop and a host branch).  Reading the
condition is the one synchronisation with the card an iteration; the
body's ops, the tensor arrays' indices among them, stay on the device.
Both end a segment (:func:`segment_breakers`).

The mixed host/device runner (:class:`_SegmentedProgram`, the port of
the reference's ``_run_eager``): :func:`_host_program_segments` cuts a
block into maximal runs of device ops between the ops that end a segment
(host ops, ``while``, ``conditional_block``, and the ops a graph cannot
replay); each run is a :class:`_SegmentRunner`, captured per signature of
its inputs.  Host ops run between the segments on values the segments
copied to pinned host memory as they ended, and a loop's body is cut and
captured the same way, its graphs replayed every iteration.

Seams: ``run`` passes every program through the verifier and then,
unless it holds host ops, the IR pass pipeline before it interprets it,
as the reference does (``passes/``: ``amp_propagate`` there decides each
op's precision in a program under ``contrib.mixed_precision``, whose
casts ``registry.get_kernel`` applies when the run's context has
``amp`` set).

Feeds: a run with no feed on a program that declares ``py_reader``s
takes each reader's next batch, staged on the executor's device
(``pyreader.py``), and raises ``EOFException`` at the end of an epoch.

Host ops: the sharded embedding engine's ``sharded_lookup_table`` and
``sharded_push_grad`` (``sparse/``) run on the host inside the same loop;
``close()`` flushes their in-flight pushes.  The reference's
prefetch-ahead (``feed_next``) is not ported yet.

Entry points run on the card unless the caller asks for the CPU:
``Executor()`` means ``CUDAPlace(0)``, and with no CUDA device it raises
instead of carrying on on the CPU.  Pass ``CPUPlace()`` to run on the CPU.
"""

import contextlib
import gc
import threading
import time
import weakref

import numpy as np
import torch

from .framework import (Block, CPUPlace, CUDAPlace, Variable,
                        default_main_program)
from .. import ops as _ops  # noqa: F401  (importing registers the kernels)
from ..ops import registry


class Scope:
    """name -> tensor map (scope.h:48 analogue, flat for now)."""

    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent
        self.kids = []

    def var(self, name):
        if name not in self.vars:
            self.vars[name] = None
        return self.vars[name]

    def find_var(self, name):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None

    def set_var(self, name, value):
        self.vars[name] = value

    def new_scope(self):
        k = Scope(self)
        self.kids.append(k)
        return k

    def drop_kids(self):
        self.kids = []

    def local_var_names(self):
        return list(self.vars)


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope():
    return _scope_stack[-1]


class scope_guard:
    def __init__(self, scope):
        self.scope = scope

    def __enter__(self):
        _scope_stack.append(self.scope)

    def __exit__(self, *a):
        _scope_stack.pop()


def device_of(place):
    """torch.device of a Place.  A CUDAPlace with no CUDA device raises:
    the port never moves a run to the CPU behind the caller's back."""
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    if isinstance(place, CUDAPlace):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{place!r} was requested but PyTorch sees no CUDA device; "
                "pass fluid.CPUPlace() (or AnalysisConfig.disable_gpu()) "
                "to run on the CPU")
        if place.device_id >= torch.cuda.device_count():
            raise RuntimeError(
                f"{place!r} was requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
        return torch.device("cuda", place.device_id)
    raise TypeError(f"unknown place {place!r}: use CPUPlace() or "
                    "CUDAPlace(i)")


def _as_fetch_name(f):
    return f.name if isinstance(f, Variable) else f


def _normalize_feed(program, feed):
    """Expand ragged feed values for lod_level>0 vars into the dense +
    lengths pair (value under the var name, lengths under name@SEQ_LEN).
    Accepts LoDTensor, (array, lengths), list-of-arrays, or dense array."""
    from . import lod as lod_mod

    block = program.global_block()
    out = {}
    for name, val in feed.items():
        v = block.vars.get(name)
        if v is not None and getattr(v, "lod_level", 0) >= 2:
            level = v.lod_level
            if isinstance(val, lod_mod.LoDTensor) and \
                    len(val.recursive_sequence_lengths()) == level:
                val = lod_mod.lod_tensor_to_nested(val)
            if lod_mod.nesting_depth(val) != level:
                raise ValueError(
                    f"lod_level={level} var {name!r} must be fed as a "
                    f"{level}-deep nested list (lists nest one per LoD "
                    "level; leaves are per-sequence arrays) or a "
                    f"LoDTensor carrying {level} levels of "
                    "recursive_sequence_lengths")
            padded, lens = lod_mod.to_padded_n(val, level)
            out[name] = padded
            for k, lk in enumerate(lens, 1):
                out.setdefault(lod_mod.seq_lenk_name(name, k), lk)
        elif v is not None and getattr(v, "lod_level", 0) > 0:
            sl_name = lod_mod.seq_len_name(name)
            padded, lens = lod_mod.to_padded(val)
            out[name] = padded
            if sl_name not in feed:
                out[sl_name] = lens
        else:
            out[name] = np.asarray(val) if isinstance(
                val, lod_mod.LoDTensor) else val
    return out


_SUB_BLOCK_OPS = ("while", "conditional_block")
SELF_CONTAINED_BLOCK_OPS = {"dynamic_rnn", "gpipe"}


def _recurse_into_blocks(op):
    """Whether dataflow analysis should descend into this op's Block attrs
    (grad ops carry the fw op's block but bind all reads as inputs too)."""
    return op.type not in SELF_CONTAINED_BLOCK_OPS and \
        not op.type.endswith("_grad") and op.type != "generic_grad"


def _block_io(block):
    """All var names read / written by a block, recursing into sub-blocks
    (the reference's ``_block_io``; ``append_backward`` uses it to refuse
    backward through a while loop)."""
    reads, writes = set(), set()
    for op in block.ops:
        reads.update(op.input_arg_names)
        writes.update(op.output_arg_names)
        if not _recurse_into_blocks(op):
            continue
        for v in op.attrs.values():
            if isinstance(v, Block):
                r, w = _block_io(v)
                reads |= r
                writes |= w
    return reads, writes


def read_names(block, fetch_names=()):
    """Every name an op of `block`, or of a block it holds, reads, plus
    `fetch_names`: a kernel leaves out an optional output that is not
    among them (``registry.output_read``; the dropout op's Mask).  A
    ``generic_grad`` op's ``@FW_OUT`` inputs do not count: it recomputes
    its forward and never reads them."""
    reads = set(fetch_names)
    stack = [block]
    while stack:
        for op in stack.pop().ops:
            for slot, names in op.inputs.items():
                if not (op.type == "generic_grad"
                        and slot.endswith("@FW_OUT")):
                    reads.update(names)
            stack.extend(v for v in op.attrs.values()
                         if isinstance(v, Block))
    return reads


def _run_block(block, env, read):
    """Run a block's ops in order (:func:`_run_ops`)."""
    _run_ops(block.ops, env, read)


def _run_ops(ops, env, read):
    """Run `ops` in order.  `env` maps names to tensors; `read(n)`
    supplies a name the block reads before writing it (from the Scope).

    Host ops (``distributed/host_ops.py``: the sharded embedding engine's
    lookup and push) run here too, as the reference's eager interpreter
    runs them (``_run_eager``).  A lookup is ISSUED at its op — host dedup
    and the per-shard RPCs start — and COLLECTED just before the first op
    that reads its rows, so the device work dispatched in between overlaps
    the wire time."""
    from ..distributed import host_ops

    pending = {}                     # lookup output name -> collect()
    ctx = registry.current()
    for op in ops:
        if op.type in ("feed", "fetch"):
            continue
        if op.type == "while":
            _run_while(op, env, read)
            continue
        if op.type == "conditional_block":
            _run_conditional(op, env, read)
            continue
        try:
            for n in op.input_arg_names:
                collect = pending.pop(n, None)
                if collect is not None:
                    collect()
            if host_ops.is_host_op(op.type):
                for n in op.input_arg_names:
                    if n not in env:
                        read(n)
                if op.type in host_ops.LOOKUP_HOST_OPS:
                    collect = host_ops.issue_lookup_op(
                        op, env, op.attrs, op.attrs.get("trainer_id", 0))
                    pending.update((n, collect)
                                   for n in op.output_arg_names)
                else:
                    host_ops.run_host_op(op, env)
                continue
            ins = {slot: [env[n] if n in env else _absent(op, slot, n, read)
                          for n in names]
                   for slot, names in op.inputs.items()}
            ctx.op = op
            outs = registry.run_op(op.type, ins, op.attrs)
        except Exception as e:
            # PADDLE_ENFORCE-style context (enforce.h): name the op and
            # its Program variables
            in_names = {s: list(n) for s, n in op.inputs.items()}
            out_names = {s: list(n) for s, n in op.outputs.items()}
            e.add_note(f"while running op {op.type!r} "
                       f"(inputs {in_names}, outputs {out_names})")
            raise
        for slot, names in op.outputs.items():
            for n, v in zip(names, outs.get(slot, [])):
                if v is not None:
                    env[n] = v
        # eager deletion (passes/memory.py): the pass proved these vars
        # dead once this op has run, so drop the references now and the
        # allocator can reuse their memory for the ops that follow
        for n in op.attrs.get("__dead_after__", ()):
            env.pop(n, None)
    for collect in dict.fromkeys(pending.values()):
        collect()                    # rows nobody read: land, surface errors


# the while loops the interpreter ran in this process: loops, body
# iterations and condition reads (each a synchronisation with the card
# when the condition lies there); a caller sets them to 0 and reads them
loop_counts = {"loops": 0, "iterations": 0, "condition_reads": 0}


def _upward_reads(block, written=()):
    """Names `block`, or a block it holds, reads before writing them or
    finding them in `written` (what a run of the block takes from the
    Scope)."""
    written, out = set(written), set()
    for op in block.ops:
        out.update(n for n in op.input_arg_names if n not in written)
        if _recurse_into_blocks(op):
            for v in op.attrs.values():
                if isinstance(v, Block):
                    out |= _upward_reads(v, written)
        written.update(op.output_arg_names)
    return out


def _carried(sub, env, read, extra=()):
    """The names a sub-block op carries: those the sub-block reads or
    writes that exist before the op (the reference's ``carry_names``).  A
    name the body reads before writing it and writes too is taken from the
    Scope first, so its new value is carried out; a name first created
    inside the body is not, and does not leak into `env`."""
    reads, writes = _block_io(sub)
    for n in sorted((_upward_reads(sub) & writes) | set(extra)):
        if n not in env:
            env[n] = read(n)
    return sorted(n for n in reads | writes | set(extra) if n in env)


def _holds(cond):
    """A condition tensor's value on the host: waits for the card when
    the condition lies there."""
    loop_counts["condition_reads"] += 1
    return bool(cond.reshape(()))


def _run_while(op, env, read, run_body=None):
    """A ``while`` op (``controlflow/while_op.cc:50``): run the sub-block
    while ``Condition`` holds, on the carried names only, then write them
    back into `env` (the reference's ``_run_while``, with a host loop
    where it has ``lax.while_loop``).  Each iteration runs on a fresh
    copy of `env` updated with the carry, as the reference's body does.
    `run_body(sub_block, local_env)` runs one iteration (default: op by
    op; the segmented runner passes its captured segments)."""
    sub = op.attrs["sub_block"]
    run_body = run_body or (lambda blk, local: _run_block(blk, local, read))
    cond_name = op.inputs["Condition"][0]
    names = _carried(sub, env, read, (cond_name,))
    carry = {n: env[n] for n in names}
    loop_counts["loops"] += 1
    while _holds(carry[cond_name]):
        local = dict(env)
        local.update(carry)
        run_body(sub, local)
        carry = {n: local[n] for n in names}
        loop_counts["iterations"] += 1
    env.update(carry)


def _run_conditional(op, env, read, run_body=None):
    """A ``conditional_block`` op: run the sub-block iff ``Cond`` holds,
    and write back only the carried names (the reference's
    ``_run_conditional``; a name the block writes must exist before it,
    its old value being the false branch).  `run_body` as for
    :func:`_run_while`."""
    sub = op.attrs["sub_block"]
    run_body = run_body or (lambda blk, local: _run_block(blk, local, read))
    cond_name = op.inputs["Cond"][0]
    names = _carried(sub, env, read)
    cond = env[cond_name] if cond_name in env else read(cond_name)
    if _holds(cond):
        local = dict(env)
        run_body(sub, local)
        env.update((n, local[n]) for n in names)


def _absent(op, slot, name, read):
    """A name the run has not written: from the Scope, or None for a
    ``generic_grad`` op's forward output that was left out because
    nothing reads it (see :func:`read_names`)."""
    if op.type == "generic_grad" and slot.endswith("@FW_OUT"):
        return None
    return read(name)


def _scope_read(scope, n, device):
    """Scope value of a name the program reads, with the interpreter's
    errors for a missing one and one on another device."""
    val = scope.find_var(n)
    if val is None:
        raise RuntimeError(
            f"Variable {n!r} is read by the program but has no value in "
            "scope — did you run the startup program?")
    if isinstance(val, torch.Tensor) and val.device != device:
        raise RuntimeError(
            f"Variable {n!r} lives on {val.device}, this executor runs on "
            f"{device}")
    return val


def _written_state(block, env):
    """The persistables (not data) a run wrote: name -> value."""
    return {n: v for n, v in env.items()
            if block.has_var(n) and block.var(n).persistable
            and not block.var(n).is_data}


def _swap_state(scope, new):
    for n, v in new.items():
        scope.set_var(n, v)


def _interpret(program, feed, fetch_names, scope, device, step, reads,
               generator=None, mesh=None, write=_swap_state):
    """One op-by-op run of `program` on normalized feeds at `step`:
    returns the fetches, and hands the persistables it wrote to
    `write(scope, {name: tensor})` (None: the run writes no state)."""
    block = program.global_block()
    env = {}
    for n, val in feed.items():
        dtype = block.var(n).dtype if block.has_var(n) else \
            str(np.asarray(val).dtype)
        env[n] = registry.cast_feed(val, dtype, device)

    def read(n):
        env[n] = val = _scope_read(scope, n, device)
        return val

    ctx = registry.ExecContext(
        device=device, generator=generator, seed=program.random_seed,
        step=step, is_test=program._is_test or registry.in_test_mode(),
        masks={}, reads=reads, mesh=mesh,
        amp=getattr(program, "_amp", False))
    with torch.no_grad(), registry.exec_context(ctx):
        _run_block(block, env, read)
        fetches = [env[n] if n in env else read(n) for n in fetch_names]
    if write is not None:
        write(scope, _written_state(block, env))
    return fetches


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# Capture: what the graphs of one executor share, and one capture
# ---------------------------------------------------------------------------

# one capture at a time in the process: a capture's entry synchronizes
# the device and frees cached memory, which another thread's capture in
# flight forbids (two serving replicas, each with its executor)
_CAPTURE_LOCK = threading.Lock()

# flags a kernel reads as it runs: a graph replays the setting it was
# captured under, so they are part of a signature, as are the matmul and
# convolution settings torch.backends holds
_KERNEL_FLAGS = ("use_fused_dropout", "ring_flash")


def _breaker(op):
    """Why `op` ends a device segment, or None: the reference's breakers
    (a host op of the sharded embedding engine, which talks RPC on the
    host; ``while`` and ``conditional_block``, whose condition is read on
    the host) and three of the port's own, which a CUDA graph would not
    replay as the interpreter runs them: an op drawn through a reseeded
    torch generator (``registry.generator_for``: its seed is host state),
    one that reads its inputs' values on the host (``registry.
    reads_on_host``: ``chunk_eval``, ``tree_conv``, ``hash``,
    ``similarity_focus``, ``range``), and a sparse lookup or its grad
    (``is_sparse``: merging a SelectedRows grad reads its rows on the
    host).  A grad op answers for its forward op's type, and a
    ``dynamic_rnn`` or ``gpipe`` op for the ops of the block it runs."""
    from ..distributed.host_ops import is_host_op

    kinds = [op.type]
    fw_attrs = op.attrs.get("fw_attrs")
    fw_attrs = fw_attrs if isinstance(fw_attrs, dict) else {}
    if op.type == "generic_grad":
        kinds.append(op.attrs.get("fw_type"))
    elif op.type.endswith("_grad"):
        kinds.append(op.type[:-5])
    for t in kinds:
        if is_host_op(t):
            return f"{op.type}: a host op"
        if t in _SUB_BLOCK_OPS:
            return f"{op.type}: reads its condition on the host"
        if registry.draws_from_generator(t):
            return f"{op.type}: draws through a reseeded torch generator"
        if registry.reads_on_host(t):
            return f"{op.type}: reads its inputs on the host"
    if op.attrs.get("is_sparse") or fw_attrs.get("is_sparse"):
        return f"{op.type}: a sparse (is_sparse) lookup"
    if op.type in SELF_CONTAINED_BLOCK_OPS or fw_attrs:
        for v in list(op.attrs.values()) + list(fw_attrs.values()):
            if isinstance(v, Block):
                for inner in v.ops:
                    why = _breaker(inner)
                    if why is not None:
                        return f"{op.type} runs {why}"
    return None


def segment_breakers(block):
    """The types of the ops of `block` at which a device segment ends
    (:func:`_breaker`), sorted.  The reference ends a segment at its host
    ops, ``while`` and ``conditional_block`` only (its jit traces random
    and host-read ops like any other); the port adds the ops a CUDA graph
    cannot replay, each run of which becomes a segment that always runs
    op by op."""
    return sorted({op.type for op in block.ops
                   if op.type not in ("feed", "fetch")
                   and _breaker(op) is not None})


def _baked():
    """What a capture bakes in besides its inputs: test mode, the kernel
    flags, ``torch.backends``' matmul and convolution settings and
    whether torch runs its deterministic algorithms (a scatter-add then
    sums duplicates in order, not by atomics)."""
    from ..flags import get_flag

    be = torch.backends
    return (registry.in_test_mode(),
            tuple(get_flag(f) for f in _KERNEL_FLAGS),
            (be.cuda.matmul.allow_tf32, be.cudnn.allow_tf32,
             be.cudnn.benchmark, be.cudnn.deterministic,
             torch.get_float32_matmul_precision(),
             torch.are_deterministic_algorithms_enabled()))


def capturable(program):
    """Whether ``Executor.run`` captures `program` whole on a CUDA place,
    decided from the program alone before it runs: not when an op of any
    of its blocks ends a segment (:func:`_breaker`: a host op, ``while``
    or ``conditional_block``, a draw through a reseeded generator, a host
    read of its inputs, a sparse lookup).  ``dynamic_rnn`` and ``gpipe``
    loop a number of times fixed by the feed's padded shape and their
    attributes and read nothing on the host, so a capture holds them.
    Either way the program runs on the segmented runner (:class:`
    _SegmentedProgram`): a capturable one is its one segment, a refused
    one has its device segments captured between the ops that end them;
    every program on the CPU runs op by op."""
    return not capture_refusals(program)


def capture_refusals(program):
    """The types of the ops of `program` for which :func:`capturable`
    refuses it, sorted (empty: it is captured whole)."""
    return sorted({op.type for blk in program.blocks for op in blk.ops
                   if _breaker(op) is not None})


@contextlib.contextmanager
def _no_collection():
    """No cyclic garbage collection inside: a graph collected during a
    capture (an executor or predictor left in a reference cycle) would be
    destroyed on the capturing thread, a call the capture forbids, and
    the capture would fail.  torch.cuda.graph collects once on entry."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def _storage(t):
    return t.untyped_storage().data_ptr()


def _matches(a, b):
    return isinstance(a, torch.Tensor) and a.shape == b.shape and \
        a.dtype == b.dtype and a.device == b.device


def _write_into(pairs):
    """Copy each (target, value) pair's value into its target, as of
    before any of the copies: a value that shares storage with a target
    (an op that hands a state tensor on) is cloned first."""
    targets = {_storage(t) for t, _ in pairs}
    pending = [(t, v.clone() if _storage(v) in targets else v)
               for t, v in pairs if v is not t]
    for t, v in pending:
        t.copy_(v)


class _Captures:
    """What the captured segments of one Executor share: its device, the
    device step word the random ops key their draws by, one graph memory
    pool and capture stream, the lock that orders captures and replays
    (a serving engine runs them on its own thread), and the tensors
    adopted as static state buffers with the Scope bound to them."""

    def __init__(self, device):
        self.device = device
        self.step_word = torch.zeros(1, dtype=torch.int64, device=device)
        self.lock = threading.RLock()
        self._adopted = weakref.WeakValueDictionary()     # id -> tensor
        # the static outputs of the segments' graphs (id -> tensor): a
        # segment reads one of them in place instead of copying it
        self._outputs = weakref.WeakValueDictionary()
        self._scope = None                 # weakref: the bound Scope
        self._pool = self._stream = None
        self.capture_ms = []               # one entry per capture

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def owns(self, t):
        return isinstance(t, torch.Tensor) and self._adopted.get(id(t)) is t

    def static(self, t):
        """Whether `t` keeps its identity from run to run: an adopted
        state buffer or a graph's static output."""
        return isinstance(t, torch.Tensor) and (
            self._adopted.get(id(t)) is t or self._outputs.get(id(t)) is t)

    def mark_outputs(self, values):
        for t in values:
            self._outputs[id(t)] = t

    def fresh(self, like):
        """A new adopted tensor of `like`'s shape and dtype."""
        t = torch.empty(like.shape, dtype=like.dtype, device=self.device)
        self._adopted[id(t)] = t
        return t

    def adopt(self, cur, taken):
        """The static buffer of a Scope tensor: the tensor itself when it
        is adopted already and no other name of the step took it
        (`taken`, storage addresses), else a new one that the first run
        fills (``_Step.bind``)."""
        t = cur if self.owns(cur) and _storage(cur) not in taken else \
            self.fresh(cur)
        taken.add(_storage(t))
        return t

    def enter(self, scope):
        """Bind `scope` to the adopted tensors: the Scope bound before
        gets a copy of each adopted tensor it holds, so two scopes run on
        one executor never share state, as with the interpreter."""
        old = self._scope() if self._scope is not None else None
        if old is not None and old is not scope:
            for n, t in list(old.vars.items()):
                if self.owns(t):
                    old.vars[n] = t.clone()
        self._scope = weakref.ref(scope)

    def write_adopted(self, scope, new):
        """The warmup's state write: in place into the Scope tensors that
        are adopted (so every captured signature binds the same tensors),
        a swap for the rest, as the interpreter writes.  A swapped-in
        value that is one of the tensors written in place (a program that
        backs a state tensor up under another name, as ModelAverage's
        apply does) is cloned first, so the copies do not reach it."""
        pairs, swaps = [], []
        for n, v in new.items():
            cur = scope.find_var(n)
            if self.owns(cur) and _matches(v, cur):
                pairs.append((cur, v))
            else:
                swaps.append((n, v))
        targets = {_storage(t) for t, v in pairs if v is not t}
        for n, v in swaps:
            scope.set_var(n, v.clone() if isinstance(v, torch.Tensor)
                          and _storage(v) in targets else v)
        _write_into(pairs)


class _Step:
    """One signature of a :class:`_SegmentRunner`: the static buffers of
    its inputs from the run's values (`feeds`) and from the Scope
    (`state`, `reads`), the adopted buffers its written persistables are
    copied into (`targets`), and with a graph the captured graph, its
    output tensors and each launch counter's delta over the segment."""

    def __init__(self):
        self.feeds, self.state, self.reads, self.targets = {}, {}, [], {}
        self.graph, self.fetches, self.launches = None, None, ()

    def bind(self, scope, device):
        """Point the Scope at the static buffers before a run: a name
        whose Scope tensor is another one is copied into its buffer.
        False when one has another shape or dtype (the step is captured
        again)."""
        for n in self.reads:
            t = self.state[n]
            if scope.find_var(n) is t:
                continue
            cur = _scope_read(scope, n, device)
            if not _matches(cur, t):
                return False
            t.copy_(cur)
            scope.set_var(n, t)
        return True

    def release(self):
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.fetches = None
        self.feeds, self.state, self.targets = {}, {}, {}


def capture_graph(body, pool, stream):
    """Capture body() into one CUDA graph on `pool` and `stream`, one
    capture at a time in the process and with no cyclic collection during
    it.  Capture runs nothing: returns (graph, body's result, ((launch
    counter, its delta over the captured body), ...)), the counters left
    as they were, for each replay to add its delta.  A failed capture
    raises, naming the op."""
    from ..ops.cuda_build import launch_counters

    before = {id(c): c.launches for c in launch_counters()}
    graph = torch.cuda.CUDAGraph()
    failed = []
    try:
        with _CAPTURE_LOCK, _no_collection():
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                try:
                    result = body()
                except BaseException as e:
                    failed.append(e)
                    raise
    except Exception as e:
        cause = failed[0] if failed else e
        notes = "; ".join(getattr(cause, "__notes__", ()))
        raise RuntimeError(
            "capturing the step as a CUDA graph failed "
            f"({notes or 'outside any op'}): {cause!r}") from cause
    finally:
        deltas = []
        for c in launch_counters():
            b = before.get(id(c), 0)
            deltas.append((c, c.launches - b))
            c.launches = b
    return graph, result, tuple((c, d) for c, d in deltas if d)


# ---------------------------------------------------------------------------
# The mixed host/device runner: device segments between host ops, each
# captured per signature
# ---------------------------------------------------------------------------

def _block_reads(blk, acc):
    """Every name an op of `blk`, or of a block it holds, reads."""
    for op in blk.ops:
        acc.update(op.input_arg_names)
        for v in op.attrs.values():
            if isinstance(v, Block):
                _block_reads(v, acc)


def _host_reads(op):
    """The names a host, ``while`` or ``conditional_block`` entry reads on
    the host: a host op's inputs, a loop's or branch's condition (its
    body runs as device segments of its own)."""
    if op.type == "while":
        return set(op.inputs["Condition"])
    if op.type == "conditional_block":
        return set(op.inputs["Cond"])
    return set(op.input_arg_names)


def _host_program_segments(program, fetch_names, block=None,
                           make_runner=None):
    """Partition `block` (default: the global block) for the mixed
    host/device runner (the reference's ``_host_program_segments``):
    maximal runs of device ops become one segment each, and the ops that
    end a segment (:func:`_breaker`) stay between them.  Returns
    ``[(kind, payload)]``: kind "host", "while" or "cond" with the op, or
    "device" with ``(ops, in_names, out_names, host_outs, runner)``.

    A name a segment produces leaves it (``out_names``) when a later
    segment, a control-flow body, a fetch (`fetch_names`; a loop body's
    caller passes the names it carries) or a persistable needs it.  Of
    those, ``host_outs`` are the names a later host op reads: the runner
    starts their copy to pinned host memory as the segment ends.  The
    reference counts every name a later loop body reads there too, as its
    bodies run op by op on the host; here a body is device segments of its
    own, and only a condition is read on the host, from the device.

    A run of the port's own breakers (a generator draw, a host read of
    inputs, a sparse lookup) is a device segment that never captures: its
    runner gives the reason.  `make_runner(block, ops, in_names,
    out_names, host_outs)` builds each runner (default: an uncaptured
    :class:`_SegmentRunner` on the CPU)."""
    from ..distributed import host_ops

    block = block if block is not None else program.global_block()
    if make_runner is None:
        def make_runner(blk, ops, in_names, out_names, host_outs):
            return _SegmentRunner(blk, ops, in_names, out_names, host_outs)
    runs, cur, cur_breaks = [], [], False
    for op in block.ops:
        if op.type in ("feed", "fetch"):
            continue
        if host_ops.is_host_op(op.type) or op.type in _SUB_BLOCK_OPS:
            if cur:
                runs.append(("device", cur))
                cur = []
            runs.append((op.type, op))
            continue
        breaks = _breaker(op) is not None
        if cur and breaks != cur_breaks:
            runs.append(("device", cur))
            cur = []
        cur.append(op)
        cur_breaks = breaks
    if cur:
        runs.append(("device", cur))

    reads_after, acc = [], set(fetch_names)     # reads after each run
    host_reads_after, acc_h = [], set()         # host reads after it
    for kind, payload in reversed(runs):
        reads_after.append(set(acc))
        host_reads_after.append(set(acc_h))
        if kind == "device":
            for op in payload:
                acc.update(op.input_arg_names)
        else:
            acc.update(payload.input_arg_names)
            for v in payload.attrs.values():
                if isinstance(v, Block):
                    _block_reads(v, acc)
            acc_h |= _host_reads(payload)
    reads_after.reverse()
    host_reads_after.reverse()

    segments = []
    for i, (kind, payload) in enumerate(runs):
        if kind != "device":
            segments.append(({"while": "while",
                              "conditional_block": "cond"}.get(kind, "host"),
                             payload))
            continue
        produced, in_names = set(), []
        for op in payload:
            for n in op.input_arg_names:
                if n not in produced and n not in in_names:
                    in_names.append(n)
            produced.update(op.output_arg_names)
        out_names = []
        for op in payload:
            for n in op.output_arg_names:
                if n in out_names:
                    continue
                bv = block._find_var_recursive(n)
                if n in reads_after[i] or (bv is not None
                                           and bv.persistable):
                    out_names.append(n)
        host_outs = [n for n in out_names if n in host_reads_after[i]]
        segments.append(("device", (payload, in_names, out_names, host_outs,
                                    make_runner(block, payload, in_names,
                                                out_names, host_outs))))
    return segments


def _leaves(v):
    """The tensors of an env value a graph can take: a tensor, or a
    tensor array's ``(buffer, count)`` pair (``ops/array_ops.py``); None
    for anything else (a LoD list, a SelectedRows)."""
    if isinstance(v, torch.Tensor):
        return (v,)
    if isinstance(v, tuple) and v and all(isinstance(t, torch.Tensor)
                                          for t in v):
        return v
    return None


def _rebuild(like, leaves):
    return leaves[0] if isinstance(like, torch.Tensor) else tuple(leaves)


class _SegmentRunner:
    """One device segment of a segmented program (the reference's
    ``_SegmentRunner``), captured per signature: a signature's first run
    is op by op (the warmup of what a capture must find done: cuBLAS and
    cuDNN handles, the hand kernels' build), its second captures one CUDA
    graph (:func:`capture_graph`) and replays it, and later runs replay.
    A program with no op that ends a segment is one segment, captured
    whole (the reference's compiled step).

    A signature is the shapes and dtypes of the inputs from the run's
    values, the names read from the Scope, and what a capture bakes in
    (:func:`_baked`).  An input from the Scope is bound to an adopted
    state buffer (``_Step.bind``), so the Scope keeps that tensor; one of
    another shape or dtype sets the signature up again.  An input from the run's values is
    copied into a static buffer before each replay, unless at the capture
    it was a tensor that keeps its identity (an adopted state buffer, or
    another segment's graph output): the graph then reads it in place,
    and a replay that finds another tensor there captures once more, with
    a buffer.  The graph ends by copying each persistable it wrote into
    an adopted buffer, the Scope's own tensor where it read one
    (``targets``; the reference's donation plays that role), and an output
    that shares storage with such a buffer leaves as a copy of its own.
    The other outputs are the graph's own tensors; those named in `clone`
    (a loop body's carried names, which outlive the next replay) are
    handed out as copies.  Random ops key their draws by the executor's
    device step word, which gives the interpreter's bits.

    Never captured: a segment of ops that end segments (``reason``), a
    signature whose inputs or outputs hold a value that is neither a
    tensor nor a tensor array's pair (``refused``).  ``use_graph=False``
    (on the CPU, always) runs the bookkeeping above op by op at every
    run from the first: the uncaptured arm a graph is held against.

    The segments of the global block share the executor's graph memory
    pool: they replay in the order they were captured.  A loop or branch
    body's segment (`in_body`) has a pool of its own and writes nothing
    back (its carried names leave as copies): its graphs are captured in
    the loop's first run, before the segments around the loop, and its
    first iteration's signature after its later ones."""

    def __init__(self, block, ops, in_names, out_names, host_outs,
                 captures=None, use_graph=False, reads=None, clone=(),
                 label=None, in_body=False):
        self.block, self.ops = block, list(ops)
        self.in_names, self.out_names = list(in_names), list(out_names)
        self.host_outs = list(host_outs)
        self.captures = captures if captures is not None else _Captures(
            torch.device("cpu"))
        self.device = self.captures.device
        self.use_graph = use_graph
        self.reads = reads
        self.clone = set(clone)
        self.in_body = in_body
        self._own_pool = None
        self.label = label or f"{self.ops[0].type}..{self.ops[-1].type}" \
            f" ({len(self.ops)} ops)"
        self.reason = next((r for r in map(_breaker, self.ops)
                            if r is not None), None)
        # the persistables (not data) the graph writes back
        self._writes = set() if in_body else {
            n for n in self.out_names
            if (v := block._find_var_recursive(n)) is not None
            and v.persistable and not v.is_data}
        # names read only as a generic_grad's forward outputs: absent
        # when nothing else wanted them (see read_names)
        plain = {n for op in self.ops for slot, names in op.inputs.items()
                 if not (op.type == "generic_grad"
                         and slot.endswith("@FW_OUT")) for n in names}
        self._optional = set(self.in_names) - plain
        self._steps, self._warm = {}, set()
        # inputs a graph never reads in place: a loop body's carried names
        # (another tensor each iteration) and any found changing
        self._copied = self.clone & set(self.in_names)
        self.refused = {}              # why a run went op by op -> runs
        self.compile_count = self.replays = 0

    def _inputs(self, env, scope):
        """[(name, from the Scope, value)] of this run, and why a graph
        cannot take them (None: it can).  A Scope tensor is checked where
        it is bound (``_Step.bind``), unless it is the buffer already."""
        ins, why = [], None
        for n in self.in_names:
            if n in env:
                ins.append((n, False, env[n]))
            elif n not in self._optional:
                v = scope.find_var(n)
                if not isinstance(v, torch.Tensor):
                    v = _scope_read(scope, n, self.device)
                ins.append((n, True, v))
        for n, from_scope, v in ins:
            leaves = _leaves(v)
            if leaves is None or (not from_scope and any(
                    t.device != self.device for t in leaves)):
                why = f"input {n!r} holds a {type(v).__name__}" + (
                    f" on {leaves[0].device}" if leaves else "")
                break
        return ins, why

    def signature(self, ins):
        """The shapes and dtypes of the inputs from the run's values, the
        names read from the Scope, and what a capture bakes in; a Scope
        tensor of another shape or dtype than its buffer's sets the
        signature up again (``_Step.bind``)."""
        return (tuple((n, tuple((tuple(t.shape), t.dtype)
                                for t in _leaves(v)))
                      for n, from_scope, v in ins if not from_scope),
                tuple(n for n, from_scope, _ in ins if from_scope)) + \
            _baked()

    def run(self, env, read, scope, step, staged):
        """Run the segment on the run's values `env` (its outputs land
        there) and start the copies of its ``host_outs`` into `staged`."""
        while True:
            if self.reason is not None:
                break
            ins, why = self._inputs(env, scope)
            if why is not None:
                self.refused[why] = self.refused.get(why, 0) + 1
                break
            sig = self.signature(ins)
            st = self._steps.get(sig)
            if st is None and (not self.use_graph or sig in self._warm):
                st = self._setup(sig, ins, step)
            if st is None or st is _UNCAPTURED:
                self._warm.add(sig)
                break
            if self._replay(sig, st, ins, env, scope, step):
                self._stage(env, staged)
                return
            # a Scope tensor changed shape, or an input read in place is
            # another tensor now: set the signature up again
        # op by op: the warmup of a signature, or a segment no graph holds
        _run_ops(self.ops, env, read)
        self._stage(env, staged)

    def _stage(self, env, staged):
        from ..distributed.host_ops import HostCopy

        for n in self.host_outs:
            v = env.get(n)
            if isinstance(v, torch.Tensor):
                staged[n] = HostCopy(v)

    def _setup(self, sig, ins, step):
        """Set signature `sig` up: its buffers, and with a graph its
        capture (which runs nothing).  The run that replays it binds the
        Scope to the buffers (``_Step.bind``)."""
        caps = self.captures
        st = _Step()
        taken = set()
        for n, from_scope, v in ins:
            if from_scope:
                st.state[n] = caps.adopt(v, taken)
                st.reads.append(n)
            else:
                st.feeds[n] = _rebuild(v, [
                    t if caps.static(t) and n not in self._copied
                    else torch.empty_like(t) for t in _leaves(v)])
        if self.use_graph:
            t0 = time.perf_counter()
            try:
                st.graph, st.fetches, st.launches = capture_graph(
                    lambda: self._body(st, step), self._pool(),
                    caps.stream())
            except _OutputRefused as e:
                self.refused[str(e)] = self.refused.get(str(e), 0) + 1
                self._steps[sig] = _UNCAPTURED
                return _UNCAPTURED
            caps.capture_ms.append((time.perf_counter() - t0) * 1e3)
            caps.mark_outputs(t for v in st.fetches if v is not None
                              for t in _leaves(v))
        self._steps[sig] = st
        self.compile_count += 1
        return st

    def _pool(self):
        if not self.in_body:
            return self.captures.pool()
        if self._own_pool is None:
            self._own_pool = torch.cuda.graph_pool_handle()
        return self._own_pool

    def _body(self, st, step):
        """The segment over its static buffers: its outputs (None where an
        op left one out), the written persistables copied into their
        adopted buffers."""
        env = dict(st.feeds)
        env.update(st.state)
        run = registry.current()

        def read(n):
            raise RuntimeError(f"segment {self.label} reads {n!r}, which "
                               "is not among its inputs")

        ctx = registry.ExecContext(
            device=self.device, seed=run.seed, step=step,
            is_test=run.is_test, masks={}, reads=self.reads, mesh=run.mesh,
            amp=run.amp, step_word=self.captures.step_word)
        with registry.exec_context(ctx):
            _run_ops(self.ops, env, read)
            outs = [env.get(n) for n in self.out_names]
            self._write_back(st, outs)
        if self.use_graph:
            for n, v in zip(self.out_names, outs):
                if v is not None and _leaves(v) is None:
                    raise _OutputRefused(f"output {n!r} holds a "
                                         f"{type(v).__name__}")
        return outs

    def _write_back(self, st, outs):
        """Copy each written persistable into its adopted buffer (the one
        bound to the Scope where the segment read it, else a new one) and
        put the buffer among `outs`.  An output that shares storage with
        one of those buffers or with an adopted input leaves as a copy, so
        no value the run hands on changes when a later write lands."""
        caps, pairs = self.captures, []
        for i, n in enumerate(self.out_names):
            v = outs[i]
            if n not in self._writes or not isinstance(v, torch.Tensor):
                continue
            t = st.targets.get(n)
            if t is None:
                t = st.state.get(n, st.feeds.get(n))
                t = st.targets[n] = t if caps.owns(t) and _matches(t, v) \
                    else caps.fresh(v)
            pairs.append((t, v))
            outs[i] = t
        held = {_storage(t) for t, _ in pairs} | {
            _storage(t) for v in (*st.state.values(), *st.feeds.values())
            for t in _leaves(v) or () if caps.owns(t)}
        for i, (n, v) in enumerate(zip(self.out_names, outs)):
            if n not in self._writes and isinstance(v, torch.Tensor) and \
                    _storage(v) in held:
                outs[i] = v.clone()
        _write_into(pairs)

    def _replay(self, sig, st, ins, env, scope, step):
        """Run signature `sig`'s step: False (and the step dropped) when it
        no longer fits this run's tensors."""
        if not st.bind(scope, self.device):
            self._steps.pop(sig).release()      # a Scope tensor reshaped
            return False
        for n, from_scope, v in ins:
            if from_scope:
                env[n] = st.state[n]            # as the interpreter reads
                continue
            for buf, t in zip(_leaves(st.feeds[n]), _leaves(v)):
                if t is buf:
                    continue
                if self.captures.static(buf):
                    # read in place at the capture, another tensor now:
                    # capture again with a buffer for this input
                    self._copied.add(n)
                    self._steps.pop(sig).release()
                    return False
                buf.copy_(t)
        if st.graph is not None:
            st.graph.replay()
            for counter, delta in st.launches:
                counter.launches += delta
            outs = st.fetches
            self.replays += 1
        else:
            outs = self._body(st, step)
        for n, v in zip(self.out_names, outs):
            if v is not None:
                env[n] = _rebuild(v, [t.clone() for t in _leaves(v)]) \
                    if n in self.clone and st.graph is not None else v
        return True

    def release(self):
        for st in self._steps.values():
            if st is not _UNCAPTURED:
                st.release()
        self._steps.clear()


class _OutputRefused(Exception):
    """A segment's output a graph cannot hand on (not a tensor or a tensor
    array's pair): the signature runs op by op."""


_UNCAPTURED = object()          # _SegmentRunner._steps: never captured


class _SegmentedProgram:
    """The run of (program, feeds, fetches) on a CUDA place: the port of
    the reference's ``_run_eager`` (without its ``feed_next`` prefetch),
    whose one-segment case is the reference's compiled step.  The global
    block and each loop or branch body are cut by
    :func:`_host_program_segments` once, on first use; the device
    segments are :class:`_SegmentRunner` s sharing the executor's
    ``_Captures`` (its step word, graph pool and adopted state buffers).
    A program with no op that ends a segment (:func:`capturable`) is one
    segment, captured whole per feed signature.

    A run stages the feeds on the device, but for a feed that only host
    ops read (a CTR batch's ids), which stays on the host.  Host ops run
    through ``host_ops.run_host_op`` on the pinned copies the segments
    before them started (``host_ops.HostCopy``), and adjacent sharded
    lookups are all issued before any is collected, so one round trip
    covers every table.  ``while`` and ``conditional_block`` keep the
    interpreter's semantics (:func:`_run_while`, :func:`_run_conditional`:
    carried names, one condition read an iteration, ``loop_counts``), with
    their bodies run as segments.  The persistables the run wrote go back
    to the Scope, in place into adopted tensors (a graph writes its own;
    ``_Captures.write_adopted`` the rest at the run's end), and the
    fetches are copies.

    `mesh` is a ``CompiledProgram``'s device mesh (every entry the
    executor's device), put into the run's context.  ``use_graph=False``
    (the reference's ``use_jit=False``; on the CPU, always) runs the
    same bookkeeping op by op at every run."""

    def __init__(self, program, feed_names, fetch_names, captures=None,
                 use_graph=True, device=None, mesh=None):
        self.program = program
        self.mesh = mesh
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.captures = captures if captures is not None else _Captures(
            device if device is not None else torch.device("cpu"))
        self.device = self.captures.device
        self.use_graph = use_graph and self.device.type == "cuda"
        block = program.global_block()
        self.reads = read_names(block, self.fetch_names)
        self.runners = []
        self.segments = _host_program_segments(
            program, self.fetch_names, make_runner=self._runner)
        self._bodies = {}              # id(sub-block) -> its segments
        device_reads = set(self.fetch_names)
        for kind, payload in self.segments:
            if kind == "device":
                device_reads.update(payload[1])
            elif kind != "host":
                _block_reads(payload.attrs["sub_block"], device_reads)
                device_reads.update(payload.input_arg_names)
        # feeds no device op reads stay host arrays
        self.host_feeds = {n for n in self.feed_names
                           if n not in device_reads}

    def _runner(self, block, ops, in_names, out_names, host_outs,
                clone=(), in_body=False):
        r = _SegmentRunner(block, ops, in_names, out_names, host_outs,
                           captures=self.captures,
                           use_graph=self.use_graph, reads=self.reads,
                           clone=clone, in_body=in_body,
                           label=f"block {block.idx} segment "
                                 f"{len(self.runners)}: {ops[0].type}.."
                                 f"{ops[-1].type} ({len(ops)} ops)")
        self.runners.append(r)
        return r

    def _body(self, op):
        """The segments of `op`'s sub-block: its names that outlive an
        iteration (written there and declared outside it, or read there
        before written) leave its segments, as copies."""
        sub = op.attrs["sub_block"]
        segs = self._bodies.get(id(sub))
        if segs is None:
            writes = _block_io(sub)[1]
            outer = {n for n in writes if not sub.has_var_local(n)}
            outer |= _upward_reads(sub) & writes
            outer.update(op.inputs.get("Condition", ()))
            segs = self._bodies[id(sub)] = _host_program_segments(
                self.program, sorted(outer), block=sub,
                make_runner=lambda *a: self._runner(*a, clone=outer,
                                                    in_body=True))
        return segs

    @property
    def compile_count(self):
        return sum(r.compile_count for r in self.runners)

    def release(self):
        for r in self.runners:
            r.release()

    def stats(self):
        return {"segments": len(self.runners),
                "captured": self.compile_count,
                "replays": sum(r.replays for r in self.runners),
                "uncaptured": [
                    {"segment": r.label, "reason": why}
                    for r in self.runners
                    for why in ([r.reason] if r.reason else sorted(
                        r.refused))]}

    def _context(self, step, generator=None):
        program = self.program
        return registry.ExecContext(
            device=self.device, generator=generator,
            seed=program.random_seed, step=step,
            is_test=program._is_test or registry.in_test_mode(),
            masks={}, reads=self.reads, mesh=self.mesh,
            amp=getattr(program, "_amp", False))

    def _feed_env(self, feed):
        block = self.program.global_block()
        env = {}
        for n, val in feed.items():
            dtype = block.var(n).dtype if block.has_var(n) else \
                str(np.asarray(val).dtype)
            env[n] = registry.cast_feed(
                val, dtype, torch.device("cpu") if n in self.host_feeds
                else self.device)
        return env

    def run(self, feed, scope, step, generator=None):
        """One run on normalized feeds at executor step `step`; returns
        the fetches as tensors of their own."""
        caps = self.captures
        caps.enter(scope)
        env = self._feed_env(feed)

        def read(n):
            env[n] = val = _scope_read(scope, n, self.device)
            return val

        with torch.no_grad(), registry.exec_context(
                self._context(step, generator)):
            caps.step_word.fill_(step)
            self._run(self.segments, env, read, scope, step)
            fetches = [env[n] if n in env else read(n)
                       for n in self.fetch_names]
            fetches = [f.clone() if isinstance(f, torch.Tensor) else f
                       for f in fetches]
        caps.write_adopted(scope, _written_state(self.program.global_block(),
                                                 env))
        return fetches

    def precompile(self, feed, scope, step):
        """Set up (capture) `feed`'s signature of a program that is one
        segment, without running a step: its warmup runs op by op on the
        feeds and writes no state, and the capture runs nothing, so the
        Scope is left as it is.  A program of several segments (or none)
        sets nothing up: its segments capture at their second run."""
        if len(self.segments) != 1 or self.segments[0][0] != "device":
            return
        runner = self.segments[0][1][4]
        with torch.no_grad(), registry.exec_context(self._context(step)):
            ins, why = runner._inputs(self._feed_env(feed), scope)
            if runner.reason is not None or why is not None:
                return
            sig = runner.signature(ins)
            if sig in runner._steps:
                return
            _interpret(self.program, feed, self.fetch_names, scope,
                       self.device, step, self.reads, mesh=self.mesh,
                       write=None)
            runner._warm.add(sig)
            runner._setup(sig, ins, step)

    def _run(self, segments, env, read, scope, step):
        from ..distributed import host_ops

        staged = {}                    # name -> HostCopy
        i = 0
        while i < len(segments):
            kind, payload = segments[i]
            if kind == "host" and payload.type in host_ops.LOOKUP_HOST_OPS:
                # every adjacent lookup issued before any is collected
                collects = []
                while i < len(segments) and segments[i][0] == "host" and \
                        segments[i][1].type in host_ops.LOOKUP_HOST_OPS:
                    collects.append(self._host_op(
                        segments[i][1], env, read, staged, issue=True))
                    i += 1
                for collect in collects:
                    collect()
                continue
            i += 1
            if kind == "host":
                self._host_op(payload, env, read, staged)
            elif kind in ("while", "cond"):
                run_body = self._body_runner(payload, scope, step)
                (_run_while if kind == "while" else _run_conditional)(
                    payload, env, read, run_body)
            else:
                try:
                    payload[4].run(env, read, scope, step, staged)
                except Exception as e:
                    e.add_note(f"in device segment {payload[4].label}")
                    raise

    def _body_runner(self, op, scope, step):
        """One iteration of `op`'s body over `local`.  What its ops read
        from the Scope lands in `local`, not in the run's values, so every
        iteration takes a name from the same place and keeps one
        signature."""
        segs = self._body(op)

        def run_body(sub, local):
            def read_local(n):
                local[n] = val = _scope_read(scope, n, self.device)
                return val

            self._run(segs, local, read_local, scope, step)

        return run_body

    @staticmethod
    def _host_op(op, env, read, staged, issue=False):
        """Run a host op on the pinned copies of its device inputs (the
        device tensors stay in `env` for the segments); with `issue`, only
        issue a lookup and return its collect()."""
        from ..distributed import host_ops

        for n in op.input_arg_names:
            if n not in env:
                read(n)
        swapped = {n: env[n] for n in op.input_arg_names if n in staged}
        env.update((n, staged[n]) for n in swapped)
        try:
            if issue:
                return host_ops.issue_lookup_op(
                    op, env, op.attrs, op.attrs.get("trainer_id", 0))
            host_ops.run_host_op(op, env)
        except Exception as e:
            e.add_note(f"while running host op {op.type!r} (inputs "
                       f"{dict(op.inputs)})")
            raise
        finally:
            env.update(swapped)


class _CompiledBlock(_SegmentedProgram):
    """The compiled step of (program, feeds, fetches): the reference's
    ``_CompiledBlock`` (``paddle_tpu/core/executor.py:352``), one CUDA
    graph per feed signature where it holds one XLA executable.  The port
    runs it as the one-segment case of :class:`_SegmentedProgram` (a
    program :func:`capturable` admits), and this adds the reference's
    state sets from the same dataflow: ``state_in`` (names read before
    written, and fetches not written), ``state_out`` (persistables
    written), ``donated_in`` (read and written) and ``readonly_in``."""

    def __init__(self, program, feed_names, fetch_names, device=None,
                 use_graph=True, captures=None, mesh=None):
        super().__init__(program, feed_names, fetch_names,
                         captures=captures, use_graph=use_graph,
                         device=device, mesh=mesh)
        block = program.global_block()
        state_in = _upward_reads(block, self.feed_names)
        written = set(self.feed_names) | _block_io(block)[1]
        state_in.update(n for n in self.fetch_names if n not in written)
        self.state_in = sorted(state_in)
        self.state_out = sorted(
            n for n in written
            if block.has_var(n) and block.var(n).persistable)
        out_set = set(self.state_out)

        def _donatable(n):
            v = block._find_var_recursive(n)
            return getattr(v, "donate", None) is not False

        self.donated_in = sorted(n for n in self.state_in
                                 if n in out_set and _donatable(n))
        donated = set(self.donated_in)
        self.readonly_in = sorted(n for n in self.state_in
                                  if n not in donated)

    @property
    def _steps(self):
        """The signatures set up, over its segment(s): signature -> step."""
        return {sig: st for r in self.runners for sig, st in r._steps.items()}


class _ProgramCache:
    """Bounded LRU over compiled program blocks (the reference's
    ``Executor._cache``): an evicted block's graphs are freed, and its
    count is kept so ``compile_count`` survives eviction."""

    def __init__(self, capacity):
        import collections

        self.capacity = max(int(capacity), 1)
        self._d = collections.OrderedDict()
        self.evicted_compiles = 0

    def __len__(self):
        return len(self._d)

    def get(self, key):
        cb = self._d.get(key)
        if cb is not None:
            self._d.move_to_end(key)
        return cb

    def put(self, key, cb):
        self._d[key] = cb
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            _, old = self._d.popitem(last=False)
            self.evicted_compiles += old.compile_count
            old.release()

    def values(self):
        return self._d.values()

    def clear(self):
        for cb in self._d.values():
            self.evicted_compiles += cb.compile_count
            cb.release()
        self._d.clear()


class Executor:
    """fluid.Executor parity surface (executor.py:451).

    ``run`` memoizes the verifier's verdict and the pass pipeline's
    transformed clone per (program version, feeds, fetches), as the
    reference does.  So code that edits a program's ops in place (desc
    surgery, outside the layers and passes that already do so) must bump
    ``program._version``, or the next run takes the stale clone.

    On a CUDA place ``run`` runs every program on the segmented runner
    (``_SegmentedProgram``: its device segments captured per signature
    between its host ops and loops; a :func:`capturable` program is one
    segment, captured whole), cached per (program, version, feeds,
    fetches, mesh) in a ``_ProgramCache`` of
    ``FLAGS_executor_cache_capacity`` entries (:meth:`_run_step`).
    ``use_program_cache=False`` and every run on the CPU interpret op by
    op."""

    def __init__(self, place=None):
        from ..flags import get_flag

        self.place = place if place is not None else CUDAPlace(0)
        self.device = device_of(self.place)
        # the reference's per-trace rng keys: one generator per executor,
        # reseeded per random op from (program seed, op seed, step)
        self.generator = torch.Generator(device=self.device)
        self._step = 0
        # read sets (read_names) by program, then by (its version, fetch
        # list): the key the reference's executable cache uses
        self._reads = weakref.WeakKeyDictionary()
        self._cache = _ProgramCache(
            get_flag("executor_cache_capacity") or 64)
        self._graphs = None          # _Captures, at the first capture
        self._uncaptured = {}        # what ran op by op on a CUDA place, why
        self._dist_endpoints = set()
        self._dist_trainer_id = 0
        # the reference's StepGuard verdict of the last run (None: the
        # port has no StepGuard yet)
        self.last_guard = None

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name=None, fetch_var_name=None, scope=None,
            return_numpy=True, use_program_cache=True, feed_next=None):
        if feed_next is not None:
            raise NotImplementedError(
                "Executor.run(feed_next=...): the prefetch-ahead of the "
                "next step's sharded lookups is not ported yet (ROADMAP "
                "queue 1 item 11)")
        from ..compiler import CompiledProgram

        if isinstance(program, CompiledProgram):
            return program._run(self, feed=feed, fetch_list=fetch_list,
                                scope=scope, return_numpy=return_numpy)
        program = program if program is not None else default_main_program()
        if not feed and getattr(program, "_py_readers", None):
            feed = self._reader_feed(program)
        feed = _normalize_feed(program, dict(feed) if feed else {})
        fetch_names = [_as_fetch_name(f) for f in (fetch_list or [])]
        scope = scope if scope is not None else global_scope()
        program = self._at_seams(program, sorted(feed), fetch_names)
        return self._run_step(program, feed, fetch_names, scope,
                              return_numpy, use_program_cache)

    def _run_step(self, program, feed, fetch_names, scope, return_numpy,
                  use_program_cache=True, reads=None, mesh=None):
        """One run of a prepared `program` on normalized feeds, with `mesh`
        (a ``CompiledProgram``'s) in its context: on the segmented runner
        where :meth:`_captured` says so and the mesh holds no other
        device, else op by op (`reads`: its read set, when known).  Over
        a mesh of several devices a graph cannot hold the ``Tensor.to``
        moves between them: the run is interpreted, the reason recorded
        for :meth:`segment_stats`."""
        if use_program_cache and self._captured(program):
            why = self._mesh_refusal(mesh)
            if why is None:
                return self._run_segmented(program, feed, fetch_names,
                                           scope, return_numpy, mesh)
            self._uncaptured["CompiledProgram step"] = why
        if reads is None:
            reads = self._read_names(program, fetch_names)
        return self._run_program(program, feed, fetch_names, scope,
                                 return_numpy, reads, mesh=mesh)

    def _mesh_refusal(self, mesh):
        """Why a run over `mesh` is not captured (None: it is)."""
        if mesh is None:
            return None
        others = sorted({str(d) for d in mesh.devices.flat
                         if torch.device(d) != self.device})
        if others:
            return (f"the mesh spans {others} besides {self.device}: a "
                    "graph cannot hold the moves")
        return None

    def _run_segmented(self, program, feed, fetch_names, scope,
                       return_numpy, mesh=None):
        """One run of `program` on the segmented runner."""
        self._track_dist_endpoints(program)
        with self._captures().lock:
            fetches = self._segmented(program, feed, fetch_names,
                                      mesh).run(feed, scope, self._step,
                                                self.generator)
            self._step += 1
        return [_to_numpy(f) for f in fetches] if return_numpy \
            else fetches

    def precompile(self, program=None, feed=None, fetch_list=None,
                   scope=None):
        """Capture (program, feed signature) without running a step (the
        reference's ``precompile``): the warmup runs op by op on the
        feeds and writes no state, and the capture runs nothing, so the
        Scope is left as it is.  Only the feeds' shapes and dtypes
        matter.  Only a program ``run`` captures whole (:func:`
        capturable`, on a CUDA place) is set up; a ``CompiledProgram``
        or a program of several segments captures nothing here, its
        segments capturing at their second run."""
        from ..compiler import CompiledProgram

        if isinstance(program, CompiledProgram):
            return
        program = program if program is not None else default_main_program()
        feed = _normalize_feed(program, dict(feed) if feed else {})
        fetch_names = [_as_fetch_name(f) for f in (fetch_list or [])]
        scope = scope if scope is not None else global_scope()
        program = self._at_seams(program, sorted(feed), fetch_names)
        if not self._captured(program):
            return
        with self._captures().lock:
            self._segmented(program, feed, fetch_names).precompile(
                feed, scope, self._step)

    @property
    def compile_count(self):
        """Signatures captured so far, whole steps and segments, over every
        program this executor ran; survives ``_ProgramCache`` eviction."""
        return self._cache.evicted_compiles + sum(
            c.compile_count for c in self._cache.values())

    def segment_stats(self):
        """The segmented runner's counts over the programs it holds now:
        device segments, signatures captured, graph replays, and each
        segment that runs op by op with the reason (``uncaptured``: a
        segment of ops no graph replays, a value a graph cannot take),
        besides the runs a CUDA place interpreted whole (a
        ``CompiledProgram`` over distinct devices)."""
        out = {"segments": 0, "captured": 0, "replays": 0,
               "uncaptured": []}
        for c in self._cache.values():
            st = c.stats()
            for k in ("segments", "captured", "replays"):
                out[k] += st[k]
            out["uncaptured"] += st["uncaptured"]
        out["uncaptured"] += [{"segment": what, "reason": why}
                              for what, why in self._uncaptured.items()]
        return out

    @property
    def capture_ms(self):
        """The wall time of each capture, in order (ms)."""
        return list(self._graphs.capture_ms) if self._graphs else []

    def _captured(self, program):
        """Whether ``run`` takes `program` through the segmented runner:
        on a CUDA place, where its device segments are captured.  The CPU
        interprets.  A check that swaps or records a kernel's Python
        wrapper replaces this by one that returns False, as a replay
        calls no wrapper; a CPU test, by one that returns True, to run
        the runner's uncaptured arm."""
        return self.device.type == "cuda"

    def _captures(self):
        if self._graphs is None:
            self._graphs = _Captures(self.device)
        return self._graphs

    def _segmented(self, program, feed, fetch_names, mesh=None):
        """The cached ``_SegmentedProgram`` of (program, feeds, fetches,
        mesh).  It pins the program and the mesh, so a live entry keeps
        their ids from being reused."""
        feed_names = sorted(feed)
        key = (id(program), program._version, tuple(feed_names),
               tuple(fetch_names), id(mesh))
        seg = self._cache.get(key)
        if seg is None:
            seg = _SegmentedProgram(program, feed_names, fetch_names,
                                    captures=self._captures(), mesh=mesh)
            self._cache.put(key, seg)
        return seg

    @staticmethod
    def _at_seams(program, feed_names, fetch_names):
        """The reference's two seams before a run
        (``paddle_tpu/core/executor.py:922-963``): the verifier
        (FLAGS_validate_program) on every program, then the IR pass
        pipeline (FLAGS_pass_pipeline) on every program without the
        sharded engine's host ops, which the reference runs on its eager
        path without it.  Both memoize per (version, feeds, fetches), so
        a steady-state step pays dict probes.  Returns the program to
        run: the input itself when the pipeline changes nothing, else
        its transformed clone (the clone keeps ``_amp`` and the step
        blocks; the reader feed was taken from the input)."""
        from ..analysis.verifier import validate_at_seam
        from ..distributed.host_ops import is_host_op
        from ..passes import apply_at_seam

        validate_at_seam(program, feed_names=feed_names,
                         fetch_names=fetch_names, where="Executor.run")
        if any(is_host_op(op.type) for blk in program.blocks
               for op in blk.ops):
            return program
        return apply_at_seam(program, feed_names=feed_names,
                             fetch_names=fetch_names, where="Executor.run")

    def _run_program(self, program, feed, fetch_names, scope, return_numpy,
                     reads, mesh=None):
        """Run `program` once, op by op, on normalized feeds: `reads` is
        its read set (:func:`read_names`) and `mesh` the device mesh a
        ``CompiledProgram`` runs it over (None: one device)."""
        self._track_dist_endpoints(program)
        fetches = _interpret(program, feed, fetch_names, scope, self.device,
                             self._step, reads, generator=self.generator,
                             mesh=mesh)
        self._step += 1
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches

    def _reader_feed(self, program):
        """The next staged batch of each of the program's py_readers, on
        this executor's device; EOFException when an epoch ends (the
        reference's reader hook, ``paddle_tpu/core/executor.py:899``)."""
        from ..pyreader import EOFException

        feed = {}
        for reader in program._py_readers:
            batch = reader.next_feed(self.device)
            if batch is None:
                raise EOFException()
            feed.update(batch)
        return feed

    def _read_names(self, program, fetch_names):
        cache = self._reads.setdefault(program, {})
        key = (program._version, tuple(fetch_names))
        if key not in cache:
            cache[key] = read_names(program.global_block(), fetch_names)
        return cache[key]

    def _track_dist_endpoints(self, program):
        """Collect the shard endpoints of the engine's host ops, so
        close() can flush their pushes and notify them."""
        from ..distributed import host_ops

        for op in program.global_block().ops:
            if op.type in host_ops.HOST_OP_TYPES:
                self._dist_endpoints.update(op.attrs.get("endpoints", []))
                self._dist_trainer_id = op.attrs.get("trainer_id", 0)

    def close(self):
        """Graceful trainer exit: free the captured steps' graphs, wait
        for the in-flight pushes of the sharded tables this executor ran,
        then send ``complete`` to their shards (Executor::Close ->
        SendComplete, executor.cc:138-146).  A failed push is raised
        after the shards were notified."""
        self._cache.clear()
        if not self._dist_endpoints:
            return
        from ..distributed.host_ops import flush_pending_sends, send_complete

        endpoints = sorted(self._dist_endpoints)
        self._dist_endpoints = set()
        try:
            flush_pending_sends(endpoints)
        finally:
            send_complete(endpoints, self._dist_trainer_id)
