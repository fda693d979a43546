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
CUDA place captures it as one CUDA graph per feed signature.  Whether a
program is captured is decided from the program before it runs
(:func:`capturable`); every other program, and every program on the CPU,
is interpreted.  The first run of a signature is an ordinary op-by-op
step (the warmup of cuBLAS, cuDNN and the kernels' build), the second
captures the step and replays it, and later runs replay.  A replay
copies the feeds into the graph's static buffers, writes the step into
the executor's device step word (the random ops' key: ``registry.
DeviceSeed``), replays, and returns copies of the fetches.  The graph
ends by copying each written persistable into the Scope's own tensor (the
reference's donation plays that role), so the Scope's tensors keep their
identity from the capture on; a Scope tensor swapped in between runs is
copied into the static buffer before the replay (a new shape or dtype
recaptures).  ``compile_count`` counts captured signatures and
``precompile`` captures one without running a step.

Control flow: a ``dynamic_rnn`` op runs its step block once per time
step through :func:`_run_block` (``ops/rnn_ops.py``).  A ``while`` op runs
its sub-block on the host for as long as its condition holds, and a
``conditional_block`` op runs its sub-block once if its condition holds
(:func:`_run_while`, :func:`_run_conditional`: the reference's
``_run_while`` and ``_run_conditional``, whose ``lax.while_loop`` and
``lax.cond`` become a host loop and a host branch).  Reading the
condition is the one synchronisation with the card an iteration; the
body's ops, the tensor arrays' indices among them, stay on the device.
:func:`capturable` refuses both ops, so such programs run op by op.

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
    """Run a block's ops in order.  `env` maps names to tensors; `read(n)`
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
    for op in block.ops:
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


def _run_while(op, env, read):
    """A ``while`` op (``controlflow/while_op.cc:50``): run the sub-block
    while ``Condition`` holds, on the carried names only, then write them
    back into `env` (the reference's ``_run_while``, with a host loop
    where it has ``lax.while_loop``).  Each iteration runs on a fresh
    copy of `env` updated with the carry, as the reference's body does."""
    sub = op.attrs["sub_block"]
    cond_name = op.inputs["Condition"][0]
    names = _carried(sub, env, read, (cond_name,))
    carry = {n: env[n] for n in names}
    loop_counts["loops"] += 1
    while _holds(carry[cond_name]):
        local = dict(env)
        local.update(carry)
        _run_block(sub, local, read)
        carry = {n: local[n] for n in names}
        loop_counts["iterations"] += 1
    env.update(carry)


def _run_conditional(op, env, read):
    """A ``conditional_block`` op: run the sub-block iff ``Cond`` holds,
    and write back only the carried names (the reference's
    ``_run_conditional``; a name the block writes must exist before it,
    its old value being the false branch)."""
    sub = op.attrs["sub_block"]
    cond_name = op.inputs["Cond"][0]
    names = _carried(sub, env, read)
    cond = env[cond_name] if cond_name in env else read(cond_name)
    if _holds(cond):
        local = dict(env)
        _run_block(sub, local, read)
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
# The compiled step: one captured CUDA graph per feed signature
# ---------------------------------------------------------------------------

# one capture at a time in the process: a capture's entry synchronizes
# the device and frees cached memory, which another thread's capture in
# flight forbids (two serving replicas, each with its executor)
_CAPTURE_LOCK = threading.Lock()

# flags a kernel reads as it runs: a graph replays the setting it was
# captured under, so they are part of a signature, as are the matmul and
# convolution settings torch.backends holds
_KERNEL_FLAGS = ("use_fused_dropout", "ring_flash")


def capturable(program):
    """Whether ``Executor.run`` captures `program` on a CUDA place, decided
    from the program alone before it runs.  Not when an op of any of its
    blocks, or the forward op of a grad op, is
      - a host op of the sharded embedding engine (RPC on the host; the
        reference runs these on its eager path, ``_has_host_ops``),
      - ``dynamic_rnn``, ``gpipe``, ``while`` or ``conditional_block`` (a
        Python loop over steps or sub-blocks; a ``while`` loop also reads
        its condition from the card every iteration, so its trip count
        is not known when a graph would be captured),
      - drawn through a reseeded torch generator
        (``registry.generator_for``: its seed is host state),
      - one that reads its inputs' values on the host
        (``registry.reads_on_host``: ``chunk_eval``, ``tree_conv``,
        ``hash``, ``similarity_focus``, ``range``), whose results a
        replay would not recompute, or
      - sparse (``is_sparse``: merging a SelectedRows grad reads its rows
        on the host).
    Those programs run op by op, as every program does on the CPU."""
    return not capture_refusals(program)


def capture_refusals(program):
    """The types of the ops of `program` for which :func:`capturable`
    refuses it, sorted (empty: it is captured)."""
    from ..distributed.host_ops import is_host_op

    refused = set()
    for blk in program.blocks:
        for op in blk.ops:
            kinds = [op.type]
            fw_attrs = op.attrs.get("fw_attrs")
            fw_attrs = fw_attrs if isinstance(fw_attrs, dict) else {}
            if op.type == "generic_grad":
                kinds.append(op.attrs.get("fw_type"))
            elif op.type.endswith("_grad"):
                kinds.append(op.type[:-5])
            if any(t in _SUB_BLOCK_OPS or t in SELF_CONTAINED_BLOCK_OPS
                   or is_host_op(t) or registry.draws_from_generator(t)
                   or registry.reads_on_host(t)
                   for t in kinds) or op.attrs.get("is_sparse") \
                    or fw_attrs.get("is_sparse"):
                refused.add(op.type)
    return sorted(refused)


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
    """What the compiled steps of one Executor share: its device, the
    device step word the random ops key their draws by, one graph memory
    pool and capture stream, the lock that orders captures and replays
    (a serving engine runs them on its own thread), and the tensors
    adopted as static state buffers with the Scope bound to them."""

    def __init__(self, device):
        self.device = device
        self.step_word = torch.zeros(1, dtype=torch.int64, device=device)
        self.lock = threading.RLock()
        self._adopted = weakref.WeakValueDictionary()     # id -> tensor
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
    """One feed signature of a ``_CompiledBlock``: its static feed
    buffers, the static state buffers of the names it reads (`state`,
    `reads`) and writes (`targets`), and with a graph the captured graph,
    its fetch tensors and each launch counter's delta over the step."""

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
            cur = _scope_read(scope, n, device)
            if cur is t:
                continue
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


class _CompiledBlock:
    """The compiled step of (program, feeds, fetches): the reference's
    ``_CompiledBlock`` (``paddle_tpu/core/executor.py:352``) with one
    captured CUDA graph per feed signature where it holds one XLA
    executable.  A signature is the feeds' shapes and dtypes with what a
    capture bakes in besides: test mode, the kernel flags and
    ``torch.backends``' matmul and convolution settings.

    ``state_in`` (names read before written, and fetches not written),
    ``state_out`` (persistables written), ``donated_in`` (read and
    written) and ``readonly_in`` are the reference's sets, from the same
    dataflow.  Every Scope tensor of ``state_in`` and ``state_out`` is
    bound to an adopted static buffer; the step reads the buffers and
    ends by copying what it wrote into them.

    ``use_graph=False`` (the reference's ``use_jit=False``) runs the same
    bookkeeping — static buffers, in-place write-back, fetch copies, the
    device step word — op by op at every run, with no graph: it runs on
    the CPU and is the uncaptured arm the graph is held against.
    ``compile_count`` counts signatures set up (captured)."""

    def __init__(self, program, feed_names, fetch_names, device=None,
                 use_graph=True, captures=None):
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.use_graph = use_graph
        self.captures = captures if captures is not None else _Captures(
            device if device is not None else torch.device("cpu"))
        self.device = self.captures.device
        if use_graph and self.device.type != "cuda":
            raise ValueError(f"a CUDA graph captures CUDA work, not work on "
                             f"{self.device}: pass use_graph=False")
        block = program.global_block()

        # dataflow analysis: which names must come from the Scope (read
        # before written), and which persistables the block writes
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
        # what a run writes back: the interpreter's persistables (not
        # data, not fed)
        self._writes = [n for n in self.state_out
                        if not block.var(n).is_data
                        and n not in self.feed_names]
        self.reads = read_names(block, self.fetch_names)
        self._steps = {}           # signature -> _Step
        self._warm = set()         # signatures whose warmup ran
        self.compile_count = 0

    def signature(self, feed):
        from ..flags import get_flag

        block = self.program.global_block()
        feeds = []
        for n in self.feed_names:
            v = feed[n]
            if isinstance(v, torch.Tensor):
                shape, dtype = tuple(v.shape), str(v.dtype)[6:]
            else:
                v = np.asarray(v)
                shape, dtype = v.shape, str(v.dtype)
            if block.has_var(n):
                dtype = str(block.var(n).dtype)
            feeds.append((n, shape, dtype))
        be = torch.backends
        return (tuple(feeds), registry.in_test_mode(),
                tuple(get_flag(f) for f in _KERNEL_FLAGS),
                (be.cuda.matmul.allow_tf32, be.cudnn.allow_tf32,
                 be.cudnn.benchmark, be.cudnn.deterministic,
                 torch.get_float32_matmul_precision()))

    def run(self, feed, scope, step):
        """One step on normalized feeds at executor step `step`; returns
        the fetches as tensors of their own."""
        sig = self.signature(feed)
        self.captures.enter(scope)
        st = self._steps.get(sig)
        if st is None and self.use_graph and sig not in self._warm:
            # the first run of a signature: an ordinary op-by-op step,
            # and the warmup of what a capture must find done (cuBLAS and
            # cuDNN handles, the hand kernels' build)
            self._warm.add(sig)
            return self._interpret(feed, scope, step,
                                   self.captures.write_adopted)
        if st is None:
            st = self._setup(sig, scope, step)
        if not st.bind(scope, self.device):
            self._steps.pop(sig).release()
            st = self._setup(sig, scope, step)
            st.bind(scope, self.device)
        return self._replay(st, feed, scope, step)

    def precompile(self, feed, scope, step):
        """Set up (capture) `feed`'s signature without running a step: its
        warmup runs op by op on the feeds and writes no state, and the
        capture runs nothing, so the Scope is left as it is."""
        sig = self.signature(feed)
        if sig in self._steps:
            return
        self._interpret(feed, scope, step, None)
        self._warm.add(sig)
        self._setup(sig, scope, step)

    def release(self):
        """Free every signature's graph and buffers (eviction, close)."""
        for st in self._steps.values():
            st.release()
        self._steps.clear()

    def _interpret(self, feed, scope, step, write):
        return _interpret(self.program, feed, self.fetch_names, scope,
                          self.device, step, self.reads, write=write)

    def _setup(self, sig, scope, step):
        caps = self.captures
        st = _Step()
        for n, shape, dtype in sig[0]:
            st.feeds[n] = torch.empty(shape, dtype=registry.torch_dtype(
                dtype), device=self.device)
        taken = set()
        for n in dict.fromkeys(self.state_in + self.state_out):
            cur = scope.find_var(n)
            if isinstance(cur, torch.Tensor) and cur.device == self.device:
                st.state[n] = caps.adopt(cur, taken)
            elif cur is not None and n in self.state_in:
                _scope_read(scope, n, self.device)      # another device
                raise TypeError(
                    f"Variable {n!r} holds a {type(cur).__name__}: a "
                    "compiled step binds tensors")
        st.reads = [n for n in self.state_in if n in st.state]
        if self.use_graph:
            self._capture(st, step)
        self._steps[sig] = st
        self.compile_count += 1
        return st

    def _body(self, st, step):
        """The step over the static buffers: run the block, copy each
        written persistable into its buffer, return the fetches."""
        block = self.program.global_block()
        env = dict(st.feeds)

        def read(n):
            t = st.state.get(n)
            if t is None:
                raise RuntimeError(
                    f"Variable {n!r} is read by the program but has no "
                    "value in scope — did you run the startup program?")
            env[n] = t
            return t

        ctx = registry.ExecContext(
            device=self.device, seed=self.program.random_seed, step=step,
            is_test=self.program._is_test or registry.in_test_mode(),
            masks={}, reads=self.reads,
            amp=getattr(self.program, "_amp", False),
            step_word=self.captures.step_word)
        with torch.no_grad(), registry.exec_context(ctx):
            _run_block(block, env, read)
            fetches = [env[n] if n in env else read(n)
                       for n in self.fetch_names]
            pairs = []
            for n in self._writes:
                v = env.get(n)
                if v is None:
                    continue
                if not isinstance(v, torch.Tensor):
                    raise TypeError(
                        f"Variable {n!r} was written as a "
                        f"{type(v).__name__}: a compiled step writes "
                        "tensors")
                t = st.targets.get(n)
                if t is None:
                    t = st.state.get(n)
                    t = st.targets[n] = t if _matches(v, t) else \
                        self.captures.fresh(v)
                pairs.append((t, v))
            _write_into(pairs)
        return fetches

    def _capture(self, st, step):
        """Capture the step into one CUDA graph on the executor's pool and
        stream (:func:`capture_graph`); the launch counters' deltas over
        the captured step are kept for the replays."""
        caps = self.captures
        t0 = time.perf_counter()
        st.graph, st.fetches, st.launches = capture_graph(
            lambda: self._body(st, step), caps.pool(), caps.stream())
        caps.capture_ms.append((time.perf_counter() - t0) * 1e3)

    def _replay(self, st, feed, scope, step):
        for n, buf in st.feeds.items():
            v = feed[n]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(
                    v, dtype=registry.np_dtype(str(buf.dtype)[6:])))
            buf.copy_(v)
        self.captures.step_word.fill_(step)
        if st.graph is not None:
            st.graph.replay()
            for counter, delta in st.launches:
                counter.launches += delta
            fetches = st.fetches
        else:
            fetches = self._body(st, step)
        for n, t in st.targets.items():
            scope.set_var(n, t)
        return [f.clone() for f in fetches]


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

    On a CUDA place ``run`` captures each :func:`capturable` program once
    per feed signature (``_CompiledBlock``, cached per (program, version,
    feeds, fetches) in a ``_ProgramCache`` of
    ``FLAGS_executor_cache_capacity`` entries) unless
    ``use_program_cache=False``; everything else is interpreted op by
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
        self._capturable = weakref.WeakKeyDictionary()
        self._cache = _ProgramCache(
            get_flag("executor_cache_capacity") or 64)
        self._graphs = None          # _Captures, at the first capture
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
        if use_program_cache and self._captured(program):
            with self._captures().lock:
                fetches = self._compiled(program, feed, fetch_names).run(
                    feed, scope, self._step)
                self._step += 1
            return [_to_numpy(f) for f in fetches] if return_numpy \
                else fetches
        return self._run_program(program, feed, fetch_names, scope,
                                 return_numpy,
                                 self._read_names(program, fetch_names))

    def precompile(self, program=None, feed=None, fetch_list=None,
                   scope=None):
        """Capture (program, feed signature) without running a step (the
        reference's ``precompile``): the warmup runs op by op on the
        feeds and writes no state, and the capture runs nothing, so the
        Scope is left as it is.  Only the feeds' shapes and dtypes
        matter.  A program ``run`` would interpret (the CPU, a
        ``CompiledProgram``, one :func:`capturable` refuses) captures
        nothing."""
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
            self._compiled(program, feed, fetch_names).precompile(
                feed, scope, self._step)

    @property
    def compile_count(self):
        """Feed signatures captured so far, over every program this
        executor ran; survives ``_ProgramCache`` eviction."""
        return self._cache.evicted_compiles + sum(
            c.compile_count for c in self._cache.values())

    @property
    def capture_ms(self):
        """The wall time of each capture, in order (ms)."""
        return list(self._graphs.capture_ms) if self._graphs else []

    def _captured(self, program):
        """Whether `program` runs as a captured step here: a CUDA place
        and :func:`capturable`, memoized per program version."""
        if self.device.type != "cuda":
            return False
        memo = self._capturable.get(program)
        if memo is None or memo[0] != program._version:
            memo = self._capturable[program] = (program._version,
                                                capturable(program))
        return memo[1]

    def _captures(self):
        if self._graphs is None:
            self._graphs = _Captures(self.device)
        return self._graphs

    def _compiled(self, program, feed, fetch_names):
        """The cached ``_CompiledBlock`` of (program, feeds, fetches).  It
        pins the program, so a live entry keeps id(program) from being
        reused."""
        feed_names = sorted(feed)
        key = (id(program), program._version, tuple(feed_names),
               tuple(fetch_names))
        compiled = self._cache.get(key)
        if compiled is None:
            compiled = _CompiledBlock(program, feed_names, fetch_names,
                                      captures=self._captures())
            self._cache.put(key, compiled)
        return compiled

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
