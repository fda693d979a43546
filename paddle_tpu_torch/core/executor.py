"""Executor: run a Program block op by op over torch tensors.

The port of ``paddle_tpu/core/executor.py``.  Where the reference traces a
whole block into one jitted XLA computation, this Executor is the
reference framework's own shape (``Executor::Run``, ``executor.cc:185``):
an interpreter loop that calls one registered kernel per op
(``ops/registry.py``) on tensors that live on the executor's device.
There is no jit and no buffer donation: persistable state the block
writes (an optimizer's ``ParamOut`` under the parameter's own name) is
stored back into the Scope after the run, so the next run reads it.
Kernels never update a tensor in place, because a grad op reads forward
inputs from the run's environment after later ops have run.

Control flow: a ``dynamic_rnn`` op runs its step block once per time
step through :func:`_run_block` (``ops/rnn_ops.py``); ``while`` and
``conditional_block`` raise until a later slice ports them.

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
        if op.type in _SUB_BLOCK_OPS:
            raise NotImplementedError(
                f"op {op.type!r}: control-flow sub-blocks run in a later "
                "slice of the port")
        try:
            for n in op.input_arg_names:
                collect = pending.pop(n, None)
                if collect is not None:
                    collect()
            if op.type in host_ops.HOST_OP_TYPES or \
                    op.type in host_ops.QUEUED_HOST_OP_TYPES:
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


def _absent(op, slot, name, read):
    """A name the run has not written: from the Scope, or None for a
    ``generic_grad`` op's forward output that was left out because
    nothing reads it (see :func:`read_names`)."""
    if op.type == "generic_grad" and slot.endswith("@FW_OUT"):
        return None
    return read(name)


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Executor:
    """fluid.Executor parity surface (executor.py:451)."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = device_of(self.place)
        # the reference's per-trace rng keys: one generator per executor,
        # reseeded per random op from (program seed, op seed, step)
        self.generator = torch.Generator(device=self.device)
        self._step = 0
        # read sets (read_names) by program, then by (its version, fetch
        # list): the key the reference's executable cache uses
        self._reads = weakref.WeakKeyDictionary()
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
        return self._run_program(program, feed, fetch_names, scope,
                                 return_numpy,
                                 self._read_names(program, fetch_names))

    def _run_program(self, program, feed, fetch_names, scope, return_numpy,
                     reads, mesh=None):
        """Run `program` once on normalized feeds: `reads` is its read set
        (:func:`read_names`) and `mesh` the device mesh a
        ``CompiledProgram`` runs it over (None: one device)."""
        self._track_dist_endpoints(program)
        block = program.global_block()

        env = {}
        for n, val in feed.items():
            dtype = block.var(n).dtype if block.has_var(n) else \
                str(np.asarray(val).dtype)
            env[n] = registry.cast_feed(val, dtype, self.device)

        def read(n):
            val = scope.find_var(n)
            if val is None:
                raise RuntimeError(
                    f"Variable {n!r} is read by the program but has no "
                    "value in scope — did you run the startup program?")
            if isinstance(val, torch.Tensor) and val.device != self.device:
                raise RuntimeError(
                    f"Variable {n!r} lives on {val.device}, this executor "
                    f"runs on {self.device}")
            env[n] = val
            return val

        ctx = registry.ExecContext(
            device=self.device, generator=self.generator,
            seed=program.random_seed, step=self._step,
            is_test=program._is_test or registry.in_test_mode(), masks={},
            reads=reads, mesh=mesh)
        with torch.no_grad(), registry.exec_context(ctx):
            _run_block(block, env, read)
            fetches = [env[n] if n in env else read(n) for n in fetch_names]
        self._step += 1
        for n, v in env.items():
            if block.has_var(n) and block.var(n).persistable and \
                    not block.var(n).is_data:
                scope.set_var(n, v)
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
        """Graceful trainer exit: wait for the in-flight pushes of the
        sharded tables this executor ran, then send ``complete`` to their
        shards (Executor::Close -> SendComplete, executor.cc:138-146).
        A failed push is raised after the shards were notified."""
        if not self._dist_endpoints:
            return
        from ..distributed.host_ops import flush_pending_sends, send_complete

        endpoints = sorted(self._dist_endpoints)
        self._dist_endpoints = set()
        try:
            flush_pending_sends(endpoints)
        finally:
            send_complete(endpoints, self._dist_trainer_id)
