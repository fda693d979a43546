"""Common-subexpression elimination over pure ops.

Two ops compute the same value when they have the same type, the same
attrs, and read the same *values* — same input names at the same
def-version (any intervening write to an input, by ANY op including
optimizer updates and host RPC ops, bumps the version and kills the
match).  The duplicate op is deleted and every later read of its
outputs is rewired to the canonical op's outputs; the now-unreferenced
declarations are left for DCE (which runs after CSE in the default
preset — the "dead only after CSE" case in analysis/corpus.py).

In the port every op is one interpreted kernel call, so a merged op is
work the interpreter and the card never do; the pass is the JAX
package's (``paddle_tpu/passes/cse.py``), so both packages rewrite a
program the same way.

Scope: per block (block 0 and env-transparent sub-block bodies merge
within themselves; no cross-block merging — a sub-block may run zero
or many times).  Eligibility is strictly narrower than DCE's
removable set: the op must be pure, RNG-free, sub-block-free, write no
protected name, not read any of its own outputs (in-place), and every
output must have exactly ONE def site program-wide (renaming a
multiply-written name would capture the other writer's value).
"""

import collections
import hashlib
import re

import numpy as np

from ..analysis import dataflow as dataflow_mod
from ..core import framework
from .base import (PURE_OPS, RNG_OPS, clone_for_rewrite, has_sub_blocks,
                   program_pass)


_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")


# _hash_value / _hash_block: a copy of paddle_tpu/jitcache/keys.py:69-133
# (the port has no jit cache; CSE keys ops by the same attr digest)
def _hash_value(h, v):
    """Deterministic-across-processes attr hashing: no ids, no
    addresses.  Blocks recurse structurally; numpy payloads hash by
    bytes; everything else by an address-stripped repr."""
    if isinstance(v, framework.Block):
        h.update(b"<block>")
        _hash_block(h, v)
        return
    if isinstance(v, np.ndarray):
        h.update(f"<np:{v.dtype}:{v.shape}>".encode())
        h.update(np.ascontiguousarray(v).tobytes())
        return
    if isinstance(v, (list, tuple)):
        h.update(b"<seq>")
        for item in v:
            _hash_value(h, item)
        return
    if isinstance(v, dict):
        h.update(b"<map>")
        for k in sorted(v, key=repr):
            h.update(repr(k).encode())
            _hash_value(h, v[k])
        return
    h.update(_ADDR_RE.sub("0x", repr(v)).encode())


def _hash_block(h, blk):
    for op in blk.ops:
        h.update(op.type.encode())
        for slot in sorted(op.inputs):
            h.update(slot.encode())
            for n in op.inputs[slot]:
                h.update(n.encode())
        for slot in sorted(op.outputs):
            h.update(slot.encode())
            for n in op.outputs[slot]:
                h.update(n.encode())
        for k in sorted(op.attrs):
            h.update(k.encode())
            _hash_value(h, op.attrs[k])
    for name in sorted(blk.vars):
        v = blk.vars[name]
        h.update(name.encode())
        h.update(str(getattr(v, "dtype", None)).encode())
        h.update(str(list(getattr(v, "shape", None) or [])).encode())
        h.update(str((getattr(v, "persistable", False),
                      getattr(v, "lod_level", 0))).encode())
        sharding = getattr(v, "sharding", None)
        if sharding is not None:
            h.update(f"sharding:{sharding}".encode())
        donate = getattr(v, "donate", None)
        if donate is not None:
            h.update(f"donate:{donate}".encode())


def _attrs_digest(attrs):
    h = hashlib.sha256()
    _hash_value(h, {k: v for k, v in attrs.items()})
    return h.hexdigest()


def _eligible(op, keep, def_counts):
    if op.type not in PURE_OPS or op.type in RNG_OPS or \
            has_sub_blocks(op):
        return False
    ins = set(op.input_arg_names)
    for n in op.output_arg_names:
        if n in keep or n in ins or def_counts.get(n, 0) != 1:
            return False
    return True


def _slot_sig(slots, versions):
    return tuple(sorted(
        (slot, tuple((n, versions.get(n, 0)) for n in names))
        for slot, names in slots.items()))


def _rename_in_op(op, renames):
    changed = False
    for slot, names in op.inputs.items():
        new = [renames.get(n, n) for n in names]
        if new != names:
            op.inputs[slot] = new
            changed = True
    for v in op.attrs.values():
        if isinstance(v, framework.Block):
            for inner in v.ops:
                changed |= _rename_in_op(inner, renames)
    return changed


def plan_cse(program, ctx):
    """Pure planning pass: returns (drop_ops, renames) where drop_ops =
    {(block_idx, op_idx)} and renames = {old_name: canonical_name}.
    Planning simulates the rewrite (keys use canonical names) so chains
    of duplicates collapse in one run — the pass is idempotent."""
    keep = ctx.keep_names(program)
    df = dataflow_mod.build(program, feed_names=ctx.feed_names)
    def_counts = {n: len(sites) for n, sites in df.def_sites.items()}

    drop_ops = set()
    renames = {}

    def scan_block(blk):
        versions = collections.defaultdict(int)
        avail = {}
        for i, op in enumerate(blk.ops):
            key = None
            if _eligible(op, keep, def_counts):
                ins = {slot: [renames.get(n, n) for n in names]
                       for slot, names in op.inputs.items()}
                key = (op.type, _slot_sig(ins, versions),
                       _attrs_digest(op.attrs))
                canon = avail.get(key)
                if canon is not None:
                    matched = True
                    for slot, names in op.outputs.items():
                        cnames = canon.outputs.get(slot, [])
                        if len(cnames) != len(names):
                            matched = False
                    if matched:
                        for slot, names in op.outputs.items():
                            for old, new in zip(names,
                                                canon.outputs[slot]):
                                if old != new:
                                    renames[old] = new
                        drop_ops.add((blk.idx, i))
                        continue
            # every surviving op's writes (sub-blocks included)
            # invalidate: bump versions so later reads see new values
            _, writes = dataflow_mod.op_reads_writes(op)
            for n in writes:
                versions[n] += 1
            if key is not None:
                avail[key] = op

    for blk in program.blocks:
        if blk.idx in df.reachable_blocks:
            scan_block(blk)
    return drop_ops, renames


@program_pass("cse")
def common_subexpr_elim(program, ctx):
    drop_ops, renames = plan_cse(program, ctx)
    if not drop_ops:
        return program
    p = clone_for_rewrite(program)
    per_block = collections.defaultdict(set)
    for b, i in drop_ops:
        per_block[b].add(i)
    for blk in p.blocks:
        dead = per_block.get(blk.idx, set())
        blk.ops = [op for i, op in enumerate(blk.ops) if i not in dead]
        for op in blk.ops:
            _rename_in_op(op, renames)
    return p
