"""Dead-var elimination: drop unreachable ops, dead output slots, and
unreferenced var declarations.

The eager-deletion gap (reference ``eager_deletion_pass.cc``) closed
the graph-level way: instead of freeing buffers at their last use
inside an interpreter loop (XLA owns buffer lifetimes here), the dead
values simply never enter the traced computation.  Liveness comes from
``analysis.dataflow`` use sites; "observed" values — fetches, feeds,
persistable state, ``is_data`` declarations — are roots.

Three tiers, in order:

1. **op removal** — fixpoint over the whitelist in base.py: an op is
   deleted when every output is unread everywhere, unfetched, and
   non-persistable.  RNG-consuming ops are never deleted even when
   dead (their kernels advance the trace RNG counter; deleting one
   would reshuffle every later op's draws vs the pipeline-off run).
2. **slot dropping** — write-only side channels (reshape2's XShape,
   dropout's Mask, ...) whose every name is dead lose the output slot;
   the kernel still runs byte-identically, the env write is skipped,
   and the declaration becomes removable.
3. **declaration removal** — block vars referenced by no remaining op
   anywhere, not protected, are deleted.
"""

import collections

from ..core import framework
from .base import (DROPPABLE_SLOTS, clone_for_rewrite, host_op_types,
                   is_removable, program_pass)


def _all_ops(program):
    """[(block_idx, op_idx, op)] over every block — orphaned and
    self-contained blocks included, so their reads conservatively count
    as uses."""
    return [(b.idx, i, op)
            for b in program.blocks
            for i, op in enumerate(b.ops)]


def plan_dce(program, ctx):
    """Pure planning: returns (drop_ops, drop_slots, drop_vars) where
    drop_ops = {(block_idx, op_idx)}, drop_slots = {(block_idx, op_idx,
    slot)}, drop_vars = {(block_idx, name)}."""
    keep = ctx.keep_names(program)     # feeds+fetches+persistable+data
    host = host_op_types()
    ops = _all_ops(program)
    alive = {(b, i): True for b, i, _ in ops}

    use_count = collections.Counter()
    for _, _, op in ops:
        for n in op.input_arg_names:
            use_count[n] += 1

    def dead_name(n):
        return n not in keep and use_count.get(n, 0) == 0

    # -- tier 1: op removal fixpoint -----------------------------------
    changed = True
    while changed:
        changed = False
        for b, i, op in ops:
            if not alive[(b, i)] or op.type in host or \
                    not is_removable(op):
                continue
            outs = op.output_arg_names
            if outs and all(dead_name(n) for n in outs):
                alive[(b, i)] = False
                changed = True
                for n in op.input_arg_names:
                    use_count[n] -= 1
    drop_ops = {(b, i) for b, i, _ in ops if not alive[(b, i)]}

    # -- tier 2: dead write-only slots on surviving ops ----------------
    drop_slots = set()
    for b, i, op in ops:
        if not alive[(b, i)]:
            continue
        for slot, names in op.outputs.items():
            if (op.type, slot) not in DROPPABLE_SLOTS:
                continue
            if names and all(dead_name(n) for n in names):
                drop_slots.add((b, i, slot))

    # -- tier 3: unreferenced declarations -----------------------------
    referenced = set(keep)
    for b, i, op in ops:
        if not alive[(b, i)]:
            continue
        referenced.update(op.input_arg_names)
        for slot, names in op.outputs.items():
            if (b, i, slot) in drop_slots:
                continue
            referenced.update(names)
    drop_vars = set()
    for blk in program.blocks:
        for name, v in blk.vars.items():
            if name in referenced or v.persistable or v.is_data or \
                    isinstance(v, framework.Parameter):
                continue
            drop_vars.add((blk.idx, name))

    return drop_ops, drop_slots, drop_vars


@program_pass("dce")
def dead_var_elim(program, ctx):
    drop_ops, drop_slots, drop_vars = plan_dce(program, ctx)
    if not drop_ops and not drop_slots and not drop_vars:
        return program
    p = clone_for_rewrite(program)
    for b, i, slot in drop_slots:
        del p.blocks[b].ops[i].outputs[slot]
    per_block = collections.defaultdict(list)
    for b, i in drop_ops:
        per_block[b].append(i)
    for b, idxs in per_block.items():
        blk = p.blocks[b]
        dead = set(idxs)
        blk.ops = [op for i, op in enumerate(blk.ops) if i not in dead]
    for b, name in drop_vars:
        del p.blocks[b].vars[name]
    return p
