"""Optimizer-update isolation as a fusion-boundary placement pass (a
copy of ``paddle_tpu/passes/fusion.py``: the port keeps the rewrite so
that both packages give the same program; the reordering changes no
result in the op-by-op interpreter).

The JAX package's TPU finding, generalized: XLA fused Adam/momentum
updates into the wgrad matmuls that produced their gradients, running
the update at ~26 GB/s and costing 57 ms/step on BERT.  The hand-wired
fix (`ops/optimizer_ops.py:_isolate_update`) puts an
``optimization_barrier`` on each dense Grad at kernel dispatch — that
barrier stays, it is the XLA-level half of the fix.

This pass is the graph-level half: it SINKS every optimizer-update op
below the forward/backward region (dependency-safely, preserving the
relative order of the updates), so the updates form one contiguous
tail — the fusion boundary the reference gets by running optimizer
blocks in a separate phase after the backward.  Programs built by
``Optimizer.minimize`` already have this shape and pass through
UNCHANGED (identity object — fingerprint-stable); hand-built,
transpiled, or desc-surgery programs with interleaved updates get the
fix for free, which is the "any program inherits it" point of moving
the logic out of op sites.

A swap is legal only when the two ops touch disjoint state: the update
must not move past a reader of the parameter it writes (that reader
sees pre- vs post-update values otherwise), past a writer of anything
it reads, or past another writer of its outputs.
"""

from ..analysis import dataflow as dataflow_mod
from .base import OPTIMIZER_OPS, clone_for_rewrite, program_pass


def _sink_order(ops):
    """Final op order (list of original indices) after bubbling every
    optimizer op as far down as dependencies allow."""
    rw = [dataflow_mod.op_reads_writes(op) for op in ops]
    order = list(range(len(ops)))
    changed = True
    while changed:
        changed = False
        for k in range(len(order) - 1):
            a, b = order[k], order[k + 1]
            if ops[a].type not in OPTIMIZER_OPS or \
                    ops[b].type in OPTIMIZER_OPS:
                continue
            ra, wa = rw[a]
            rb, wb = rw[b]
            if wa & (rb | wb) or ra & wb:
                continue
            order[k], order[k + 1] = b, a
            changed = True
    return order


@program_pass("isolate_updates")
def isolate_updates(program, ctx):
    blk = program.global_block()
    order = _sink_order(blk.ops)
    if order == list(range(len(blk.ops))):
        return program
    p = clone_for_rewrite(program)
    pb = p.global_block()
    pb.ops = [pb.ops[i] for i in order]
    return p
