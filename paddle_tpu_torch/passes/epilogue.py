"""Matmul-epilogue isolation — the JAX package's TPU findings as a
graph pass.

XLA fuses cheap epilogues into the dot/conv that produces their
operand: the ``[.., N] -> [N]`` bias-grad column sum, the dtype convert
a wgrad feeds, LN's dScale/dBias reductions.  On TPU that epilogue
serializes the matmul's M-tiles — the producing fusion drops from
MXU-bound to ~26 GB/s "fused-update" behavior (57 ms/step on BERT
before the hand-wired fixes).  Those fixes live inside kernels today:
``optimizer_ops._isolate_update`` barriers the dense Grad,
``elementwise_add_grad`` / ``layer_norm_grad`` barrier their own
reductions.  Programs whose epilogues are *graph-level ops* — a
hand-built ``reduce_sum`` bias grad, a transpiler-inserted ``cast``
on a wgrad — get none of that.

This pass generalizes the fix: it finds reduction/cast ops whose direct
producer is a matmul-class op (or the grad of one) and annotates them
with ``__isolate__`` naming the input slots to pin behind
``jax.lax.optimization_barrier`` at kernel dispatch
(``ops/registry.get_kernel``).  The barrier is applied per-consumer at
the epilogue's own kernel call, so other readers of the matmul output
are untouched, and ``optimization_barrier`` is linear so the
annotation is gradient-transparent (generic_grad carries it through
``fw_attrs`` exactly like ``__amp__``).

Identity on every program the framework builds itself: minimize-built
graphs express bias grads as ``elementwise_add_grad`` /
``generic_grad`` ops whose kernels already isolate internally — so zoo
programs pass through as the same object and pre-pipeline jitcache
fingerprints stay byte-identical (the chaos-stage contract).

In the port (a copy of ``paddle_tpu/passes/epilogue.py``) the pass still
writes ``__isolate__`` so that both packages rewrite a program alike, but
the torch executor ignores the annotation: it is an XLA fusion fence, and
the port's interpreter fuses nothing.
"""

from ..core.framework import is_grad_var_name
from .base import clone_for_rewrite, grad_fw_type, is_grad_op, \
    program_pass

ISOLATE_ATTR = "__isolate__"

# Ops whose output comes off the MXU: fusing a reduction/cast epilogue
# into these is the measured pathology.
MATMUL_OPS = frozenset({
    "mul", "matmul", "conv2d", "depthwise_conv2d", "conv2d_transpose",
    "conv3d", "conv3d_transpose", "fused_attention",
})

# Epilogue consumers worth pinning: rank-reducing column sums (bias
# grads, LN dScale/dBias) and dtype converts (wgrad-consuming casts).
# `sum`/`mean` (loss reductions) are deliberately NOT here — losses
# consume activations through intervening ops and isolating them buys
# nothing.  Casts are pinned ONLY when they consume a gradient (grad
# producer or @GRAD-named operand): a forward activation down-cast is
# element-wise — XLA's in-epilogue convert is free and barriering it
# would force an fp32 round trip through HBM for nothing.
REDUCE_EPILOGUES = frozenset({"reduce_sum", "reduce_mean"})
CAST_EPILOGUES = frozenset({"cast"})


def _is_matmul_producer(op):
    if op.type in MATMUL_OPS:
        return True
    if is_grad_op(op):
        return grad_fw_type(op) in MATMUL_OPS
    return False


def plan_epilogues(program, ctx):
    """Pure planning: {(block_idx, op_idx): sorted [input slots]} of
    epilogue ops to annotate (skipping already-annotated ones — the
    idempotence fast path)."""
    plans = {}
    for blk in program.blocks:
        # last writer per name AT each op index, program order
        last_writer = {}
        for i, op in enumerate(blk.ops):
            if op.type in REDUCE_EPILOGUES or op.type in CAST_EPILOGUES:
                slots = []
                for slot, names in op.inputs.items():
                    for n in names:
                        prod = last_writer.get(n)
                        if prod is None or \
                                not _is_matmul_producer(prod):
                            continue
                        if op.type in CAST_EPILOGUES and not (
                                is_grad_op(prod) or
                                is_grad_var_name(n)):
                            continue
                        slots.append(slot)
                        break
                slots = sorted(set(slots))
                if slots and op.attrs.get(ISOLATE_ATTR) != slots:
                    plans[(blk.idx, i)] = slots
            for n in op.output_arg_names:
                last_writer[n] = op
    return plans


@program_pass("isolate_epilogues")
def isolate_epilogues(program, ctx):
    plans = plan_epilogues(program, ctx)
    if not plans:
        return program
    p = clone_for_rewrite(program)
    for (b, i), slots in plans.items():
        p.blocks[b].ops[i].attrs[ISOLATE_ATTR] = slots
    return p
