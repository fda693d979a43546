"""Mesh-aware PartitionSpec inference — the SpecLayout pattern as a
pass (a copy of ``paddle_tpu/passes/sharding.py``).  The port runs on one
card and passes no mesh, so the pass plans nothing (the guard below).

The SNIPPETS.md reference keeps one `SpecLayout` of canonical
PartitionSpecs per PARAMETER ROLE (embedding tables row-sharded over
the model axes, projection weights column-sharded, norms/biases
replicated) instead of hand-annotating every model.  Same idea here,
derived from the IR instead of a config object: a parameter's role is
how the graph CONSUMES it —

| consumed as                      | role        | spec               |
|----------------------------------|-------------|--------------------|
| ``W`` of lookup_table*           | embedding   | rows over model    |
| ``Y`` of mul/matmul (2-D)        | projection  | cols over model    |
| anything else (bias, norm scale, | replicated  | (annotation left   |
| conv filter, optimizer moment)   |             | unset = replicated)|

Optimizer slot state mirrors its parameter: a ``<Slot>Out``-style
optimizer op input whose Param got a spec gets the same spec (moments
must shard with their weights or GSPMD regathers them every step).

Active only under a mesh exposing the MODEL axis
(parallel.mesh.MeshAxes.MODEL); a data-only mesh — the
CompiledProgram default — and the plain Executor seam see an identity
pass, so single-host programs keep byte-identical fingerprints.
Explicit ``ParamAttr(sharding=...)`` annotations always win; a dim
that doesn't divide the axis size is skipped (GSPMD would reject it).
"""

import collections

from .base import OPTIMIZER_OPS, clone_for_rewrite, program_pass

MODEL_AXIS = "model"


def _param_roles(program):
    """name -> set of roles across every reachable consumer.

    Consumers that don't constrain layout are ignored: optimizer
    updates (elementwise over the param), grad ops (the vjp recompute
    mirrors the forward consumer, which already voted), and the
    shape-only fill helpers the backward uses for grad seeds."""
    roles = collections.defaultdict(set)
    for blk in program.blocks:
        for op in blk.ops:
            if op.type in OPTIMIZER_OPS or op.type == "generic_grad" \
                    or op.type.endswith("_grad") or op.type in (
                        "fill_any_like", "fill_zeros_like"):
                continue
            if op.type in ("lookup_table", "lookup_table_v2",
                           "lookup_sparse_table"):
                for n in op.input("W"):
                    roles[n].add("embedding")
                for n in op.input("Ids"):
                    roles[n].add("other")
            elif op.type in ("mul", "matmul"):
                for n in op.input("Y"):
                    roles[n].add("projection")
                for n in op.input("X"):
                    roles[n].add("other")
            else:
                for n in op.input_arg_names:
                    roles[n].add("other")
    return roles


def _divisible(dim, size):
    return dim is not None and int(dim) > 0 and int(dim) % size == 0


def plan_auto_shard(program, ctx):
    """{var name: spec tuple} — pure planning."""
    size = ctx.mesh_axes.get(MODEL_AXIS, 1)
    if size <= 1:
        return {}
    plan = {}
    roles = _param_roles(program)
    gb = program.global_block()
    # the JAX package skips tables its sparse engine shards
    # (paddle_tpu/passes/sharding.py:85); the port has no sparse engine
    # yet, so no table is engine-owned
    for name, v in gb.vars.items():
        if not v.persistable or getattr(v, "sharding", None) is not None:
            continue
        r = roles.get(name, set())
        shape = v.shape
        if r == {"embedding"} and shape is not None and \
                len(shape) == 2 and _divisible(shape[0], size):
            plan[name] = (MODEL_AXIS, None)
        elif r == {"projection"} and shape is not None and \
                len(shape) == 2 and _divisible(shape[1], size):
            plan[name] = (None, MODEL_AXIS)
    # optimizer slot state mirrors its parameter's spec — whether the
    # param got it from this plan or from an explicit ParamAttr
    # annotation (explicit wins for the PARAM, but its moments still
    # need the matching spec or GSPMD regathers them every step)
    for blk in program.blocks:
        for op in blk.ops:
            if op.type not in OPTIMIZER_OPS:
                continue
            pnames = op.input("Param")
            pv = gb.vars.get(pnames[0]) if pnames else None
            if pv is None:
                continue
            spec = plan.get(pnames[0])
            if spec is None and pv.persistable:
                spec = getattr(pv, "sharding", None)
            if spec is None:
                continue
            pshape = pv.shape
            for slot, names in op.inputs.items():
                if slot in ("Param", "Grad", "LearningRate") or \
                        slot.endswith("Pow"):
                    continue
                for n in names:
                    sv = gb.vars.get(n)
                    if sv is not None and sv.persistable and \
                            getattr(sv, "sharding", None) is None and \
                            sv.shape == pshape:
                        plan[n] = spec
    return plan


@program_pass("auto_shard")
def auto_shard(program, ctx):
    plan = plan_auto_shard(program, ctx)
    if not plan:
        return program
    p = clone_for_rewrite(program)
    for blk in p.blocks:
        for name, spec in plan.items():
            v = blk.vars.get(name)
            if v is not None:
                v.sharding = tuple(spec)
    return p
