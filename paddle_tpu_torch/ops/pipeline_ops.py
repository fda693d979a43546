"""GPipe pipeline-parallel op (the port of ``paddle_tpu/ops/pipeline_ops.py``).

A homogeneous stack of S stages keeps its parameters STACKED with a
leading stage axis (``layers.PipelineStack``); the op runs the stage
sub-block once per stage with that stage's slice.

Off the mesh (no ``CompiledProgram`` mesh, or a "pipe" axis of 1) the
stages run in sequence on the whole batch: the reference's stacked-layer
scan.  On a mesh with "pipe" > 1 it runs the GPipe schedule: the batch is
cut into M microbatches, and over M + S - 1 ticks stage s works on
microbatch t - s on pipe device s (its parameter slice moved there), the
activation moving on to device s + 1 where the reference ppermutes.  The
port is single-controller, so the ticks run one stage after another on
the host; the bubble ticks, where the reference's stages compute on
zeros whose results no one reads, are skipped.  The math is the serial
run's, so pipeline-vs-serial equivalence holds to float rounding.

Under grad the stage body on the mesh runs under
``torch.utils.checkpoint`` (the reference's default
``FLAGS_pipeline_remat``): its backward keeps each tick's stage input and
recomputes the interior activations one tick at a time, the memory bound
1F1B schedules reach.  It keeps no torch generator state for the
recompute: the stage's random ops draw by Philox key (``registry.
philox_words``) and the generator ops reseed per op, so the recompute
draws the same bits anyway, and reading a CUDA generator's state is not
allowed inside a CUDA graph capture.  The grad is the generic grad:
autograd through the schedule.
"""

import torch
from torch.utils.checkpoint import checkpoint

from .registry import register, first, as_out, current


@register("gpipe")
def gpipe(ins, attrs):
    from ..core import executor as executor_mod

    sub = attrs["sub_block"]
    in_name = attrs["in_name"]
    out_name = attrs["out_name"]
    param_inner = attrs["param_inner_names"]
    s_total = int(attrs["num_stages"])
    m = int(attrs["num_microbatches"])

    x = first(ins, "X")
    stacked = list(ins.get("StackedParam", []))
    statics = dict(zip(attrs["static_names"], ins.get("Static", [])))

    def read(name):
        raise KeyError(
            f"gpipe: the stage block reads {name!r}, which is neither its "
            f"input {in_name!r}, a stacked parameter {param_inner} nor a "
            f"Static input {sorted(statics)}")

    def stage_fn(h, *param_slices):
        local = {n: t.to(h.device) for n, t in statics.items()}
        local.update(zip(param_inner, param_slices))
        local[in_name] = h
        executor_mod._run_block(sub, local, read)
        return local[out_name]

    mesh = current().mesh
    if mesh is None or "pipe" not in mesh.axis_names or \
            mesh.shape["pipe"] <= 1:
        h = x
        for s in range(s_total):
            h = stage_fn(h, *(p[s] for p in stacked))
        return as_out(h)

    if mesh.shape["pipe"] != s_total:
        raise ValueError(
            f"PipelineStack has {s_total} stages but mesh 'pipe' axis is "
            f"{mesh.shape['pipe']}")
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by "
                         f"num_microbatches {m}")
    mb = b // m
    devices = [mesh.device(pipe=s) for s in range(s_total)]
    params = [[p[s].to(devices[s]) for p in stacked]
              for s in range(s_total)]
    remat = torch.is_grad_enabled()

    def run_stage(s, h):
        if remat:
            return checkpoint(stage_fn, h, *params[s], use_reentrant=False,
                              preserve_rng_state=False)
        return stage_fn(h, *params[s])

    carry = [None] * s_total            # activation waiting at stage s
    outputs = [None] * m
    for t in range(m + s_total - 1):
        # the last stage first, so each stage reads the activation its
        # predecessor handed over at the previous tick
        for s in reversed(range(s_total)):
            micro = t - s
            if not 0 <= micro < m:
                continue                # a bubble tick
            h = x[micro * mb:(micro + 1) * mb].to(devices[0]) if s == 0 \
                else carry[s]
            y = run_stage(s, h)
            if s == s_total - 1:
                outputs[micro] = y.to(x.device)
            else:
                carry[s + 1] = y.to(devices[s + 1])
    return as_out(torch.cat(outputs, dim=0))
