"""AMP black/white-list propagation: bf16 regions with fp32 islands.

A copy of ``paddle_tpu/passes/amp.py``: a program under
``contrib.mixed_precision.enable`` or a Predictor with
``AnalysisConfig.enable_bf16`` sets ``program._amp``, the Executor's and
the Predictor's pipeline seams run this pass, and the registry's AMP wrap
reads its annotations, so a bf16 program gets the JAX package's
precision plan op for op.

Replaces the purely LOCAL trace-time gray rule (ops/registry.py wraps
each kernel, deciding from the runtime dtypes it happens to see) with a
dataflow-propagated decision annotated onto the IR: each op in an
``_amp`` program gets an ``__amp__`` attr ("bf16" or "fp32") computed
by propagating precision through the def-use graph —

* WHITE ops (matmul/conv) compute in bf16 and launch bf16 regions;
* BLACK ops (losses, reductions, exp/log) compute in fp32 — and their
  fp32 results KEEP downstream gray ops fp32 until the next white op,
  which is the "fp32 island" a per-site runtime check cannot form
  (it would downcast the moment any other operand arrived bf16);
* GRAY ops join the bf16 region only when an input is statically bf16.

The kernel dispatch honors the annotation when present
(registry.get_kernel(op_type, attrs)) and falls back to the legacy
runtime rule when absent — so pipeline-off programs behave exactly as
before, and ops this pass deliberately leaves alone (self-managing
exempt ops, optimizer state, gradient-consuming gray ops whose mixed
fp32-param-grad/bf16-activation-grad inputs the static tracker cannot
see) keep their measured-win behavior.

Grad ops: ``generic_grad`` recomputes the forward (under ``jax.vjp`` in
the JAX package, under autograd in the port), so the decision rides in
``fw_attrs["__amp__"]`` — backward runs bf16 exactly where forward does,
mirroring the wrap-the-dispatch design.

Identity for programs without ``_amp`` set, and for already-annotated
programs (idempotent): the annotation is part of the program structure,
so the post-pipeline jitcache hint fingerprint keys the bf16 graph
distinctly from the fp32 one — as it must, they lower differently.
"""

from ..core import framework
from .base import OPTIMIZER_OPS, clone_for_rewrite, program_pass
from .regions import walk_dataflow

AMP_ATTR = "__amp__"

_BF16 = "bf16"
_FP32 = "fp32"


def _amp_lists():
    from ..ops.registry import (_AMP_BLACK, _AMP_EXEMPT, _AMP_WHITE)

    return _AMP_WHITE, _AMP_BLACK, _AMP_EXEMPT


def _static_float(dtype):
    if dtype == "bfloat16":
        return _BF16
    if dtype in ("float32", "float64", "float16"):
        return _FP32
    return None


def plan_amp(program, ctx):
    """{(block_idx, op_idx, is_grad): mode} — pure planning, driven
    through the shared :func:`passes.regions.walk_dataflow` traversal
    (the quantize pass rides the same walk — one copy of the grad/
    effective-type/sub-block resolution, two sets of lattice rules)."""
    from ..analysis import shapes as shapes_mod
    from ..ops.registry import _NOT_DIFFERENTIABLE

    white, black, exempt = _amp_lists()
    res = shapes_mod.infer(program)
    state = {}                       # var name -> "bf16" | "fp32"

    def tracked(name):
        if name in state:
            return state[name]
        return _static_float(res.dtype_of(name))

    plans = {}

    def decide(eff_type, any_bf16):
        if eff_type in white:
            return _BF16
        if eff_type in black:
            return _FP32
        return _BF16 if any_bf16 else None

    def visit(site):
        op, eff = site.op, site.eff
        any_bf16 = any(tracked(n) == _BF16 for n in site.ins)
        mode = None if site.skippable else decide(eff, any_bf16)
        if mode is not None:
            plans[(site.block.idx, site.idx, site.grad)] = mode
        # propagate: what precision do this op's outputs carry?
        if site.grad:
            # grads stay untracked on purpose: param grads come
            # back fp32 via the cast vjp while activation grads
            # stay bf16 — a static single dtype would be wrong
            return
        if op.type == "cast":
            out_mode = _static_float(framework.convert_dtype(
                op.attrs.get("out_dtype", "float32")))
        elif mode is not None:
            out_mode = mode
        elif eff in exempt:
            out_mode = _BF16 if any_bf16 else _FP32
        elif op.type in _NOT_DIFFERENTIABLE or eff in OPTIMIZER_OPS:
            out_mode = None          # keep static dtypes (fp32 state)
        else:
            out_mode = _FP32 if any(
                tracked(n) is not None for n in site.ins) else None
        if out_mode is not None:
            for n in op.output_arg_names:
                if _static_float(res.dtype_of(n)) is not None or \
                        res.dtype_of(n) is None:
                    state[n] = out_mode

    walk_dataflow(program, visit)
    return plans


@program_pass("amp_propagate")
def amp_propagate(program, ctx):
    if not getattr(program, "_amp", False):
        return program
    plans = plan_amp(program, ctx)
    changed = []
    for (b, i, grad), mode in plans.items():
        op = program.blocks[b].ops[i]
        attrs = op.attrs.get("fw_attrs") if grad else op.attrs
        if not isinstance(attrs, dict) or attrs.get(AMP_ATTR) != mode:
            changed.append((b, i, grad, mode))
    if not changed:
        return program
    p = clone_for_rewrite(program)
    for b, i, grad, mode in changed:
        op = p.blocks[b].ops[i]
        if grad:
            fw = op.attrs.get("fw_attrs")
            if isinstance(fw, dict):
                fw[AMP_ATTR] = mode
        else:
            op.attrs[AMP_ATTR] = mode
    return p
