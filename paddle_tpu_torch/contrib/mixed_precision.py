"""bf16 mixed-precision training (a copy of
``paddle_tpu/contrib/mixed_precision.py``).

Reference capability: ``paddle/contrib/float16/float16_transpiler.py``
(fp16 inference rewrite) and the fp16 benchmark contract of
``paddle/contrib/float16/float16_benchmark.md``.  Instead of rewriting the
program desc with cast ops, a bf16 cast policy wraps kernel dispatch at
run time (``ops/registry.py`` ``get_kernel``), and the Executor's pass
pipeline (``passes/amp.py``) decides each op's precision first:

- WHITE ops (conv/matmul) run in bf16 on the tensor cores;
- BLACK ops (losses, reductions, exp/log) compute in fp32;
- GRAY ops follow their inputs, keeping activation chains bf16.

Parameters and optimizer accumulators stay fp32 (master weights); the
backward pass inherits the same policy through the generic grad's
recompute.  bf16 keeps fp32's exponent range, so no loss scaling is
required (the reference's fp16 path needed it).
"""


def enable(program=None):
    """Mark `program` (default: the main program) for bf16 execution."""
    from ..core import framework

    program = program or framework.default_main_program()
    program._amp = True
    program._version += 1      # invalidate the seams' memos
    return program


def disable(program=None):
    from ..core import framework

    program = program or framework.default_main_program()
    program._amp = False
    program._version += 1
    return program


class Float16Transpiler:
    """Reference-surface parity shim (float16_transpiler.py:Float16
    Transpiler.transpile): the dtype is bfloat16 and the rewrite is a
    run-time cast policy rather than desc surgery."""

    def transpile(self, program, place=None, scope=None):
        enable(program)
