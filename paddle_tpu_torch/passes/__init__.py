"""paddle_tpu_torch.passes — the IR pass pipeline between ProgramDesc and
execution (a copy of ``paddle_tpu/passes``; it imports nothing of that
package).

The transform layer of the IR pass pipeline (reference: the
``BuildStrategy``/``ir::Pass`` stack, PAPER.md §L4; design discipline
from MLIR's per-pass verifier, arXiv:2002.11054, and TASO's verified
substitutions, SOSP'19).  Each pass is a pure, deterministic
``Program -> Program`` function over the :mod:`paddle_tpu_torch.analysis`
queries; the :class:`PassManager` runs an ordered list of them at
every compile seam with the static verifier as an invariant gate
between passes.

Shipped passes (``FLAGS_pass_pipeline=default`` order):

========================  ==================================================
``cse``                   common-subexpression elimination over pure ops
``dce``                   dead op / dead output-slot / dead declaration
                          removal (the eager-deletion gap, graph-level)
``isolate_updates``       optimizer-update fusion-boundary placement
                          (a TPU-era fix, generalized to any program)
``isolate_epilogues``     pin reduction/cast epilogues (bias-grad
                          column sums, wgrad-consuming casts) behind
                          ``optimization_barrier`` so producing
                          matmuls stay clean MXU fusions (annotates
                          ``__isolate__`` attrs)
``amp_propagate``         dataflow black/white bf16 propagation with
                          fp32 islands (annotates ``__amp__`` attrs)
``quantize_weights``      per-channel int8/fp8 weight quantization for
                          inference (annotates ``__quant__`` attrs +
                          ``<w>@QSCALE`` scale vars; scales computed
                          at load/swap time, never on the hot path;
                          identity unless ``program._quant`` is set)
``auto_shard``            SpecLayout-style canonical PartitionSpecs per
                          parameter role under a model-axis mesh
========================  ==================================================

The JAX package's opt-in memory-planning passes (``remat``,
``eager_deletion``, ``plan_donation``) need ``memplan/`` and are not
ported: ``resolve_pipeline`` raises on a spec that names them.

Identity contract: a pass with nothing to do returns the input Program
OBJECT; a pass that changes something returns a clone.  The pipeline is
deterministic and idempotent (pipeline∘pipeline = pipeline), and it
gives the JAX package's program op for op (tests/test_torch_passes.py).
"""

from .base import (PASSES, PassContext,           # noqa: F401
                   PassVerificationError, program_pass)
from . import (dce, cse, fusion, epilogue, amp,    # noqa: F401
               quantize, sharding)
from .amp import AMP_ATTR                          # noqa: F401
from .epilogue import ISOLATE_ATTR                 # noqa: F401
from .quantize import QUANT_ATTR                   # noqa: F401
from .manager import (METRICS, PRESETS,            # noqa: F401
                      PassManager, PipelineReport, apply_at_seam,
                      report_for, resolve_pipeline)
