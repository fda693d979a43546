"""paddle_tpu_torch.analysis — static analyses over the Program IR (a
copy of ``paddle_tpu/analysis``; it imports nothing of that package).

The analysis layer of the IR pass pipeline (ROADMAP item 5, the
reference's ``BuildStrategy``/``ir::Pass`` surface, PAPER.md §L4):

- :mod:`dataflow` — def-use / SSA view, cross-sub-block resolution,
  topological order, liveness intervals, dead-var sets
- :mod:`shapes`  — static shape & dtype inference through a per-op
  registry (unknown ops infer ⊤ and are reported, never crash)
- :mod:`verifier` — a severity-tagged rule registry over the analyses,
  wired to ``FLAGS_validate_program`` at every compile seam

Everything here is a PURE QUERY: no IR mutation, no version bumps —
program hint fingerprints (and therefore jitcache keys) are
byte-identical before and after running any analysis.  Transform
passes (eager deletion, memory planning, auto-sharding inference) are
written AGAINST these queries, not into them.
"""

from . import dataflow, shapes, verifier                  # noqa: F401
from .dataflow import build as build_dataflow             # noqa: F401
from .shapes import infer as infer_shapes                 # noqa: F401
from .verifier import (Finding, ProgramVerificationError,  # noqa: F401
                       RULES, validate_at_seam, verify_program)
