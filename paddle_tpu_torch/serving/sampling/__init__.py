"""paddle_tpu_torch.serving.sampling — the decode tier's request-control
surface (port of ``paddle_tpu.serving.sampling``).

Everything between "the step function produced a ``[slots, vocab]`` logits
plane" and "this token is committed for that request" lives here:

- ``SamplingConfig`` (config.py): the per-request knobs — temperature /
  top-k / top-p / seed / logit_bias / constraint — validated AT SUBMIT with
  a named error (``SamplingConfigError``), so one tenant's bad config never
  becomes an opaque mid-decode step failure for every slot-mate.
- ``SlotSampler`` (sampler.py): packs heterogeneous configs into per-slot
  parameter ROWS (temperature/top-k/top-p/seed/counter vectors + the
  ``[slots, vocab]`` bias plane) and draws through ONE shared sampler —
  different sampling params per slot, one step shape, whatever the mix.
- ``TokenDFA`` / ``ConstraintError`` (constrain.py): the pluggable
  grammar mask stepper — a host-side token-mask plane rewritten at each
  token boundary; masked logits go to ``-inf`` before the draw, so
  constrained outputs always parse.

The in-graph math (warp + seeded categorical, stream tags) is
``paddle_tpu_torch.ops.sampling_kernels``; the adjusted speculative
acceptance rule that preserves these distributions is
``paddle_tpu_torch.serving.kv.speculative.accept_drafts_sampled``.
"""

from .config import GREEDY, SamplingConfig, SamplingConfigError  # noqa: F401
from .constrain import (ConstraintError, TokenDFA,  # noqa: F401
                        json_list_dfa)
from .sampler import SlotSampler, bias_row_for  # noqa: F401

__all__ = [
    "SamplingConfig", "SamplingConfigError", "GREEDY",
    "ConstraintError", "TokenDFA", "json_list_dfa",
    "SlotSampler", "bias_row_for",
]
