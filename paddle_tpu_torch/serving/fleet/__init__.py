"""paddle_tpu_torch.serving.fleet — continuous-batching decode (port of
``paddle_tpu.serving.fleet``, the parts a single engine stands on).

:class:`ContinuousBatchingEngine` schedules autoregressive decode at
token boundaries over a fixed-shape slot pool (Orca-style iteration-
level batching, one step shape as occupancy churns), optionally over
the paged KV pool (``ContinuousConfig(kv=PagedKVConfig(...))``) and with
a speculative draft/verify arm; :func:`make_program_step_fn` and
:func:`make_program_verify_fn` adapt a fluid inference program (the NMT
decoder) onto its step contract.

    step = fleet.make_program_step_fn(exe, infer_prog, predict,
                                      feed_builder)
    eng = fleet.ContinuousBatchingEngine(step, fleet.ContinuousConfig(
        slots=8, max_len=64, kv=fleet.PagedKVConfig(block_size=16)))
    toks = eng.submit(prompt, context={"src": src},
                      max_new_tokens=24).result(30)
    eng.stop()

The multi-replica tier of the reference (``FleetRouter``, ``Replica``)
is not ported yet.
"""

from ..kv import (KVBlockPool, PagedKVConfig,  # noqa: F401
                  PoolExhausted, SpeculativeConfig)
from ..sampling import (SamplingConfig,  # noqa: F401
                        SamplingConfigError, TokenDFA)
from .admission import (AdmissionPolicy, SlaClass,  # noqa: F401
                        DEFAULT_CLASSES, default_classes)
from .continuous import (ContinuousBatchingEngine,  # noqa: F401
                         ContinuousConfig, DecodeRequest,
                         EngineDraining, lockstep_decode,
                         make_program_step_fn, make_program_verify_fn)
from .metrics import DecodeMetrics, FleetMetrics  # noqa: F401

__all__ = [
    "AdmissionPolicy", "SlaClass", "DEFAULT_CLASSES", "default_classes",
    "ContinuousBatchingEngine", "ContinuousConfig", "DecodeRequest",
    "EngineDraining",
    "lockstep_decode", "make_program_step_fn", "make_program_verify_fn",
    "DecodeMetrics", "FleetMetrics", "KVBlockPool", "PagedKVConfig",
    "PoolExhausted", "SpeculativeConfig",
    "SamplingConfig", "SamplingConfigError", "TokenDFA",
]
