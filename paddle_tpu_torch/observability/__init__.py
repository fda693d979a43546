"""paddle_tpu_torch.observability — the telemetry pieces the serving path
records through (a subset of the JAX package's plane):

- **hist**: the shared :class:`Histogram` ``serving.metrics`` re-exports;
- **registry**: :data:`REGISTRY`, one ``snapshot()`` over every live
  engine's metrics and the profiler's scope aggregates;
- **trace**: :data:`TRACER`, the sampling request tracer the batcher and
  engine attach spans to (off at the default ``FLAGS_trace_sample_rate``
  of 0).
"""

from .hist import (Counter, DEFAULT_BOUNDS_MS, Gauge,  # noqa: F401
                   Histogram)
from .registry import REGISTRY, MetricsRegistry        # noqa: F401
from . import trace                                    # noqa: F401
from .trace import TRACER, Span, TraceContext          # noqa: F401

REGISTRY.register("trace", TRACER.snapshot)
