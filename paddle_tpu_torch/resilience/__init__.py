"""paddle_tpu_torch.resilience — the part of the JAX package's
``resilience/`` the RPC tier stands on: the per-endpoint circuit breaker
(``breaker``) and the process-wide counters it and the RPC client bump
(retries, breaker trips).  Step guards, preemption and fault plans are
queued with the runtime services (ROADMAP queue 1 item 12).
"""

import collections
import threading


class ResilienceMetrics:
    """Thread-safe resilience counters (retries, breaker_trips, ...).
    Components share :data:`GLOBAL_METRICS` by default so one
    ``snapshot()`` shows the whole process; tests inject fresh ones."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c = collections.Counter()

    def inc(self, name, n=1):
        with self._lock:
            self._c[name] += n

    def get(self, name):
        with self._lock:
            return self._c[name]

    def snapshot(self):
        with self._lock:
            return dict(self._c)

    def reset(self):
        with self._lock:
            self._c.clear()


GLOBAL_METRICS = ResilienceMetrics()

from ..observability.registry import REGISTRY as _REGISTRY  # noqa: E402

_REGISTRY.register("resilience", GLOBAL_METRICS.snapshot)
