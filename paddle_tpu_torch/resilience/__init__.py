"""paddle_tpu_torch.resilience — the part of the JAX package's
``resilience/`` the RPC and fleet tiers stand on: the per-endpoint
circuit breaker (``breaker``), the process-wide counters it and the RPC
client bump (retries, breaker trips), and deterministic fault injection
(``faults``: :class:`FaultPlan` over the transport's fault hook and the
replicas' dispatch seam).  Step guards and preemption are queued with
the runtime services (ROADMAP queue 1 item 12).
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

_LAZY = {
    "CircuitBreaker": ("breaker", "CircuitBreaker"),
    "CircuitOpenError": ("breaker", "CircuitOpenError"),
    "FaultPlan": ("faults", "FaultPlan"),
    "FaultRule": ("faults", "FaultRule"),
}

__all__ = sorted(["ResilienceMetrics", "GLOBAL_METRICS"] + list(_LAZY))


def __getattr__(name):                   # PEP 562 lazy re-exports
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(f".{mod}", __name__),
                       attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
