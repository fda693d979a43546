"""The ONE histogram implementation (plus typed Counter/Gauge).

Before ISSUE 11 three subsystems hand-copied this class
(``serving/metrics.py`` owned it, ``serving/fleet/metrics.py`` and
``sparse/metrics.py`` imported the serving copy) and two more
(``checkpoint/writer.py``, resilience) reimplemented ad-hoc percentile
lists or bare Counters.  It now lives here; ``serving.metrics``
re-exports ``Histogram``/``DEFAULT_BOUNDS_MS`` unchanged so every
existing import path and every ``as_dict()`` consumer keeps working.

Import-light on purpose: no jax, no numpy — the postmortem tooling and
the registry must load in a bare interpreter.
"""

import bisect
import threading

# log-spaced ms boundaries: sub-ms dispatch overheads through multi-second
# queue stalls land in distinct buckets
DEFAULT_BOUNDS_MS = (0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                     100.0, 200.0, 500.0, 1000.0, 2000.0, 5000.0, 10000.0)


class Histogram:
    """Fixed-boundary histogram with approximate percentiles.

    Not thread-safe on its own; owners (ServingMetrics, the registry's
    instrument table, ...) serialize access.
    """

    def __init__(self, bounds=DEFAULT_BOUNDS_MS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self.exemplars = {}          # bucket idx -> {"trace_id","value"}

    def observe(self, v, exemplar=None):
        """Record one observation.  ``exemplar`` (a trace_id string —
        OpenMetrics exemplar semantics) is remembered per BUCKET,
        last-writer-wins, so a latency histogram can answer "show me a
        trace that landed in the 200ms bucket".  ``as_dict()`` is
        untouched (its shape is pinned by every exporter); exemplars
        export via :meth:`exemplars_dict`."""
        v = float(v)
        idx = bisect.bisect_left(self.bounds, v)
        self.counts[idx] += 1
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if exemplar is not None:
            # value kept as a STRING on purpose: exemplar payloads must
            # never add numeric leaves the flatten/merge faces would
            # sum into cross-rank totals
            self.exemplars[idx] = {"trace_id": str(exemplar),
                                   "value": f"{v:.3f}"}

    def exemplars_dict(self):
        """{upper-bound-as-str: {"trace_id", "value"}} for buckets that
        hold an exemplar; empty when tracing never attached one."""
        out = {}
        for idx in sorted(self.exemplars):
            bound = str(self.bounds[idx]) if idx < len(self.bounds) \
                else "+Inf"
            out[bound] = dict(self.exemplars[idx])
        return out

    def percentile(self, p):
        """Approximate p-quantile (0 < p <= 100): the upper edge of the
        bucket holding the p-th observation, clamped to the observed
        min/max so tails don't report a bucket bound no sample reached."""
        if self.count == 0:
            return 0.0
        rank = max(1, int(round(self.count * p / 100.0)))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                edge = self.bounds[i] if i < len(self.bounds) else self.max
                return min(max(edge, self.min), self.max)
        return self.max

    def as_dict(self):
        return {"count": self.count,
                "sum": round(self.total, 3),
                "min": round(self.min, 3) if self.count else 0.0,
                "max": round(self.max, 3),
                "avg": round(self.total / self.count, 3)
                if self.count else 0.0,
                "p50": round(self.percentile(50), 3),
                "p99": round(self.percentile(99), 3)}


class Counter:
    """Monotonic counter (thread-safe).  ``value`` is the export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0

    def inc(self, n=1):
        with self._lock:
            self._v += n

    @property
    def value(self):
        with self._lock:
            return self._v


class Gauge:
    """Last-write-wins value (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v):
        with self._lock:
            self._v = float(v)

    @property
    def value(self):
        with self._lock:
            return self._v


class LockedHistogram(Histogram):
    """Histogram with its own lock — the registry's instrument flavor,
    for call sites that don't already own a metrics lock."""

    def __init__(self, bounds=DEFAULT_BOUNDS_MS):
        super().__init__(bounds)
        self._lock = threading.Lock()

    def observe(self, v, exemplar=None):
        with self._lock:
            super().observe(v, exemplar)

    def as_dict(self):
        with self._lock:
            return super().as_dict()

    def exemplars_dict(self):
        with self._lock:
            return super().exemplars_dict()
