"""Serving metrics: latency histograms (queue vs. compute), batch
occupancy, padding waste, executable-cache accounting, and error
counters.

Everything is plain Python counters behind one lock — `snapshot()`
returns a pickleable dict, the contract every later exporter (Prometheus
text, the C++ runtime's stats RPC) builds on.  The engine also wraps its
phases in `profiler.record_event` scopes (see `profiler.SERVING_SCOPES`)
so an active profiler trace shows the same breakdown on the timeline.
"""

import threading

# The histogram moved to the unified telemetry plane (ISSUE 11):
# serving owned the original copy, fleet/sparse imported it from here,
# checkpoint reimplemented percentiles by hand.  These re-exports keep
# every existing import path (`from ..serving.metrics import
# Histogram`) and as_dict() shape byte-identical.
from ..observability.hist import DEFAULT_BOUNDS_MS, Histogram  # noqa: F401


class ServingMetrics:
    """One engine's counters; all mutators take the internal lock.
    Registered (weakly) into ``observability.REGISTRY`` as a
    ``serving/<n>`` provider — one registry snapshot carries every live
    engine without changing this class's own ``snapshot()`` shape."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()
        from ..observability import REGISTRY

        REGISTRY.attach("serving", self)

    def reset(self):
        """Zero every histogram and counter (e.g. after warm-up, so
        steady-state percentiles aren't contaminated by compiles)."""
        with self._lock:
            self.queue_ms = Histogram()    # submit -> batch exec start
            self.compute_ms = Histogram()  # device execution, blocked
            self.latency_ms = Histogram()  # submit -> result set
            self.batch_rows = Histogram(
                bounds=(1, 2, 4, 8, 16, 32, 64, 128))
            self._c = {
                "submitted": 0, "completed": 0, "failed": 0,
                "shed_overloaded": 0, "shed_preempted": 0,
                "expired": 0, "cancelled": 0,
                "batches_executed": 0, "retries": 0,
                "rows_real": 0, "rows_padded": 0,
                "cache_hits": 0, "cache_misses": 0, "cache_evictions": 0,
                "weight_reloads": 0,
                # degrade mode (resilience breaker): batches over the
                # degrade_slow_ms bound, and submits shed while open
                "slow_batches": 0, "shed_degraded": 0,
                # bucket-grid executables materialized by warmup()
                "warmup_built": 0,
                # autotune warm-swaps applied and the executables
                # their build-before-swap phase materialized
                "tuning_applied": 0, "tuning_built": 0,
            }

    def inc(self, name, n=1):
        with self._lock:
            self._c[name] += n

    def get(self, name):
        with self._lock:
            return self._c[name]

    def observe_queue(self, ms):
        with self._lock:
            self.queue_ms.observe(ms)

    def observe_latency(self, ms):
        with self._lock:
            self.latency_ms.observe(ms)

    def observe_batch(self, real_rows, padded_rows, compute_ms):
        with self._lock:
            self._c["batches_executed"] += 1
            self._c["rows_real"] += real_rows
            self._c["rows_padded"] += padded_rows
            self.batch_rows.observe(real_rows)
            self.compute_ms.observe(compute_ms)

    def rows_buckets(self):
        """Raw cumulative bucket counts of the batch_rows histogram —
        the online tuner's bucket-insert signal (it quantiles over the
        request row-count distribution, which the percentile summary
        in ``snapshot()`` can't give)."""
        with self._lock:
            h = self.batch_rows
            return {"bounds": list(h.bounds), "counts": list(h.counts),
                    "count": h.count, "max": h.max}

    def snapshot(self):
        """Plain-dict export.  padding_waste = fraction of executed rows
        that were padding; batch_occupancy = mean real rows per batch."""
        with self._lock:
            c = dict(self._c)
            nb = c["batches_executed"]
            padded = c["rows_padded"]
            out = {
                "counters": c,
                "queue_ms": self.queue_ms.as_dict(),
                "compute_ms": self.compute_ms.as_dict(),
                "latency_ms": self.latency_ms.as_dict(),
                "batch_rows": self.batch_rows.as_dict(),
                "batch_occupancy": round(c["rows_real"] / nb, 3)
                if nb else 0.0,
                "padding_waste": round(1.0 - c["rows_real"] / padded, 4)
                if padded else 0.0,
            }
        # profiler integration: surface the serving/* scope aggregates.
        # NOTE these come from the PROCESS-GLOBAL profiler event buffer
        # (a bounded deque) — they span every engine in the process and
        # roll over on long runs, hence the explicit _process suffix;
        # per-engine truth lives in the counters above
        try:
            from .. import profiler
            scopes = {n: t for n, t in profiler.event_totals().items()
                      if n.startswith("serving/")}
            if scopes:
                out["profiler_scopes_process"] = scopes
        except Exception:
            pass
        return out
