"""Host-span profiler surface (port of ``paddle_tpu/profiler.py``, the
parts the serving path records through).

Reference: ``paddle/fluid/platform/profiler.h:41`` RecordEvent host
events.  :func:`record_event` annotates a ``torch.profiler`` trace (where
the reference annotated the XLA trace) and records a host span;
:func:`record_span` records an externally timed span.  Spans land in a
bounded process-wide buffer that :func:`event_totals` aggregates and that
span sinks (the request tracer, ``observability/trace.py``) observe.
"""

import collections
import contextlib
import time

import torch

# host spans bounded like the reference's event buffers (profiler.h
# blocks of kEventBlockSize) — a serving loop can't grow them unboundedly
_MAX_EVENTS = 100000
_events = collections.deque(maxlen=_MAX_EVENTS)
_span_sinks = []

# named scopes the serving engine wraps its phases in (serving/engine.py)
SERVING_SCOPES = ("serving/queue", "serving/pad", "serving/compile",
                  "serving/execute")


def add_span_sink(fn):
    """Register ``fn(name, t0, t1)`` to observe every recorded span
    (idempotent).  Sinks must be cheap and must never raise."""
    if fn not in _span_sinks:
        _span_sinks.append(fn)
    return fn


def _emit(name, t0, t1):
    _events.append((name, t0, t1))
    for sink in _span_sinks:
        try:
            sink(name, t0, t1)
        except Exception:            # noqa: BLE001 telemetry must never
            pass                     # break the instrumented path


@contextlib.contextmanager
def record_event(name):
    """RecordEvent analogue (profiler.h:41): a ``torch.profiler`` range
    plus a host-side span."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    _emit(name, t0, time.perf_counter())


def record_span(name, t0, t1):
    """Record an externally timed host span (``time.perf_counter``
    endpoints), for phases that can't live in one ``with`` block — e.g.
    serving queue time, which starts in the submitting thread and ends in
    the worker."""
    _emit(name, t0, t1)


def event_totals():
    """Aggregate recorded host spans: name -> {calls, total_ms}."""
    agg = {}
    for name, t0, t1 in list(_events):
        e = agg.setdefault(name, {"calls": 0, "total_ms": 0.0})
        e["calls"] += 1
        e["total_ms"] += (t1 - t0) * 1000.0
    for e in agg.values():
        e["total_ms"] = round(e["total_ms"], 3)
    return agg


def export_chrome_tracing(path, events=None):
    """Dump recorded host spans (or pre-built Chrome event dicts) as a
    chrome://tracing / Perfetto JSON file."""
    import json

    if events is None:
        events = [{"name": name, "ph": "X", "cat": "host", "ts": t0 * 1e6,
                   "dur": (t1 - t0) * 1e6, "pid": 0, "tid": 0}
                  for name, t0, t1 in list(_events)]
    with open(path, "w") as f:
        json.dump({"traceEvents": list(events), "displayTimeUnit": "ms"}, f)
    return path


from .observability.registry import REGISTRY as _REGISTRY  # noqa: E402

_REGISTRY.register("profiler", event_totals)
