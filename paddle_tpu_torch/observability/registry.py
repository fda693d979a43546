"""MetricsRegistry: one ``snapshot()`` over every metrics silo.

Eight subsystems grew their own metrics objects PR by PR — serving
engines, the fleet router, the sparse engine, resilience counters,
jitcache counters, checkpoint writers, dataio pipelines, and the
profiler's scope aggregates.  Each keeps its exact per-subsystem
``snapshot()``/``stats()``/``export()`` shape (callers and tests pin
them); what this registry adds is the MLIR-per-dialect-verifier
discipline applied to telemetry: every silo registers a named
*provider* (a zero-arg callable returning its snapshot dict), and one
``REGISTRY.snapshot()`` returns them all, exportable as JSON or
Prometheus text and servable to any rank over the ``metrics_pull`` RPC.

Two registration styles:

- ``register(name, provider)`` — process-global singletons
  (``resilience.GLOBAL_METRICS``, ``jitcache.METRICS``,
  ``sparse.METRICS``, the profiler's ``event_totals``).
- ``attach(kind, obj)`` — per-instance silos (each ServingMetrics /
  FleetMetrics / CheckpointMetrics / DataioMetrics).  Held by WEAK
  reference under ``"<kind>/<n>"`` and pruned when the owner dies, so
  a test suite constructing hundreds of engines never leaks providers.

Typed instruments (``counter``/``gauge``/``histogram``) cover NEW
metrics that don't belong to any silo; they export under the
``"registry"`` provider name.

Import-light: no jax, no numpy (tools/postmortem.py loads this file's
package in a bare interpreter).
"""

import json
import threading
import weakref

from .hist import Counter, Gauge, LockedHistogram


def _flatten(prefix, node, out):
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten(prefix + (str(k),), node[k], out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(prefix + (str(i),), v, out)
    elif isinstance(node, bool):
        out["/".join(prefix)] = int(node)
    elif isinstance(node, (int, float)):
        out["/".join(prefix)] = node
    # strings and None are dropped: flatten() is the numeric face


def _prom_name(path):
    """Mangle a flattened path into a legal Prometheus metric name."""
    safe = "".join(c if c.isalnum() else "_" for c in path)
    if safe and safe[0].isdigit():
        safe = "_" + safe
    return "paddle_tpu_" + safe


def prometheus_text(flat, help_for=None):
    """Flat ``{path: number}`` -> Prometheus exposition text: NaN/inf
    leaves filtered, one ``# TYPE <name> gauge`` per metric, optional
    ``# HELP`` via ``help_for(path)``.  The ONE exposition formatter —
    ``MetricsRegistry.export_prometheus`` and ``telemetry_dump.py``'s
    merged-totals output both emit through it."""
    lines = []
    for path in sorted(flat):
        v = flat[path]
        if v != v or v in (float("inf"), float("-inf")):
            continue                 # NaN/inf leaves (empty histograms)
        name = _prom_name(path)
        if help_for is not None:
            help_text = help_for(path)
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {v:g}")
    return "\n".join(lines) + "\n"


class MetricsRegistry:
    """Named snapshot providers + typed instruments; see module doc."""

    def __init__(self):
        self._lock = threading.Lock()
        self._providers = {}     # name -> zero-arg callable -> dict
        self._instances = {}     # name -> (weakref, method name)
        self._next_idx = {}      # kind -> next attach index
        self._counters = {}
        self._gauges = {}
        self._hists = {}
        self._descriptions = {}  # instrument name -> HELP text

    # -- registration -------------------------------------------------------

    def register(self, name, provider):
        """Register (or replace) a named snapshot provider — a zero-arg
        callable returning a plain dict."""
        with self._lock:
            self._providers[name] = provider
        return name

    def unregister(self, name):
        with self._lock:
            self._providers.pop(name, None)
            self._instances.pop(name, None)

    def attach(self, kind, obj, method="snapshot"):
        """Register a live metrics OBJECT under ``"<kind>/<n>"`` by weak
        reference; the provider disappears when the object is
        collected.  Returns the assigned name."""
        with self._lock:
            i = self._next_idx.get(kind, 0)
            self._next_idx[kind] = i + 1
            name = f"{kind}/{i}"
            self._instances[name] = (weakref.ref(obj), method)
        return name

    # -- typed instruments --------------------------------------------------

    def counter(self, name, description=None):
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            if description:
                self._descriptions[name] = str(description)
            return c

    def gauge(self, name, description=None):
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            if description:
                self._descriptions[name] = str(description)
            return g

    def histogram(self, name, bounds=None, description=None):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LockedHistogram(
                    *((bounds,) if bounds is not None else ()))
            if description:
                self._descriptions[name] = str(description)
            return h

    def _instruments_snapshot(self):
        return {
            "counters": {n: c.value for n, c in self._counters.items()},
            "gauges": {n: g.value for n, g in self._gauges.items()},
            "histograms": {n: h.as_dict() for n, h in self._hists.items()},
        }

    # -- export -------------------------------------------------------------

    def snapshot(self):
        """One dict carrying every registered silo: ``{provider name:
        provider snapshot}``.  A provider that raises is reported as
        ``{"error": ...}`` instead of killing the export — telemetry
        must never be the thing that takes a trainer down."""
        with self._lock:
            providers = dict(self._providers)
            instances = list(self._instances.items())
            has_instruments = bool(self._counters or self._gauges or
                                   self._hists)
        out = {}
        if has_instruments:
            with self._lock:
                out["registry"] = self._instruments_snapshot()
        for name, fn in sorted(providers.items()):
            try:
                out[name] = fn()
            except Exception as e:      # noqa: BLE001 never kill export
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        dead = []
        for name, (ref, method) in instances:
            obj = ref()
            if obj is None:
                dead.append(name)
                continue
            try:
                out[name] = getattr(obj, method)()
            except Exception as e:      # noqa: BLE001
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        if dead:
            with self._lock:
                for name in dead:
                    self._instances.pop(name, None)
        return out

    def flatten(self, snap=None):
        """``snapshot()`` flattened to ``{"a/b/c": number}`` — the
        delta/merge face (flight-recorder metric deltas, multi-host
        ``merge_snapshots`` totals)."""
        out = {}
        _flatten((), snap if snap is not None else self.snapshot(), out)
        return out

    def export_json(self, snap=None):
        return json.dumps(snap if snap is not None else self.snapshot(),
                          sort_keys=True, default=str)

    @staticmethod
    def _help_for(path, descriptions):
        """The HELP text for a flattened path, when it belongs to a
        DESCRIBED typed instrument (counters/gauges export under their
        exact path; a histogram's description covers every leaf)."""
        if not descriptions or not path.startswith("registry/"):
            return None
        for kind in ("counters/", "gauges/"):
            if path.startswith("registry/" + kind):
                return descriptions.get(path[9 + len(kind):])
        if path.startswith("registry/histograms/"):
            rest = path[len("registry/histograms/"):]
            name = rest.rsplit("/", 1)[0]
            return descriptions.get(name)
        return None

    def export_prometheus(self, snap=None):
        """Prometheus text exposition: one gauge line per numeric leaf
        of the flattened snapshot, names mangled to the legal charset
        (``serving/0/counters/submitted`` ->
        ``paddle_tpu_serving_0_counters_submitted``).  Every metric
        line is preceded by a ``# TYPE <name> gauge`` declaration
        (strict scrapers flag untyped metrics) and, for typed
        instruments registered with a description, a ``# HELP`` line;
        the metric lines themselves are byte-identical to the
        pre-TYPE format (pinned by test).  The registry lock covers
        only the descriptions copy — a scrape formatting thousands of
        lines must not block concurrent instrument registration."""
        flat = self.flatten(snap)
        with self._lock:
            descs = dict(self._descriptions)
        return prometheus_text(
            flat, help_for=lambda p: self._help_for(p, descs))

REGISTRY = MetricsRegistry()
