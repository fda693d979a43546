"""Fleet-tier metrics: per-SLA-class latency/outcome accounting plus
router dispatch counters, and the continuous-decode engine's silo.

Same discipline as ``serving.metrics.ServingMetrics``: plain counters
and fixed-boundary histograms behind one lock, ``snapshot()`` exports a
pickleable dict.  The per-class block is the acceptance surface — the
heavy-traffic replay asserts ``classes["high"]["dropped"] == 0`` while a
replica is dead, and reads the per-class p50/p99 straight out of the
export.  :class:`DecodeMetrics` is the same contract for
``ContinuousBatchingEngine`` (occupancy/step histograms, scheduler
outcome counters, the paged-KV and speculative-decode counters the paged pool
added), attached to the observability registry as ``decode/<n>`` so
``registry.snapshot()`` carries decode occupancy next to everything
else.
"""

import collections
import threading

from ..metrics import Histogram

# one request's terminal outcomes, per class.  "dropped" is the derived
# headline: everything that did NOT complete successfully — shed at any
# admission point, expired, failed, cancelled.
_CLASS_COUNTERS = ("submitted", "completed", "failed", "shed_admission",
                   "shed_no_replica", "expired", "cancelled")


# one decode scheduler's terminal/throughput accounting.  The spec
# block derives accept_rate = draft tokens the target agreed with /
# drafts proposed — the headline speculative-decode health signal.
_DECODE_COUNTERS = (
    "submitted", "completed", "expired", "shed_overloaded",
    "shed_preempted", "cancelled", "steps", "tokens_generated",
    "admitted_midflight", "failed",
    # paged-KV scheduling: sequences bounced back to the
    # queue because the block pool ran dry mid-decode (their generated
    # tokens ride along as the re-queued prompt — work is preserved)
    "preempted_for_blocks",
    # speculative decode: rounds = verify calls (ONE target step
    # each), draft_steps = draft-model calls, draft_tokens = proposals,
    # draft_accepted = proposals the target agreed with
    "spec_rounds", "draft_steps", "draft_tokens", "draft_accepted",
    # sampling: tokens committed on non-plain-greedy slots,
    # tokens committed under a constraint mask, and speculative rounds
    # that ended in an adjusted-acceptance residual resample
    "sampled_tokens", "constrained_tokens", "residual_resamples",
    # elastic serving: sequences handed off by a draining
    # engine (extract_sequences) and sequences admitted with a resumed
    # (sample_counter, constraint_state) checkpoint from another
    # replica — the migration ledger both sides of a drain audit
    "migrated_out", "migrated_in",
)


class DecodeMetrics:
    """ContinuousBatchingEngine's silo: counters + occupancy/step-time
    histograms behind one lock, registry-attached (``decode/<n>``)."""

    def __init__(self, slots):
        self._lock = threading.Lock()
        self._c = dict.fromkeys(_DECODE_COUNTERS, 0)
        self._occupancy = Histogram(bounds=tuple(range(1, slots + 1)))
        self._step_ms = Histogram()
        self._class_done = collections.Counter()
        from ...observability import REGISTRY

        REGISTRY.attach("decode", self)

    def inc(self, name, n=1):
        with self._lock:
            self._c[name] += n

    def inc_class(self, sla):
        with self._lock:
            self._class_done[sla] += 1

    def observe_step(self, active, step_ms):
        with self._lock:
            self._c["steps"] += 1
            self._occupancy.observe(active)
            self._step_ms.observe(step_ms)

    def get(self, name):
        with self._lock:
            return self._c[name]

    def snapshot(self):
        with self._lock:
            c = dict(self._c)
            occ = self._occupancy.as_dict()
            step = self._step_ms.as_dict()
            cls_done = dict(self._class_done)
        spec = {
            "rounds": c["spec_rounds"],
            "draft_steps": c["draft_steps"],
            "draft_tokens": c["draft_tokens"],
            "draft_accepted": c["draft_accepted"],
            "accept_rate": round(
                c["draft_accepted"] / c["draft_tokens"], 4)
            if c["draft_tokens"] else None,
        }
        return {"counters": c, "occupancy": occ, "step_ms": step,
                "completed_by_class": cls_done, "speculative": spec}


class FleetMetrics:
    """Router + per-class counters; all mutators take the lock."""

    def __init__(self, class_names=("high", "batch")):
        self._lock = threading.Lock()
        self._class_names = tuple(class_names)
        self.reset()
        from ...observability import REGISTRY

        REGISTRY.attach("fleet", self)

    def reset(self):
        with self._lock:
            self._classes = {
                n: {"counters": dict.fromkeys(_CLASS_COUNTERS, 0),
                    "latency": Histogram()}
                for n in self._class_names}
            self._c = {
                # dispatch-level accounting
                "routed": 0,            # requests placed on a replica
                "failovers": 0,         # dispatch retried on a sibling
                "dispatch_errors": 0,   # replica refused/errored a
                                        # dispatch (breaker food)
                "replica_unroutable": 0,  # skipped: breaker open
                "model_swaps": 0,       # hot weight swaps applied
            }

    def _cls(self, sla):
        # unknown labels get a lazily-added block rather than a KeyError
        # — metrics must never be the thing that kills a dispatch
        block = self._classes.get(sla)
        if block is None:
            block = {"counters": dict.fromkeys(_CLASS_COUNTERS, 0),
                     "latency": Histogram()}
            self._classes[sla] = block
        return block

    def inc(self, name, n=1):
        with self._lock:
            self._c[name] += n

    def inc_class(self, sla, name, n=1):
        with self._lock:
            self._cls(sla)["counters"][name] += n

    def observe_latency(self, sla, ms, exemplar=None):
        """Per-class end-to-end latency; ``exemplar`` (a trace_id) is
        attached to the bucket the observation lands in — the
        histogram-to-trace bridge (None when the request was
        unsampled: the export shape is then byte-identical to the
        pre-tracing one)."""
        with self._lock:
            self._cls(sla)["latency"].observe(ms, exemplar)

    def get_class(self, sla, name):
        with self._lock:
            return self._cls(sla)["counters"][name]

    def latency_buckets(self, sla):
        """Raw CUMULATIVE bucket counts of one class's latency
        histogram — the windowed-percentile face: diff two reads and
        compute a percentile over the delta counts (the autoscaler's
        rollback signal needs p99 over *the traffic since the scaling
        action*, which the cumulative ``as_dict`` p99 cannot give)."""
        with self._lock:
            h = self._cls(sla)["latency"]
            return {"bounds": list(h.bounds), "counts": list(h.counts),
                    "count": h.count, "max": h.max}

    def export(self):
        """Combined one-lock export: dispatch counters, per-class
        outcome counters, AND every class's raw cumulative latency
        buckets — all copied under ONE lock acquisition.  This is the
        tuner's read face: judging a config change needs a latency
        histogram and the counters from the same instant, and the
        separate ``snapshot()`` + ``latency_buckets()`` calls could
        interleave an update between them (a torn pair — the
        observation lands in one read but not the other)."""
        with self._lock:
            classes = {}
            for n, block in self._classes.items():
                c = dict(block["counters"])
                c["dropped"] = (c["failed"] + c["shed_admission"] +
                                c["shed_no_replica"] + c["expired"] +
                                c["cancelled"])
                h = block["latency"]
                classes[n] = {
                    "counters": c,
                    "latency": {"bounds": list(h.bounds),
                                "counts": list(h.counts),
                                "count": h.count, "max": h.max},
                }
            return {"counters": dict(self._c), "classes": classes}

    def snapshot(self):
        with self._lock:
            classes = {}
            for n, block in self._classes.items():
                c = dict(block["counters"])
                c["dropped"] = (c["failed"] + c["shed_admission"] +
                                c["shed_no_replica"] + c["expired"] +
                                c["cancelled"])
                classes[n] = {"counters": c,
                              "latency_ms": block["latency"].as_dict()}
                ex = block["latency"].exemplars_dict()
                if ex:
                    # only present when tracing attached one: with
                    # tracing off the snapshot shape is byte-identical
                    # to the pre-tracing export (pinned by test)
                    classes[n]["exemplars"] = ex
            return {"counters": dict(self._c), "classes": classes}
