"""FleetRouter: least-outstanding-work dispatch over N replicas (port of
``paddle_tpu/serving/fleet/router.py``, a copy: host Python).

The Clipper-shaped tier above the single-process ``ServingEngine``:
clients talk to the router, the router owns replica health and SLA
admission, and model internals stay entirely below it (it never sees a
tensor shape or an executable — that is the replica/engine's business).

Dispatch discipline per submit:

1. **admission** — resolve the SLA class; shed at the door (typed
   ``ServerOverloaded``) when the class's share of the in-flight budget
   is exhausted.  Low-priority classes hit their ceiling first, so the
   ``batch`` tier sheds while ``high`` still has reserved headroom.
2. **candidate order** — replicas hosting the model, least outstanding
   work first (Clipper's join-shortest-queue analogue over engine-side
   micro-batch queues).
3. **health gate** — each candidate's ``CircuitBreaker`` (the
   ``resilience`` primitive, one per replica) is consulted at try time:
   open = skip (shed to siblings, never queue behind a corpse);
   half-open = this dispatch IS the probe, and its outcome closes or
   re-opens the circuit.
4. **failover** — a dispatch failure (replica dark, engine stopped,
   model gone) records a breaker failure and falls through to the next
   candidate; a replica-full ``ServerOverloaded`` falls through WITHOUT
   a health penalty (busy is not sick).  Only when every candidate
   refused does the caller see an error — so a single dead replica is
   invisible to ``high``-class traffic as long as one sibling has
   capacity ("zero dropped SLA-high requests" in the acceptance
   replay).

Completion accounting rides the request future's done callback:
per-class end-to-end latency histograms and outcome counters land in
``FleetMetrics``, and transport-shaped result failures feed the
replica's breaker so a replica that accepts-then-kills requests still
trips.
"""

import contextlib
import threading
import time

from ...observability import trace as _trace
from ...profiler import record_event
from ...resilience.breaker import CircuitBreaker
from ..batcher import (DeadlineExceeded, RequestCancelled,
                       ServerOverloaded, ServingError)
from ..sampling import SamplingConfigError
from .admission import AdmissionPolicy
from .metrics import FleetMetrics
from .replica import ModelNotRoutable


class NoReplicaAvailable(ServerOverloaded):
    """Every candidate replica refused the dispatch (dead, stopped, or
    full) — the fleet-level shed, distinguishable from a single
    replica's queue-full."""


class ReplicaRemoved(ServingError):
    """The replica holding this request left the fleet before the
    request resolved.  ``remove_replica`` resolves every orphaned
    future with this — a caller gets a typed error NOW instead of
    waiting out its deadline for a result that will never arrive.
    (A graceful drain detaches migrated requests first, so only
    genuinely unmigratable work ever sees this.)"""


class FleetConfig:
    """Router policy knobs.

    - classes: SLA registry (name -> SlaClass); default high/batch
    - max_outstanding: total in-flight budget the class shares divide
      (admission sheds beyond share * budget)
    - outstanding_per_chip: when set, the in-flight budget is this
      times the fleet's total CHIPS instead of the flat
      max_outstanding — a replica reporting 4 chips carries 4x the
      budget of a single-chip one, and the budget tracks membership
      (capacity is accounted in chips, since a sharded group is one
      routable replica over many devices)
    - breaker_failures / breaker_reset_s: per-replica health circuit —
      consecutive dispatch failures to trip, seconds until the
      half-open probe.  One breaker per REPLICA-GROUP: a sharded
      group registers as one replica, so a dead chip downs its whole
      group and never a sibling group
    """

    def __init__(self, classes=None, max_outstanding=256,
                 breaker_failures=3, breaker_reset_s=5.0,
                 outstanding_per_chip=None):
        self.policy = AdmissionPolicy(classes)
        self.max_outstanding = int(max_outstanding)
        self.outstanding_per_chip = (
            None if outstanding_per_chip is None
            else int(outstanding_per_chip))
        self.breaker_failures = int(breaker_failures)
        self.breaker_reset_s = float(breaker_reset_s)


# result failures that count against the REPLICA's health (vs. client-
# caused terminals: deadline, cancel, and shed are not the replica
# being sick)
_HEALTH_FAILURES = (ConnectionError, OSError)


class FleetRouter:
    """submit()/submit_decode()/predict()/swap_model()/stats() over N
    replicas.  ``submit`` routes one-shot predict requests to
    ``add_model`` engines; ``submit_decode`` routes
    autoregressive decode sequences — with per-request SamplingConfig —
    to ``add_decode_model`` continuous engines, through the SAME
    dispatch core (admission, breakers, failover, _watch)."""

    def __init__(self, config=None):
        self.config = config or FleetConfig()
        # membership lock: submit() runs on many client threads while
        # add/remove_replica mutate these dicts (elastic fleets) — a
        # dispatch must iterate a consistent snapshot, never the live
        # dict (RuntimeError mid-sort, KeyError on a removed breaker)
        self._member_lock = threading.Lock()
        self._replicas = {}             # name -> Replica
        self._breakers = {}             # name -> CircuitBreaker
        self._kv_endpoints = {}         # name -> kv_stream endpoint
        # names currently draining (the drain window of a replica that
        # leaves; the reference's serving.elastic): an atomically-
        # replaced FROZENSET, so the dispatch hot path reads it without
        # taking the member lock a second time
        self._draining = frozenset()
        self._recorder = None       # autotune capture hook (dispatch)
        self._metrics = FleetMetrics(
            tuple(self.config.policy.classes))

    def attach_recorder(self, recorder):
        """Attach a trace recorder (the reference's
        ``autotune.TraceRecorder``; any object with a non-throwing
        ``record(kind, **shape)``): every subsequent
        submit/submit_decode records its request SHAPE (arrival
        offset, rows or prompt/gen lengths, SLA class, sampling kind)
        — the fleet-plane capture point the offline tuner replays.
        record() is non-throwing by contract, so capture can never
        shed or fail a dispatch."""
        self._recorder = recorder
        return recorder

    # ---- fleet membership ----

    def add_replica(self, replica, kv_endpoint=None):
        """Register a replica; `kv_endpoint` optionally names the
        ``(rpc_target, port)``-style address its ``KVStreamServer``
        ingests paged-KV transfers on — the disagg prefill->decode leg
        and the elastic drain migration both stream to it."""
        with self._member_lock:
            if replica.name in self._replicas:
                raise ValueError(
                    f"replica {replica.name!r} already registered")
            self._replicas[replica.name] = replica
            self._breakers[replica.name] = CircuitBreaker(
                self.config.breaker_failures,
                self.config.breaker_reset_s,
                name=f"fleet:{replica.name}")
            if kv_endpoint is not None:
                self._kv_endpoints[replica.name] = kv_endpoint
        return replica

    def remove_replica(self, name):
        """Deregister `name` and resolve its outstanding request
        futures with a typed :class:`ReplicaRemoved` — never orphan a
        waiter on a replica that left.  Returns how many futures the
        sweep resolved (0 after a clean drain)."""
        with self._member_lock:
            replica = self._replicas.pop(name, None)
            self._breakers.pop(name, None)
            self._kv_endpoints.pop(name, None)
            self._draining = self._draining - {name}
        if replica is None:
            return 0
        return replica.fail_outstanding(ReplicaRemoved(
            f"replica {name!r} was removed from the fleet with this "
            f"request still in flight"))

    def mark_draining(self, name):
        """Exclude `name` from new dispatch (candidates skip it) while
        it stays a fleet member — the drain window: existing sequences
        keep decoding until migrated."""
        with self._member_lock:
            if name not in self._replicas:
                raise KeyError(f"unknown replica {name!r}")
            self._draining = self._draining | {name}

    def clear_draining(self, name):
        """Re-admit `name` to dispatch (a drain that was rolled back)."""
        with self._member_lock:
            self._draining = self._draining - {name}

    def draining(self):
        return sorted(self._draining)

    def get_replica(self, name):
        with self._member_lock:
            return self._replicas.get(name)

    def kv_endpoint(self, name):
        with self._member_lock:
            return self._kv_endpoints.get(name)

    def _members(self):
        """Consistent (replicas, breakers) snapshot for one dispatch/
        aggregation pass."""
        with self._member_lock:
            return list(self._replicas.values()), dict(self._breakers)

    def replicas(self):
        with self._member_lock:
            return sorted(self._replicas)

    # ---- dispatch ----

    def submit(self, model, feed, sla="high", timeout_ms=None):
        """Route one request; returns the engine's Request future.
        Typed failures: ServerOverloaded when the class budget or every
        replica is exhausted, KeyError on an unknown SLA class,
        ServingError subclasses from the chosen engine."""
        if self._recorder is not None:
            rows = None
            try:
                vals = feed.values() if isinstance(feed, dict) else feed
                for v in vals:
                    shape = getattr(v, "shape", None)
                    rows = shape[0] if shape else len(v)
                    break
            except Exception:
                pass                 # shape unknown: record it as such
            self._recorder.record("predict", model=model, rows=rows,
                                  sla=sla)
        return self._dispatch(
            model, sla, timeout_ms, kind="fleet/request",
            hosts=lambda r: r.hosts(model, kind="predict"),
            attempt=lambda r, tmo, cls: r.submit(
                model, feed, timeout_ms=tmo, priority=cls.priority,
                sla=cls.name))

    def submit_decode(self, model, prompt, context=None, sampling=None,
                      max_new_tokens=None, sla="high", timeout_ms=None):
        """Route one autoregressive decode sequence to a replica
        hosting `model` as a decode model (``add_decode_model``);
        returns the engine's DecodeRequest future.  Identical dispatch
        discipline to ``submit`` — admission, breaker gate, half-open-
        first candidate order, failover, completion accounting — over
        the decode-hosting candidate set.  A malformed per-request
        ``sampling`` raises SamplingConfigError directly (a client
        error: every sibling would reject it identically, so it must
        neither fail over nor count against replica health)."""
        if self._recorder is not None:
            self._recorder.record(
                "decode", model=model,
                prompt_len=len(prompt) if hasattr(prompt, "__len__")
                else None,
                gen_len=max_new_tokens, sla=sla, sampling=sampling)
        return self._dispatch(
            model, sla, timeout_ms, kind="fleet/decode",
            hosts=lambda r: r.hosts_decode(model),
            attempt=lambda r, tmo, cls: r.submit_decode(
                model, prompt, context=context, sampling=sampling,
                max_new_tokens=max_new_tokens, timeout_ms=tmo,
                sla=cls.name))

    def _dispatch(self, model, sla, timeout_ms, kind, hosts, attempt):
        cls = self.config.policy.resolve(sla)
        self._metrics.inc_class(cls.name, "submitted")
        # ONE membership snapshot per dispatch: the admission count and
        # the candidate scan reuse it (submit is the hot path — don't
        # pay the member lock twice per request)
        members, breakers = self._members()
        in_flight = sum(r.outstanding() for r in members)
        # capacity in CHIPS when configured: a sharded replica-group
        # spans several devices but registers as one replica, so the
        # flat per-replica budget would understate the fleet
        budget = self.config.max_outstanding
        if self.config.outstanding_per_chip is not None:
            budget = self.config.outstanding_per_chip * max(
                1, sum(getattr(r, "chips", 1) for r in members))
        if not self.config.policy.admit(cls, in_flight, budget):
            self._metrics.inc_class(cls.name, "shed_admission")
            raise ServerOverloaded(
                f"fleet at capacity for class {cls.name!r}: "
                f"{in_flight} in flight >= share {cls.share} of "
                f"budget {budget}")
        timeout_ms = timeout_ms if timeout_ms is not None \
            else cls.timeout_ms
        # head sampling (observability.trace): the enabled() guard is
        # the whole hot-path cost at rate 0 — one memoized float
        # compare, no clock read, no attrs dict.  While tracing is on,
        # FLAGS_trace_force_sla classes are always sampled and the
        # root span lives until the request future resolves (_watch
        # closes it).
        t_submit = root = dspan = None
        if _trace.TRACER.enabled():
            t_submit = time.perf_counter()
            root = _trace.TRACER.maybe_trace(
                kind, sla=cls.name,
                attrs={"model": model, "sla": cls.name},
                parent=_trace.current())
            dspan = _trace.TRACER.start_span("fleet/dispatch", root)

        with record_event("fleet/route"):
            # half-open replicas sort FIRST: recovery detection must not
            # wait for siblings to saturate (the breaker admits exactly
            # one probe per reset window, so this steals at most one
            # request from the healthy path — the probe itself)
            # least outstanding work PER CHIP: a 4-chip group at 4 in
            # flight is as loaded as a 1-chip replica at 1
            # draining replicas are members (their in-flight work
            # still counts) but never candidates — the frozenset read
            # is lock-free (atomically replaced, never mutated)
            draining = self._draining
            candidates = sorted(
                (r for r in members
                 if r.name not in draining and hosts(r)),
                key=lambda r: (
                    0 if breakers[r.name].export()["state"]
                    == "half-open" else 1,
                    r.outstanding() / max(1, getattr(r, "chips", 1))))
            if not candidates:
                self._metrics.inc_class(cls.name, "shed_no_replica")
                exc = ModelNotRoutable(
                    f"no replica serves {model!r} "
                    f"(replicas: {self.replicas()})")
                _trace.TRACER.end_span(dspan, error=exc)
                _trace.TRACER.end_span(root, error=exc)
                raise exc
            errors = []
            tried = 0
            for r in candidates:
                breaker = breakers[r.name]
                if not breaker.allow():
                    # open circuit: shed to siblings instead of queueing
                    # behind a dead replica (half-open admits exactly
                    # one probe dispatch per reset window)
                    self._metrics.inc("replica_unroutable")
                    errors.append(f"{r.name}: circuit open "
                                  f"(probe in "
                                  f"{breaker.remaining_s():.1f}s)")
                    if dspan is not None:
                        _trace.TRACER.event("breaker_open", span=dspan,
                                            replica=r.name)
                    continue
                tried += 1
                t_try = time.perf_counter()
                try:
                    # the root context is ambient during the engine
                    # submit so the Request stamps it (queue/compute
                    # spans parent under the root on the worker side)
                    with _trace.use_context(root.ctx()) \
                            if root is not None else \
                            contextlib.nullcontext():
                        req = attempt(r, timeout_ms, cls)
                except SamplingConfigError as e:
                    # client error, not replica health: every sibling
                    # would reject the same config, so propagate
                    # directly — no failover, no breaker penalty
                    _trace.TRACER.end_span(dspan, error=e)
                    _trace.TRACER.end_span(root, error=e)
                    raise
                except ServerOverloaded as e:
                    # full queue = busy, not sick: no breaker penalty,
                    # but DO fail over — a sibling may have room
                    errors.append(f"{r.name}: {e}")
                    if dspan is not None:
                        # span= must be explicit: a None dspan would
                        # fall back to THIS thread's active span and
                        # pollute an unrelated trace
                        _trace.TRACER.event(
                            "replica_overloaded", span=dspan,
                            replica=r.name,
                            dur_ms=round((time.perf_counter() - t_try)
                                         * 1e3, 3))
                    continue
                except (ServingError, ConnectionError, OSError) as e:
                    breaker.record_failure()
                    self._metrics.inc("dispatch_errors")
                    errors.append(f"{r.name}: {type(e).__name__}: {e}")
                    if dspan is not None:
                        _trace.TRACER.event(
                            "dispatch_failed", span=dspan,
                            replica=r.name,
                            error=f"{type(e).__name__}: {e}",
                            dur_ms=round((time.perf_counter() - t_try)
                                         * 1e3, 3))
                    continue
                # NO record_success here: acceptance is not health — a
                # replica that accepts-then-kills every batch must still
                # trip, and a half-open probe must stay open until its
                # RESULT closes the circuit (both land in _watch)
                self._metrics.inc("routed")
                if tried > 1 or errors:
                    self._metrics.inc("failovers")
                _trace.TRACER.end_span(dspan, replica=r.name,
                                       tried=tried,
                                       failovers=len(errors))
                self._watch(req, breaker, cls.name,
                            time.perf_counter(), root)
                return req
        self._metrics.inc_class(cls.name, "shed_no_replica")
        exc = NoReplicaAvailable(
            f"all {len(candidates)} replica(s) refused {model!r} "
            f"for class {cls.name!r}: " + "; ".join(errors))
        if root is not None:
            _trace.TRACER.end_span(dspan, error=exc)
            _trace.TRACER.end_span(root, error=exc)
        else:
            # forced sampling on errors: a terminally-failed request
            # leaves a trace naming every replica that refused it even
            # when the head-sampling dice said no
            _trace.TRACER.error_trace(
                kind, t_submit, errors, sla=cls.name,
                attrs={"model": model, "sla": cls.name})
        raise exc

    def predict(self, model, feed, sla="high", timeout_ms=None,
                result_timeout_s=60.0):
        """Blocking convenience: submit + result."""
        return self.submit(model, feed, sla=sla,
                           timeout_ms=timeout_ms).result(result_timeout_s)

    def _watch(self, req, breaker, sla, t0, root=None):
        """Completion accounting: per-class latency + outcome; the
        result is the replica's health signal (success closes, a
        transport-shaped failure counts toward the trip).  ``root`` is
        the request's open trace span — the done callback closes it
        with the outcome, and a completed request's trace_id becomes
        the EXEMPLAR on the latency bucket it lands in."""

        def done(r):
            exc = r._exc
            ms = (time.perf_counter() - t0) * 1e3
            if exc is None:
                self._metrics.observe_latency(
                    sla, ms,
                    exemplar=f"{root.trace_id:016x}"
                    if root is not None else None)
                self._metrics.inc_class(sla, "completed")
                if breaker is not None:
                    # the replica's health signal: a COMPLETED request
                    # (this is also what closes a half-open probe)
                    breaker.record_success()
                _trace.TRACER.end_span(root, outcome="completed",
                                       latency_ms=round(ms, 3))
                return
            _trace.TRACER.end_span(root, error=exc,
                                   outcome=type(exc).__name__)
            if isinstance(exc, DeadlineExceeded):
                self._metrics.inc_class(sla, "expired")
            elif isinstance(exc, RequestCancelled):
                self._metrics.inc_class(sla, "cancelled")
            elif isinstance(exc, ServerOverloaded):
                # engine-side preemption shed (a higher class took the
                # queue slot): admission accounting, not replica health
                self._metrics.inc_class(sla, "shed_admission")
            else:
                self._metrics.inc_class(sla, "failed")
                if breaker is not None and isinstance(
                        exc, _HEALTH_FAILURES + (ServingError,)):
                    breaker.record_failure()

        req.add_done_callback(done)

    # ---- fleet-wide model management ----

    def swap_model(self, model, ckpt_path, timeout_s=60.0):
        """Hot-swap `model`'s weights on EVERY replica hosting it,
        while traffic keeps flowing (each engine applies between
        batches).  Returns {replica: checkpoint step}.  A replica that
        fails the swap is reported, not silently skipped — partial
        fleets serving mixed weights must be visible.  (In the port
        every replica's ``swap_weights`` raises until the engine's warm
        reload lands, so this raises ServingError naming them.)"""
        steps, failures = {}, {}
        members, _ = self._members()
        for r in sorted(members, key=lambda r: r.name):
            name = r.name
            # decode engines hold no swappable predictor weights —
            # only predict-kind hostings participate in the swap
            if not r.hosts(model, kind="predict"):
                continue
            try:
                steps[name] = r.swap_weights(model, ckpt_path,
                                             timeout_s=timeout_s)
                self._metrics.inc("model_swaps")
            except Exception as e:        # noqa: BLE001 — aggregated
                failures[name] = e
        if failures:
            raise ServingError(
                f"weight swap for {model!r} failed on "
                f"{sorted(failures)} (succeeded on {sorted(steps)}): "
                f"{failures}")
        if not steps:
            raise ModelNotRoutable(
                f"no replica serves {model!r}; nothing swapped")
        return steps

    # ---- observability / lifecycle ----

    def total_outstanding(self):
        members, _ = self._members()
        return sum(r.outstanding() for r in members)

    def total_chips(self):
        members, _ = self._members()
        return sum(getattr(r, "chips", 1) for r in members)

    def stats(self):
        out = self._metrics.snapshot()
        out["outstanding"] = self.total_outstanding()
        out["max_outstanding"] = self.config.max_outstanding
        out["total_chips"] = self.total_chips()
        out["draining"] = self.draining()
        members, breakers = self._members()
        out["replicas"] = {
            r.name: {"breaker": breakers[r.name].export(),
                     **r.stats()}
            for r in members}
        return out

    def reset_stats(self):
        self._metrics.reset()

    def stop(self, drain=True):
        """Stop every replica (graceful drain by default)."""
        members, _ = self._members()
        for r in members:
            r.stop(drain=drain)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)
