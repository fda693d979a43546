"""One serving replica: a named-model registry over ServingEngines (port
of ``paddle_tpu/serving/fleet/replica.py``, a copy: host Python; the
engines it hosts run their programs on the card).

A :class:`Replica` is the unit the router spreads load across.  It
hosts N *named models*, each backed by its own ``ServingEngine`` (one
worker thread, one predictor, one callable cache), and enforces the
multi-model hosting contract:

- **warmup gate**: a model is not *routable* until its bucket-grid
  warmup finished (``ServingEngine.warmup()`` prepares one callable per
  (batch x seq) grid point), so the router never steers traffic onto a
  cold grid.  ``add_model(..., warmup=False)`` opts out for tests.
- **weight hot-swap**: the reference's ``swap_weights`` rides the
  engine's warm ``reload_weights``, which the port's ServingEngine does
  not have yet (ROADMAP queue 1 item 8, the serving engine remainder):
  ``swap_weights`` raises ``NotImplementedError`` naming it.
- **outstanding-work accounting**: every accepted request bumps a
  counter that its done-callback decrements — the router's
  least-outstanding-work dispatch key.  The count survives every
  terminal path (result, failure, deadline, cancel, engine stop)
  because it hangs off the request future, not the happy path.

Fault seam: ``set_fault_plan`` routes every dispatch through a
``resilience.FaultPlan`` hook under the seam key
``replica:<name>:<model>`` — an ``error("replica:r2:*", after=K,
times=N)`` rule makes the replica drop dead at its K-th dispatch and
stay dead for N calls, which is how a chaos test kills a replica
mid-replay deterministically.
"""

import threading

from ...profiler import record_event
from ..batcher import ServingError
from ..engine import ServingConfig, ServingEngine


class ModelNotRoutable(ServingError):
    """The named model is absent from this replica or not warmed up."""


class _HostedModel:
    __slots__ = ("engine", "routable", "warmup_built", "kind")

    def __init__(self, engine, routable, warmup_built, kind="predict"):
        self.engine = engine
        self.routable = routable
        self.warmup_built = warmup_built
        self.kind = kind        # "predict" (ServingEngine) or "decode"
        #                         (ContinuousBatchingEngine)


class Replica:
    """Named-model registry + dispatch surface for one engine replica.

    ``chips`` is the device count backing this replica — 1 here; the
    reference's ``ShardedReplica`` (a mesh slice, not ported yet) reports
    its slice size, and the router accounts capacity in chips
    (``FleetConfig(outstanding_per_chip=...)``) while keeping ONE
    circuit breaker per replica-GROUP."""

    chips = 1

    def __init__(self, name, fault_plan=None):
        self.name = name
        self._models = {}               # model name -> _HostedModel
        self._lock = threading.Lock()
        # identity set of accepted-unresolved request futures.  A SET,
        # not a counter: migration (the reference's serving.elastic)
        # DETACHES a request
        # from its source replica before chaining its future to the
        # target's — the later resolution then fires _request_done on
        # a request this replica no longer owns, which must not
        # double-decrement.  Membership makes the callback idempotent.
        self._inflight = set()
        self._plan = fault_plan

    # ---- hosting ----

    def add_model(self, model, predictor, config=None, warmup=True):
        """Host `model` behind a fresh ServingEngine.  With warmup=True
        (default) the engine prepares its (batch x seq) bucket grid
        BEFORE the model is marked routable; returns the
        number of grid points materialized.  Re-adding a hosted name
        raises — swap weights instead of silently orphaning an engine
        (its worker thread would keep running)."""
        # reserve the name atomically with the duplicate check: two
        # racing add_model calls must not both build an engine (the
        # loser's worker thread would be orphaned, unreachable by
        # stop()).  The engine+warmup build happens OUTSIDE the lock —
        # warmup is seconds-scale and must not block dispatch.
        placeholder = _HostedModel(None, routable=False, warmup_built=0)
        with self._lock:
            if model in self._models:
                raise ValueError(
                    f"replica {self.name!r} already hosts {model!r}; "
                    f"use swap_weights to update it")
            self._models[model] = placeholder
        try:
            engine = ServingEngine(predictor, config or ServingConfig())
            built = 0
            if warmup:
                with record_event("fleet/warmup"):
                    built = engine.warmup()
        except BaseException:
            with self._lock:
                if self._models.get(model) is placeholder:
                    del self._models[model]
            raise
        placeholder.engine = engine
        placeholder.warmup_built = built
        placeholder.routable = True      # publish: warmup is done
        return built

    def add_decode_model(self, model, step_fn, config=None,
                         speculative=None):
        """Host `model` behind a ContinuousBatchingEngine (token-level
        autoregressive decode).  Same atomic name-reservation dance as
        ``add_model``; there is no warmup gate — the engine steps one
        fixed shape at every occupancy (``shape_signatures == 1``).
        Dispatch via ``submit_decode``; ``submit`` on a decode model
        raises."""
        from .continuous import ContinuousBatchingEngine
        placeholder = _HostedModel(None, routable=False, warmup_built=0,
                                   kind="decode")
        with self._lock:
            if model in self._models:
                raise ValueError(
                    f"replica {self.name!r} already hosts {model!r}")
            self._models[model] = placeholder
        try:
            engine = ContinuousBatchingEngine(step_fn, config,
                                              speculative=speculative)
        except BaseException:
            with self._lock:
                if self._models.get(model) is placeholder:
                    del self._models[model]
            raise
        placeholder.engine = engine
        placeholder.routable = True
        return engine

    def models(self, routable_only=True):
        with self._lock:
            return sorted(m for m, h in self._models.items()
                          if h.routable or not routable_only)

    def hosts(self, model, kind=None):
        with self._lock:
            h = self._models.get(model)
            return (h is not None and h.routable
                    and (kind is None or h.kind == kind))

    def hosts_decode(self, model):
        with self._lock:
            h = self._models.get(model)
            return h is not None and h.routable and h.kind == "decode"

    def decode_models(self):
        """Routable decode-engine model names — the drain sweep's
        iteration surface."""
        with self._lock:
            return sorted(m for m, h in self._models.items()
                          if h.routable and h.kind == "decode")

    def get_engine(self, model):
        """The hosted engine object (any kind, routable or not) — the
        drain/migration layer needs the engine itself for
        ``begin_drain``/``extract_sequences``, past the routable
        gate a drain deliberately leaves up."""
        with self._lock:
            h = self._models.get(model)
        if h is None or h.engine is None:
            raise ModelNotRoutable(
                f"replica {self.name!r} does not host {model!r}")
        return h.engine

    def _hosted(self, model, kind=None):
        with self._lock:
            h = self._models.get(model)
        if h is None or not h.routable:
            raise ModelNotRoutable(
                f"replica {self.name!r} does not serve {model!r} "
                f"(hosted+routable: {self.models()})")
        if kind is not None and h.kind != kind:
            raise ModelNotRoutable(
                f"replica {self.name!r} hosts {model!r} as a "
                f"{h.kind!r} model, not {kind!r} — use "
                f"{'submit_decode' if h.kind == 'decode' else 'submit'}")
        return h

    # ---- dispatch ----

    def submit(self, model, feed, timeout_ms=None, priority=0,
               sla=None):
        """Dispatch one request to the named model's engine.  The
        fault-plan seam fires BEFORE the engine sees the request — an
        injected ConnectionError here is a replica that went dark, not
        a poisoned device."""
        h = self._hosted(model, kind="predict")
        if self._plan is not None:
            self._plan.hook(f"replica:{self.name}", {"method": model})
        req = h.engine.submit(feed, timeout_ms=timeout_ms,
                              priority=priority, sla=sla)
        with self._lock:
            self._inflight.add(req)
        req.add_done_callback(self._request_done)
        return req

    def submit_decode(self, model, prompt, context=None, sampling=None,
                      max_new_tokens=None, timeout_ms=None, sla="high",
                      resume=None):
        """Dispatch one decode sequence to the named model's continuous
        engine.  Same fault seam and outstanding accounting as
        ``submit``; per-request `sampling` (SamplingConfig / kwargs
        dict / None = greedy) is validated by the engine at submit with
        a named SamplingConfigError.  `resume` passes a migrated
        sequence's ``(sample_counter, constraint_state)`` checkpoint
        through to the engine (serving.elastic)."""
        h = self._hosted(model, kind="decode")
        if self._plan is not None:
            self._plan.hook(f"replica:{self.name}", {"method": model})
        req = h.engine.submit(prompt, context=context,
                              max_new_tokens=max_new_tokens,
                              sla=sla, timeout_ms=timeout_ms,
                              sampling=sampling, resume=resume)
        with self._lock:
            self._inflight.add(req)
        req.add_done_callback(self._request_done)
        return req

    def _request_done(self, req):
        # idempotent: a request detached by migration (or failed by
        # remove_replica) is already out of the set — resolving it
        # later is a no-op here
        with self._lock:
            self._inflight.discard(req)

    def outstanding(self):
        """In-flight requests (accepted, not yet resolved) — the
        router's least-outstanding-work dispatch key."""
        with self._lock:
            return len(self._inflight)

    def detach_requests(self, reqs):
        """Stop counting `reqs` against this replica (they migrated to
        another one).  Their futures stay live — the migration layer
        chains them — but this replica's accounting and its
        ``fail_outstanding`` sweep no longer own them."""
        with self._lock:
            for r in reqs:
                self._inflight.discard(r)

    def fail_outstanding(self, exc):
        """Resolve every still-inflight request future with `exc` —
        the remove_replica sweep: a caller blocked on a future from a
        removed replica gets a typed error now instead of waiting out
        its deadline for a result that will never arrive.  Returns how
        many futures this call resolved."""
        with self._lock:
            reqs = list(self._inflight)
            self._inflight.clear()
        failed = 0
        for r in reqs:
            if r._set_exception(exc):
                failed += 1
        return failed

    def set_fault_plan(self, plan):
        self._plan = plan

    # ---- weight management ----

    def swap_weights(self, model, ckpt_path, timeout_s=60.0):
        """Hot-swap `model`'s weights from a checkpoint manifest — in
        the reference, the engine's warm ``reload_weights`` applied
        between batches.  The port's ServingEngine has no warm reload
        yet, so this raises after the routability check."""
        self._hosted(model, kind="predict")
        raise NotImplementedError(
            f"Replica.swap_weights({model!r}): the ServingEngine's warm "
            f"weight reload (reload_weights) is not ported yet (ROADMAP "
            f"queue 1 item 8)")

    # ---- lifecycle / observability ----

    def stats(self):
        with self._lock:
            models = dict(self._models)
            outstanding = len(self._inflight)
        return {
            "name": self.name,
            "chips": self.chips,
            "outstanding": outstanding,
            "models": {
                m: {"routable": h.routable,
                    "kind": h.kind,
                    "warmup_built": h.warmup_built,
                    # engine is None while an add_model build/warmup
                    # is still in flight (name reserved, not routable)
                    "engine": h.engine.stats()
                    if h.engine is not None else None}
                for m, h in models.items()},
        }

    def stop(self, drain=True):
        with self._lock:
            models = list(self._models.values())
        for h in models:
            h.routable = False
            if h.engine is not None:
                h.engine.stop(drain=drain)
