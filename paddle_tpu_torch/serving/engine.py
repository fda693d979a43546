"""ServingEngine: dynamic-batching execution over a Predictor (port of
``paddle_tpu/serving/engine.py``, its submit/predict/stats/warmup/stop
core).

One worker thread owns the device: it pops coalesced same-shape batches
off the MicroBatcher, pads them onto the bucket grid, runs them through
the predictor's per-signature callable (LRU cache), and scatters row
slices back to each request's future.  Transient failures retry with
exponential backoff; shutdown drains the queue before the thread exits so
accepted requests are never dropped.

The engine *owns* the predictor while running: concurrent
`predictor.run()` calls from other threads are not supported.  Warm
weight reload, the circuit breaker, autotune and the fleet tier are not
ported yet.
"""

import threading
import time

import numpy as np
import torch

from ..observability.trace import TRACER
from ..profiler import record_event, record_span
from . import buckets as bk
from .batcher import MicroBatcher, ServingError, EngineStopped
from .metrics import ServingMetrics

# worth retrying: transport errors and CUDA runtime errors a later call
# may not repeat.  Shape, dtype and program bugs (ValueError/TypeError)
# fail fast, and so does running out of device memory: the same batch
# would only run out again.
_TRANSIENT = (OSError, ConnectionError) + tuple(
    e for e in (getattr(torch, "AcceleratorError", None),) if e is not None)
_NOT_TRANSIENT = (torch.cuda.OutOfMemoryError,)


class ServingConfig:
    """Batching / queueing / caching policy knobs.

    - max_batch_size: coalescing cap (rows per device call)
    - max_wait_ms: linger window for followers once a batch opens
    - max_queue_size: admission bound; beyond it submits shed with
      ServerOverloaded
    - batch_buckets: allowed padded row counts (default: powers of two
      up to max_batch_size)
    - seq_buckets/seq_axis/pad_value: optional ragged-dim bucketing.
      When seq_buckets is set, EVERY input whose rank exceeds seq_axis
      is padded along that axis
    - cache_capacity: LRU cap on per-signature callables
    - default_timeout_ms: per-request deadline when submit() passes none
    - max_retries/retry_backoff_ms: transient-failure policy
    - drain_timeout_s: stop(drain=True) wait bound
    - unpad_outputs: opt-in — slice outputs whose seq_axis dim equals the
      padded bucket back to the request's original length
    - warmup: prepare the configured (batch x seq) bucket grid before the
      engine admits traffic
    """

    def __init__(self, max_batch_size=16, max_wait_ms=5.0,
                 max_queue_size=256, batch_buckets=None, seq_buckets=None,
                 seq_axis=1, pad_value=0, cache_capacity=8,
                 default_timeout_ms=None, max_retries=2,
                 retry_backoff_ms=10.0, drain_timeout_s=30.0,
                 unpad_outputs=False, warmup=False):
        self.max_batch_size = max_batch_size
        self.max_wait_ms = max_wait_ms
        self.max_queue_size = max_queue_size
        self.batch_buckets = bk.validate_buckets(
            batch_buckets, name="batch_buckets")
        self.seq_buckets = bk.validate_buckets(
            seq_buckets, name="seq_buckets")
        self.seq_axis = seq_axis
        self.pad_value = pad_value
        self.cache_capacity = cache_capacity
        self.default_timeout_ms = default_timeout_ms
        self.max_retries = max_retries
        self.retry_backoff_ms = retry_backoff_ms
        self.drain_timeout_s = drain_timeout_s
        self.unpad_outputs = unpad_outputs
        self.warmup = bool(warmup)


class ServingEngine:
    """submit()/predict()/stats()/stop() over a wrapped Predictor."""

    def __init__(self, predictor, config=None):
        cfg = config or ServingConfig()
        self.config = cfg
        self._handle = predictor.serving_handle()
        self._seq_buckets = tuple(sorted(cfg.seq_buckets)) \
            if cfg.seq_buckets else None
        fixed = getattr(self._handle, "fixed_shapes", None)
        if fixed is not None:
            # an exported (AOT) program: its row count was fixed at
            # export, so exactly one batch bucket; the other dims must
            # match the export already (the engine cannot know which axis
            # is ragged; ragged AOT service needs seq_buckets configured)
            max_batch = fixed[0][0]
            self._batch_buckets = (max_batch,)
        else:
            max_batch = cfg.max_batch_size
            self._batch_buckets = tuple(sorted(
                cfg.batch_buckets or bk.default_batch_buckets(max_batch)))
            if self._batch_buckets[-1] != max_batch:
                raise ValueError(
                    "largest batch bucket must equal max_batch_size")
        self._metrics = ServingMetrics()
        self._broken = None          # set when a failure poisons the device
        self._batcher = MicroBatcher(max_batch, cfg.max_wait_ms,
                                     cfg.max_queue_size, self._metrics)
        self._cache = bk.ExecutableCache(cfg.cache_capacity, self._metrics)
        self._stop_now = threading.Event()
        self._drained = threading.Event()
        self._worker = threading.Thread(target=self._loop,
                                        name="serving-worker", daemon=True)
        if cfg.warmup:
            self.warmup()
        self._worker.start()

    # ---- client surface ----

    def submit(self, feed, timeout_ms=None, priority=0, sla=None):
        """Enqueue one request (dict name->array, or a list in
        get-input-names order); returns a Request future.  Non-blocking:
        a full queue raises ServerOverloaded, a stopped engine raises
        EngineStopped."""
        if self._broken is not None:
            raise EngineStopped(
                f"engine disabled by an earlier execution failure: "
                f"{self._broken!r}")
        norm, nrows, meta = self._normalize(feed)
        key = bk.signature(norm, self._handle.feed_order)
        timeout_ms = timeout_ms if timeout_ms is not None \
            else self.config.default_timeout_ms
        deadline = time.perf_counter() + timeout_ms / 1000.0 \
            if timeout_ms is not None else None
        # the batcher counts "submitted" under its queue lock, strictly
        # before the worker can see the request — see stats()
        return self._batcher.submit(norm, key, nrows, deadline, meta,
                                    priority=priority, sla=sla)

    def predict(self, feed, timeout_ms=None, result_timeout_s=60.0):
        """Blocking convenience: submit + result.  Returns the fetch
        list (np arrays), like Predictor.run."""
        return self.submit(feed, timeout_ms).result(result_timeout_s)

    def warmup(self, seq_buckets=None):
        """Prepare one callable per (batch bucket x seq bucket) grid
        point, so the first real request is a cache hit.  Returns the
        number of grid points prepared; points whose input shapes can't
        be determined (a ragged dim with no seq bucket) are skipped."""
        h = self._handle
        seqs = tuple(seq_buckets) if seq_buckets else \
            (self._seq_buckets or (None,))
        built = 0
        for b in self._batch_buckets:
            for s in seqs:
                feeds = h.example_feeds(b, s, axis=self.config.seq_axis)
                if feeds is None:
                    continue
                ckey = tuple((n, feeds[n].shape, feeds[n].dtype.str)
                             for n in h.feed_order)
                self._cache.get_or_build(
                    ckey, lambda f=feeds: self._build_compiled(f))
                built += 1
        self._metrics.inc("warmup_built", built)
        return built

    def _build_compiled(self, feeds):
        with record_event("serving/compile"):
            return self._handle.compile(feeds)

    def reset_stats(self):
        """Zero histograms and counters — call after warm-up so reported
        percentiles reflect steady state."""
        self._metrics.reset()

    def stats(self):
        """Consistent metrics snapshot, safe under concurrent submit()."""
        out = self._metrics.snapshot()
        out["broken"] = repr(self._broken) if self._broken else None
        out["pending"] = self._batcher.pending()
        out["cache_size"] = len(self._cache)
        out["batch_buckets"] = list(self._batch_buckets)
        out["seq_buckets"] = list(self._seq_buckets) \
            if self._seq_buckets else None
        out["max_wait_ms"] = round(self._batcher.max_wait_s * 1e3, 4)
        return out

    def stop(self, drain=True, timeout_s=None):
        """Shut down.  drain=True (graceful): refuse new submits, run
        everything already accepted, then stop the worker.  drain=False:
        abandon queued requests with EngineStopped after the in-flight
        batch finishes."""
        self._batcher.close()
        if drain:
            self._drained.wait(timeout_s if timeout_s is not None
                               else self.config.drain_timeout_s)
        self._stop_now.set()
        self._worker.join(timeout_s if timeout_s is not None
                          else self.config.drain_timeout_s)
        # anything still queued (forced stop, or drain timed out) must
        # resolve — a waiter blocked on result() can't be left hanging
        while True:
            batch = self._batcher.next_batch(0)
            if not batch:
                break
            for r in batch:
                r._set_exception(EngineStopped("engine stopped"))
                self._metrics.inc("failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)

    # ---- worker side ----

    def _normalize(self, feed):
        h = self._handle
        if not isinstance(feed, dict):
            # positional feeds bind in get_input_names() order, exactly
            # like Predictor.run — NOT the engine's sorted order
            feed = dict(zip(h.declared_order, feed))
        norm, nrows, meta = {}, None, {}
        for n, dt in zip(h.feed_order, h.feed_dtypes):
            if n not in feed:
                raise ServingError(f"missing input '{n}'")
            a = np.asarray(feed[n])
            if dt is not None:
                a = a.astype(dt, copy=False)
            if a.ndim == 0:
                raise ServingError(
                    f"input '{n}' must have a leading batch dim")
            if a.shape[0] == 0:
                raise ServingError(
                    f"input '{n}' has 0 rows — empty requests can't "
                    f"pad onto the bucket grid")
            if nrows is None:
                nrows = a.shape[0]
            elif a.shape[0] != nrows:
                raise ServingError(
                    f"inconsistent batch dims: '{n}' has {a.shape[0]} "
                    f"rows, expected {nrows}")
            norm[n] = a
        if self._seq_buckets:
            axis = self.config.seq_axis
            lens = set()
            for n in h.feed_order:
                a = norm[n]
                if a.ndim > axis:
                    lens.add(a.shape[axis])
                    try:
                        bucket = bk.choose_bucket(a.shape[axis],
                                                  self._seq_buckets)
                    except ValueError as e:
                        raise ServingError(
                            f"input '{n}' length {a.shape[axis]} "
                            f"exceeds the largest seq bucket "
                            f"{self._seq_buckets[-1]}") from e
                    norm[n] = bk.pad_seq(a, bucket, axis=axis,
                                         value=self.config.pad_value)
            if len(lens) == 1:
                (orig,) = lens
                meta["orig_seq"] = orig
                meta["padded_seq"] = bk.choose_bucket(orig,
                                                      self._seq_buckets)
        return norm, nrows, meta

    def _loop(self):
        while True:
            if self._stop_now.is_set():
                break
            batch = self._batcher.next_batch(0.05)
            if batch is None:
                if self._batcher.closed and self._batcher.pending() == 0:
                    break
                continue
            if self._broken is not None:
                for r in batch:
                    if r._set_exception(ServingError(
                            f"engine disabled by earlier failure: "
                            f"{self._broken!r}")):
                        self._metrics.inc("failed")
                continue
            try:
                self._run_batch(batch)
            except Exception as e:           # defensive: never kill the
                for r in batch:              # worker, resolve + continue
                    if r._set_exception(e):
                        self._metrics.inc("failed")
        self._drained.set()

    def _execute(self, feeds):
        """Look up or prepare the callable, then run, with
        retry-with-backoff on transient failures.  Returns (fetch list as
        np arrays, execution ms); the timing covers the call only and
        ends when the outputs are on the host."""
        order = self._handle.feed_order
        ckey = tuple((n, feeds[n].shape, feeds[n].dtype.str)
                     for n in order)
        retries = self.config.max_retries
        last = None
        for attempt in range(retries + 1):
            try:
                compiled = self._cache.get_or_build(
                    ckey, lambda: self._build_compiled(feeds))
                t0 = time.perf_counter()
                with record_event("serving/execute"):
                    outs = [np.asarray(o)
                            for o in self._handle.call(compiled, feeds)]
                return outs, (time.perf_counter() - t0) * 1e3
            except _NOT_TRANSIENT:
                raise
            except _TRANSIENT as e:
                last = e
                if attempt < retries:
                    self._metrics.inc("retries")
                    backoff_ms = self.config.retry_backoff_ms \
                        * (2 ** attempt)
                    TRACER.event("serving/retry", attempt=attempt,
                                 dur_ms=round(backoff_ms, 3),
                                 error=f"{type(e).__name__}: {e}")
                    time.sleep(backoff_ms / 1000.0)
        raise ServingError(
            f"batch failed after {retries + 1} attempts: {last!r}") \
            from last

    def _run_batch(self, reqs):
        t_start = time.perf_counter()
        traced = [r for r in reqs if r.trace is not None] \
            if TRACER.enabled() else ()
        for r in reqs:
            self._metrics.observe_queue((t_start - r.enq_t) * 1e3)
            record_span("serving/queue", r.enq_t, t_start)
        for r in traced:
            TRACER.add_span("serving/queue", r.trace, r.enq_t, t_start)
        with record_event("serving/pad"):
            rows = sum(r.nrows for r in reqs)
            target = bk.choose_bucket(rows, self._batch_buckets)
            feeds = {}
            for n in self._handle.feed_order:
                a = reqs[0].feed[n] if len(reqs) == 1 else \
                    np.concatenate([r.feed[n] for r in reqs], axis=0)
                feeds[n] = bk.pad_rows(a, target)
        bspan = None
        if traced:
            bspan = TRACER.start_span(
                "serving/batch", traced[0].trace, t0=t_start,
                attrs={"members": len(reqs), "batch_rows": rows,
                       "padded": target})
            if bspan is not None:
                bspan.links.extend(
                    (r.trace.trace_id, r.trace.span_id)
                    for r in traced[1:])
        t_exec0 = time.perf_counter()
        try:
            if bspan is not None:
                with TRACER.use_span(bspan):
                    outs, compute_ms = self._execute(feeds)
            else:
                outs, compute_ms = self._execute(feeds)
        except Exception as e:
            TRACER.end_span(bspan, error=e)
            for r in traced:
                TRACER.add_span(
                    "serving/compute", r.trace, t_exec0,
                    time.perf_counter(),
                    attrs={"rows": r.nrows, "batch_rows": rows,
                           "padded": target}, error=e)
            raise
        TRACER.end_span(bspan, compute_ms=round(compute_ms, 3))
        for r in traced:
            TRACER.add_span(
                "serving/compute", r.trace, t_exec0, time.perf_counter(),
                attrs={"rows": r.nrows, "batch_rows": rows,
                       "padded": target},
                links=[(bspan.trace_id, bspan.span_id)]
                if bspan is not None else None)
        t_done = time.perf_counter()
        self._metrics.observe_batch(rows, target, compute_ms)

        # the engine's scatter contract is row-wise outputs: every fetch
        # must carry the padded batch dim
        bad = [h for h, o in zip(self._handle.fetch_names, outs)
               if o.ndim < 1 or o.shape[0] != target]
        if bad:
            raise ServingError(
                f"fetches {bad} lack the per-row leading dim "
                f"({target} rows expected) — batch-aggregated outputs "
                f"can't be scattered back to coalesced requests")

        axis = self.config.seq_axis
        ofs = 0
        for r in reqs:
            per = [o[ofs:ofs + r.nrows] for o in outs]
            orig = r.meta.get("orig_seq")
            if orig is not None and self.config.unpad_outputs:
                padded = r.meta["padded_seq"]
                per = [bk.unpad_seq(o, orig, axis)
                       if o.ndim > axis and o.shape[axis] == padded
                       and orig != padded else o
                       for o in per]
            ofs += r.nrows
            # metrics land BEFORE the future resolves so a caller doing
            # result() -> stats() always sees its own request counted
            self._metrics.observe_latency((t_done - r.enq_t) * 1e3)
            self._metrics.inc("completed")
            if not r._set_result(per):
                self._metrics.inc("completed", -1)   # lost to cancel
