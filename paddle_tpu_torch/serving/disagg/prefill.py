"""Prefill tier: run the prompt forward, page the KV, ship it out (port
of ``paddle_tpu/serving/disagg/prefill.py``, a copy: host Python; the
``prefill_fn`` it calls runs the model on the card).

A :class:`PrefillEngine` is the prefill half of the disaggregated
split: one worker thread runs ``prefill_fn`` over prompts, writes the
resulting per-token K/V planes straight into a local paged-pool slot
(the pool's block layout — quantized arenas included, so the wire
carries int8 + scales, ~1/4 the fp32 bytes), streams the block arena + block
table to a decode replica's ingest listener via ``kv_stream``, then
releases the slot.  The pool here is a STAGING pool: slots live only
for the admit -> stream -> release window, so a handful of slots
sustains the tier.

``prefill_fn(tokens) -> {plane: [n, *tail]}`` is the model contract —
per-token value planes matching the pool's ``value_spec`` (an attention
stack produces k/v and, in int8 mode, k_scale/v_scale).  Everything
after it is mechanical: the engine owns slot claiming, streaming,
abort-on-failure (the decode side provably gets its reserved blocks
back — by explicit abort or by the ingestor's TTL reaper), and typed
futures.

:class:`PrefillReplica` hosts prefill engines behind the standard
``Replica`` registry (kind="prefill"), so the DisaggRouter drives the
prefill leg through the SAME dispatch core as predict/decode traffic:
admission, per-group circuit breakers, half-open-first ordering,
failover — a dead prefill replica degrades to co-located serving,
never an outage.
"""

import itertools
import queue
import threading

import numpy as np

from ...observability import trace as _trace
from ..batcher import EngineStopped, ResolvableFuture, ServerOverloaded
from ..kv.pool import KVBlockPool, PagedKVConfig
from ..fleet.replica import Replica, _HostedModel
from .kvstream import DEFAULT_CHUNK_BYTES, send_abort, stream_slot

__all__ = ["PrefillEngine", "PrefillReplica"]


class PrefillRequest(ResolvableFuture):
    """Future for one prefill+transfer; resolves to the kv_stream
    manifest (token/block/chunk/byte counts, dedup stats)."""

    __slots__ = ("tokens", "endpoint", "xfer", "timeout_ms", "_tctx")

    def __init__(self, tokens, endpoint, xfer, timeout_ms):
        super().__init__()
        self.tokens = np.asarray(tokens, np.int64).reshape(-1)
        self.endpoint = endpoint
        self.xfer = xfer
        self.timeout_ms = timeout_ms
        self._tctx = _trace.current()   # submit-side trace context


class PrefillEngine:
    """One prefill worker over a staging ``KVBlockPool``.

    - `prefill_fn`: prompt forward; tokens ``[n]`` ->
      ``{plane: [n, *tail]}`` per-token planes (must match `kv`'s
      value_spec — int8 arenas ride through unchanged)
    - `rpc`: a ``distributed.rpc.RPCClient`` (deadlines, retries,
      breakers); required to actually stream
    - `kv` / `slots` / `max_blocks`: staging-pool shape; slots bounds
      concurrent transfers, and a full pool sheds with
      ``ServerOverloaded`` (busy, not sick — the router fails over
      without a health penalty)
    """

    def __init__(self, prefill_fn, rpc, kv=None, slots=4,
                 max_blocks=64, chunk_bytes=DEFAULT_CHUNK_BYTES,
                 queue_depth=64):
        self.prefill_fn = prefill_fn
        self.rpc = rpc
        cfg = kv if isinstance(kv, PagedKVConfig) \
            else PagedKVConfig(**(kv or {}))
        if not cfg.cache_prefixes:
            raise ValueError(
                "prefill staging pool must cache prefixes: the chain "
                "keys it computes are what the decode pool re-homes")
        self.pool = KVBlockPool(slots, max_blocks, cfg)
        self.chunk_bytes = int(chunk_bytes)
        self._queue = queue.Queue(maxsize=int(queue_depth))
        self._xfer_seq = itertools.count()
        self._stopped = threading.Event()
        self._c = {"prefills": 0, "streamed_bytes": 0,
                   "stream_failures": 0}
        self._c_lock = threading.Lock()
        self._worker = threading.Thread(
            target=self._run, name="prefill-worker", daemon=True)
        self._worker.start()

    # ---- submit ----

    def submit(self, tokens, endpoint, xfer=None, timeout_ms=None):
        """Queue one prompt for prefill + transfer to `endpoint`'s
        kv_stream listener.  Returns a PrefillRequest future resolving
        to the transfer manifest; failures are typed (KVStreamError,
        PoolExhausted, ConnectionError...)."""
        if self._stopped.is_set():
            raise EngineStopped("prefill engine stopped")
        if xfer is None:
            xfer = f"pf-{id(self):x}-{next(self._xfer_seq)}"
        req = PrefillRequest(tokens, endpoint, str(xfer), timeout_ms)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise ServerOverloaded(
                f"prefill queue full ({self._queue.maxsize} deep)") \
                from None
        return req

    # ---- worker ----

    def _run(self):
        while True:
            req = self._queue.get()
            if req is None:
                return
            if req.done():        # cancelled while queued
                continue
            try:
                req._set_result(self._serve(req))
            except BaseException as e:  # noqa: BLE001 — typed via future
                with self._c_lock:
                    self._c["stream_failures"] += 1
                req._set_exception(e)

    def _serve(self, req):
        slot = self._claim_slot()
        span = _trace.TRACER.start_span(
            "disagg/prefill", req._tctx,
            attrs={"n_tokens": int(req.tokens.size),
                   "endpoint": req.endpoint})
        try:
            with _trace.TRACER.use_span(span) if span is not None \
                    else _nullcontext():
                values = self.prefill_fn(req.tokens)
                self.pool.admit(slot, req.tokens, values=values)
        except BaseException as e:
            _trace.TRACER.end_span(span, error=e)
            self.pool.release(slot)
            raise
        _trace.TRACER.end_span(span)

        xspan = _trace.TRACER.start_span(
            "disagg/kv_transfer", req._tctx,
            attrs={"endpoint": req.endpoint, "xfer": req.xfer})
        try:
            with _trace.TRACER.use_span(xspan) if xspan is not None \
                    else _nullcontext():
                manifest = stream_slot(
                    self.rpc, req.endpoint, self.pool, slot, req.xfer,
                    chunk_bytes=self.chunk_bytes,
                    timeout_ms=req.timeout_ms)
        except BaseException as e:
            _trace.TRACER.end_span(xspan, error=e)
            # decode-side cleanup is the sender's job on failure; the
            # ingestor's TTL reaper backstops an unreachable peer
            send_abort(self.rpc, req.endpoint, req.xfer,
                       reason=f"{type(e).__name__}: {e}")
            raise
        finally:
            self.pool.release(slot)
        _trace.TRACER.end_span(
            xspan, bytes=manifest["bytes"], chunks=manifest["chunks"],
            n_blocks=manifest["n_blocks"])
        with self._c_lock:
            self._c["prefills"] += 1
            self._c["streamed_bytes"] += manifest["bytes"]
        return manifest

    def _claim_slot(self):
        snap = self.pool.snapshot()
        for slot in range(self.pool.slots):
            if int(self.pool._nblocks[slot]) == 0:
                return slot
        raise ServerOverloaded(
            f"no free staging slot ({self.pool.slots} busy); "
            f"pool: {snap['blocks_free']} free blocks")

    # ---- lifecycle / observability ----

    def stats(self):
        with self._c_lock:
            out = dict(self._c)
        out["queued"] = self._queue.qsize()
        out["kv"] = self.pool.snapshot()
        return out

    def stop(self, drain=True):
        if self._stopped.is_set():
            return
        self._stopped.set()
        if not drain:
            # fail queued requests instead of serving them
            try:
                while True:
                    req = self._queue.get_nowait()
                    if req is not None:
                        req._set_exception(
                            EngineStopped("prefill engine stopped"))
            except queue.Empty:
                pass
        self._queue.put(None)
        self._worker.join(timeout=30.0)


def _nullcontext():
    import contextlib

    return contextlib.nullcontext()


class PrefillReplica(Replica):
    """A replica hosting prefill engines (kind="prefill") behind the
    standard registry — same atomic name reservation, fault seam,
    outstanding accounting, and stats surface as predict/decode
    hosting, so the router's dispatch core (breakers, failover,
    least-outstanding ordering) applies unchanged to the prefill
    leg."""

    def add_prefill_model(self, model, prefill_fn, rpc, kv=None,
                          slots=4, max_blocks=64,
                          chunk_bytes=DEFAULT_CHUNK_BYTES):
        placeholder = _HostedModel(None, routable=False, warmup_built=0,
                                   kind="prefill")
        with self._lock:
            if model in self._models:
                raise ValueError(
                    f"replica {self.name!r} already hosts {model!r}")
            self._models[model] = placeholder
        try:
            engine = PrefillEngine(prefill_fn, rpc, kv=kv, slots=slots,
                                   max_blocks=max_blocks,
                                   chunk_bytes=chunk_bytes)
        except BaseException:
            with self._lock:
                if self._models.get(model) is placeholder:
                    del self._models[model]
            raise
        placeholder.engine = engine
        placeholder.routable = True
        return engine

    def hosts_prefill(self, model):
        return self.hosts(model, kind="prefill")

    def submit_prefill(self, model, tokens, endpoint, xfer=None,
                       timeout_ms=None):
        """Dispatch one prompt's prefill+transfer leg.  Same fault seam
        and outstanding accounting as submit/submit_decode — an
        injected ConnectionError here is the chaos drill's 'prefill
        replica went dark'."""
        h = self._hosted(model, kind="prefill")
        if self._plan is not None:
            self._plan.hook(f"replica:{self.name}", {"method": model})
        req = h.engine.submit(tokens, endpoint, xfer=xfer,
                              timeout_ms=timeout_ms)
        with self._lock:
            self._inflight.add(req)
        req.add_done_callback(self._request_done)
        return req
