"""Micro-batch admission queue.

Concurrent `submit()` calls land in one bounded, priority-aware FIFO;
the engine's worker pulls *coalesced* batches off it: the head request
defines the shape group, the worker lingers up to ``max_wait_ms`` for
same-shaped followers (or until ``max_batch_size`` rows accumulate), and
everything else stays queued for a later batch.  Admission control is
strictly non-blocking — a full queue sheds with a typed
``ServerOverloaded`` immediately instead of back-pressuring the caller
thread into a stall, the standard serving posture (fail fast, let the
client retry against a replica).  Requests carry deadlines and support
cancellation; both are resolved with typed errors so callers can
distinguish shed/expired/cancelled from a genuine model failure.

Priorities (the SLA-class substrate the fleet router maps classes onto):
a higher-priority request queue-jumps ahead of every strictly-lower-
priority request already waiting (FIFO *within* a priority level), and
when the queue is full an arriving higher-priority request sheds the
newest lowest-priority entry instead of itself — low classes absorb
overload first, in admission order.  Priority 0 everywhere reproduces
the plain FIFO exactly.
"""

import collections
import threading
import time

from ..observability.trace import current_sampled as _current_trace


class ServingError(RuntimeError):
    """Base class for typed serving failures."""


class ServerOverloaded(ServingError):
    """Admission queue is full; the request was shed, not enqueued."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before it reached the device."""


class RequestCancelled(ServingError):
    """The caller cancelled the request before it executed."""


class EngineStopped(ServingError):
    """The engine is shut down (or draining) and admits no new work."""


class ResolvableFuture:
    """Single-assignment future with typed-error resolution and done
    callbacks — the shared result discipline of batch requests
    (:class:`Request`) and continuous-decode requests
    (``fleet.continuous.DecodeRequest``).

    Whoever resolves first (worker result, deadline expiry, cancel)
    wins; later attempts are no-ops.  The lock makes check-then-set
    atomic — a ``cancel()`` racing the worker's completion must not let
    both claim the win.  Done callbacks run OUTSIDE the resolve lock
    (on the resolving thread), so a callback may safely re-enter the
    engine/router that owns the request.
    """

    __slots__ = ("_event", "_result", "_exc", "_resolve_lock",
                 "_callbacks")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exc = None
        self._resolve_lock = threading.Lock()
        self._callbacks = []

    def done(self):
        return self._event.is_set()

    def cancelled(self):
        return isinstance(self._exc, RequestCancelled)

    def cancel(self):
        """Best-effort: resolves the handle immediately; the worker
        skips already-resolved requests when forming batches.  Returns
        False if the request already completed."""
        return self._set_exception(RequestCancelled("cancelled by caller"))

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request result not ready within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request result not ready within {timeout}s")
        return self._exc

    def add_done_callback(self, fn):
        """Run ``fn(self)`` when the request resolves (any outcome).
        If it already resolved, ``fn`` runs inline NOW — the caller
        never misses the edge.  Callback exceptions are swallowed: an
        observer must not kill the resolving worker."""
        with self._resolve_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    def _run_callback(self, fn):
        try:
            fn(self)
        except Exception:                # noqa: BLE001 — observer only
            pass

    def _set_result(self, value):
        with self._resolve_lock:
            if self._event.is_set():
                return False
            self._result = value
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            self._run_callback(fn)
        return True

    def _set_exception(self, exc):
        with self._resolve_lock:
            if self._event.is_set():
                return False
            self._exc = exc
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            self._run_callback(fn)
        return True


class Request(ResolvableFuture):
    """Future-like handle returned by submit().

    `feed` holds the normalized (padded) input dict; `meta` carries
    engine-private per-request state (original row count / seq lens for
    unpadding); `priority` is the admission rank (see module docstring)
    and `sla` the class name the fleet router stamped it with (None for
    direct engine submits).
    """

    __slots__ = ("feed", "key", "nrows", "meta", "enq_t", "deadline",
                 "priority", "sla", "trace")

    def __init__(self, feed, key, nrows, deadline=None, meta=None,
                 priority=0, sla=None):
        super().__init__()
        self.feed = feed
        self.key = key
        self.nrows = nrows
        self.meta = meta or {}
        self.enq_t = time.perf_counter()
        self.deadline = deadline
        self.priority = int(priority)
        self.sla = sla
        # the sampled TraceContext ambient at submit time (None when
        # untraced — one thread-local read, no allocation): the engine
        # worker parents this request's queue/compute spans under it
        self.trace = _current_trace()


def pick_preemption_victim(queue, priority):
    """Newest queued entry of the LOWEST priority strictly below
    `priority` — what a full queue sheds to admit a more important
    newcomer.  None when nothing outranks.  Shared by the MicroBatcher
    and the continuous-decode wait queue (one SLA substrate, one
    tie-break rule)."""
    victim = None
    for r in queue:                      # left -> right = oldest first
        if r.done():
            continue
        if r.priority < priority and \
                (victim is None or r.priority <= victim.priority):
            victim = r                   # ties: keep scanning = newest
    return victim


def priority_insert(queue, req):
    """Queue-jump insert into a deque ordered by priority: ahead of
    every strictly-lower-priority entry, behind all same-or-higher
    (FIFO within a level)."""
    if not queue or queue[-1].priority >= req.priority:
        queue.append(req)
        return
    idx = len(queue)
    while idx > 0 and queue[idx - 1].priority < req.priority:
        idx -= 1
    queue.insert(idx, req)


class MicroBatcher:
    """Bounded priority FIFO + shape-grouped coalescing pop."""

    def __init__(self, max_batch_size, max_wait_ms, max_queue_size,
                 metrics=None):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self.max_queue_size = max_queue_size
        self._metrics = metrics
        self._q = collections.deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False

    def submit(self, feed, key, nrows, deadline=None, meta=None,
               priority=0, sla=None):
        if nrows > self.max_batch_size:
            raise ServingError(
                f"request rows ({nrows}) exceed max_batch_size "
                f"({self.max_batch_size}) — split the request")
        req = Request(feed, key, nrows, deadline, meta,
                      priority=priority, sla=sla)
        shed = None
        with self._cond:
            if self._closed:
                raise EngineStopped("engine is stopped; submit refused")
            if len(self._q) >= self.max_queue_size:
                shed = pick_preemption_victim(self._q, req.priority)
                if shed is None:
                    if self._metrics:
                        self._metrics.inc("shed_overloaded")
                    raise ServerOverloaded(
                        f"admission queue full ({self.max_queue_size} "
                        f"pending); request shed")
                self._q.remove(shed)
            # counted BEFORE the request becomes visible to the worker:
            # a snapshot can then never observe completed > submitted
            # (the torn-export class the stats() contract rules out)
            if self._metrics:
                self._metrics.inc("submitted")
            priority_insert(self._q, req)
            self._cond.notify_all()
        if shed is not None:
            # resolve outside the queue lock: the victim's done
            # callbacks (fleet outstanding-work accounting) may re-enter
            shed._set_exception(ServerOverloaded(
                f"shed for a priority-{req.priority} admission "
                f"(queue full, this request was the newest "
                f"priority-{shed.priority} entry)"))
            if self._metrics:
                self._metrics.inc("shed_preempted")
        return req

    def pending(self):
        with self._lock:
            return len(self._q)

    def close(self):
        """Stop admitting; queued work stays for the worker to drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self):
        return self._closed

    def _reap(self, req, now, expired):
        """Whether a queued request is no longer runnable.  An expired
        request is APPENDED to `expired`, not resolved here — resolving
        runs done callbacks, and a callback that re-enters the batcher
        (retry-on-expiry) would deadlock on the queue lock the caller
        holds.  next_batch resolves the list after releasing it."""
        if req.done():          # cancelled (or resolved by a racing path)
            if self._metrics and req.cancelled():
                self._metrics.inc("cancelled")
            return True
        if req.deadline is not None and now >= req.deadline:
            expired.append(req)
            if self._metrics:
                self._metrics.inc("expired")
            return True
        return False

    def next_batch(self, timeout=0.1):
        """Pop one coalesced same-shape batch, or None on timeout / when
        closed with an empty queue (the worker's exit signal)."""
        expired = []
        try:
            with self._cond:
                return self._next_batch_locked(timeout, expired)
        finally:
            # outside the queue lock: done callbacks may re-enter
            for r in expired:
                r._set_exception(DeadlineExceeded(
                    "deadline passed while queued"))

    def _next_batch_locked(self, timeout, expired):
        deadline = time.perf_counter() + timeout
        while not self._q:
            if self._closed:
                return None
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                return None
            self._cond.wait(remaining)

        # drop dead requests off the head so a live one defines the
        # shape group
        now = time.perf_counter()
        while self._q and self._reap(self._q[0], now, expired):
            self._q.popleft()
        if not self._q:
            return None

        head = self._q[0]
        # linger for same-shaped followers: the window is anchored at
        # the HEAD's enqueue time, so a request's queue latency is
        # bounded by max_wait even when the worker picks it up late
        window_end = head.enq_t + self.max_wait_s
        while not self._closed:
            avail = sum(r.nrows for r in self._q
                        if r.key == head.key and not r.done())
            remaining = window_end - time.perf_counter()
            if avail >= self.max_batch_size or remaining <= 0:
                break
            self._cond.wait(remaining)

        batch, rows, keep = [], 0, collections.deque()
        now = time.perf_counter()
        while self._q:
            r = self._q.popleft()
            if self._reap(r, now, expired):
                continue
            if r.key == head.key and \
                    rows + r.nrows <= self.max_batch_size:
                batch.append(r)
                rows += r.nrows
            else:
                keep.append(r)
        keep.extend(self._q)
        self._q = keep
        if self._q:
            # other shape groups (or overflow rows) remain runnable
            self._cond.notify_all()
        return batch or None
