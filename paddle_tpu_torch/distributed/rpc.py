"""Host-side RPC client of the sharded embedding engine (the part of
``paddle_tpu/distributed/rpc.py`` the engine calls).

Reference: the RPC abstraction of ``operators/distributed/`` —
``RPCClient`` (rpc_client.h:32).  Each call opens one connection over
the typed-frame transport (``distributed/transport.py``), sends one
frame and reads one reply, under a per-method deadline, with
retry-with-backoff for idempotent methods and a per-endpoint circuit
breaker.

Copied: :class:`RetryPolicy` and :class:`RPCClient` with ``_call``,
``sparse_lookup``, ``sparse_push``, ``ping``, ``send_complete`` and
``kv_stream`` (one chunk of a paged-KV transfer to a decode replica,
``serving/disagg/kvstream.py``).  The parameter-server tier
(``ParameterServer``, barriers, heartbeats, the elastic calls, the
transpiler's send/get/prefetch) is queued (ROADMAP queue 1 item 11):
those methods are absent here.
"""

import json
import random
import threading
import time

import numpy as np

from . import transport
from ..resilience import GLOBAL_METRICS
from ..resilience.breaker import CircuitBreaker, CircuitOpenError

# Per-method deadlines (ms) of the methods this client has.  kv_stream:
# one paged-KV chunk (<= chunk_bytes of arena planes) per frame — sized
# for a slow link, not a whole transfer; the sender's per-chunk loop
# re-arms it every frame.
DEFAULT_DEADLINES_MS = {"sparse_lookup": 60000, "sparse_push": 60000,
                        "ping": 3000, "complete": 10000,
                        "kv_stream": 60000}

# Methods safe to retry after a lost reply: reads and probes.  A grad
# push (sparse_push) is NOT — a retried push whose first copy actually
# landed would double-count the gradient.  kv_stream is: every chunk is
# keyed (xfer, seq) and the receiver acks an already-applied seq WITHOUT
# re-applying it (begin re-reserves nothing, commit/abort re-serve the
# stored outcome), and crc'd payloads make a torn re-send detectable.
IDEMPOTENT_METHODS = frozenset({"sparse_lookup", "ping", "complete",
                                "kv_stream"})


class RetryPolicy:
    """Exponential backoff with full jitter for idempotent calls.
    `seed` makes the jitter deterministic."""

    def __init__(self, max_retries=2, backoff_ms=25.0,
                 max_backoff_ms=2000.0, jitter=0.5, seed=None):
        self.max_retries = max(int(max_retries), 0)
        self.backoff_ms = float(backoff_ms)
        self.max_backoff_ms = float(max_backoff_ms)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)

    def sleep_s(self, attempt):
        base = min(self.backoff_ms * (2 ** attempt), self.max_backoff_ms)
        return (base * (1.0 - self.jitter * self._rng.random())) / 1000.0


class RPCClient:
    """Per-method deadlines (DEFAULT_DEADLINES_MS, overridable per
    client), retry-with-backoff+jitter for idempotent methods, and a
    per-endpoint circuit breaker that fails fast after
    `breaker_threshold` consecutive transport failures and half-opens
    after `breaker_reset_s`.  Handler errors (reply_error) are NOT
    breaker failures — the server answered, it's alive."""

    def __init__(self, deadlines=None, retry=None, breaker_threshold=5,
                 breaker_reset_s=5.0, metrics=None):
        self.deadlines = dict(deadlines or {})
        self.retry = retry or RetryPolicy()
        self.breaker_threshold = breaker_threshold
        self.breaker_reset_s = breaker_reset_s
        self.metrics = metrics or GLOBAL_METRICS
        self._breakers = {}
        self._breakers_lock = threading.Lock()

    def breaker(self, endpoint):
        with self._breakers_lock:
            br = self._breakers.get(endpoint)
            if br is None:
                br = self._breakers[endpoint] = CircuitBreaker(
                    self.breaker_threshold, self.breaker_reset_s,
                    metrics=self.metrics, name=endpoint)
            return br

    def _deadline_ms(self, method):
        return self.deadlines.get(method, DEFAULT_DEADLINES_MS[method])

    def _call(self, endpoint, msg, timeout_ms=None):
        method = msg["method"]
        timeout_ms = timeout_ms if timeout_ms is not None \
            else self._deadline_ms(method)
        br = self.breaker(endpoint)
        if not br.allow():
            raise CircuitOpenError(
                f"circuit open for {endpoint} after {br.failures} "
                f"consecutive failures — failing fast, next probe in "
                f"{br.remaining_s():.1f}s")
        host, port = endpoint.rsplit(":", 1)
        retries = self.retry.max_retries \
            if method in IDEMPOTENT_METHODS else 0
        for attempt in range(retries + 1):
            try:
                with transport.Connection(host, int(port),
                                          timeout_ms=timeout_ms) as c:
                    r = c.call(msg)
                br.record_success()
                if isinstance(r, dict) and r.get("error"):
                    raise RuntimeError(
                        f"{endpoint} {method}: {r['error']}")
                return r
            except (OSError, ConnectionError) as e:
                br.record_failure()
                if attempt < retries and br.allow():
                    self.metrics.inc("retries")
                    time.sleep(self.retry.sleep_s(attempt))
                    continue
                raise ConnectionError(
                    f"{endpoint} {method} failed after {attempt + 1} "
                    f"attempt(s) (deadline {timeout_ms}ms): {e}") from e

    def sparse_lookup(self, endpoint, name, local_ids, trainer_id=0):
        """Batched sharded-table row fetch: ONE frame carries the whole
        batch's deduped, SHARD-LOCAL indices for the shard at
        `endpoint`; the reply is the [n, D] value block in request
        order.  Pure read — rides the retry policy."""
        r = self._call(endpoint, {"method": "sparse_lookup",
                                  "name": name,
                                  "ids": np.asarray(local_ids,
                                                    np.int64),
                                  "trainer_id": trainer_id})
        return r["value"]

    def sparse_push(self, endpoint, name, local_rows, values,
                    trainer_id=0):
        """Async sparse-grad push to the owning shard: local row
        indices + summed grads; the shard applies its touched-rows
        optimizer update on arrival (no barrier).  NOT retried — a
        double-applied push is a double-counted gradient."""
        return self._call(endpoint, {"method": "sparse_push",
                                     "name": name,
                                     "rows": np.asarray(local_rows,
                                                        np.int64),
                                     "values": np.asarray(values),
                                     "trainer_id": trainer_id})

    def ping(self, endpoint, timeout_ms=3000, trainer_id=0):
        """Liveness probe: True iff the server answers its request loop."""
        try:
            r = self._call(endpoint,
                           {"method": "ping", "trainer_id": trainer_id},
                           timeout_ms=timeout_ms)
            return bool(isinstance(r, dict) and r.get("ok"))
        except Exception:
            # timeouts, refused connections, AND unparseable peers all
            # classify as not-alive — a probe never propagates parser
            # tracebacks
            return False

    def kv_stream(self, endpoint, xfer, seq, header, payload=b"",
                  trainer_id=0, timeout_ms=None):
        """One chunk of a paged-KV transfer to a decode replica's
        ingest listener (serving.disagg.kvstream).  `header` is the
        chunk's JSON-able dict (kind/plane/block range/crc32), `payload`
        the raw plane bytes.  Rides the full hardening stack: per-chunk
        deadline, retry-with-backoff (chunks are (xfer, seq)-keyed and
        re-delivery-safe), and the per-endpoint breaker."""
        meta = np.frombuffer(json.dumps(header).encode(), np.uint8)
        return self._call(endpoint, {"method": "kv_stream",
                                     "name": str(xfer),
                                     "extra": int(seq),
                                     "meta": meta,
                                     "value": np.frombuffer(
                                         bytes(payload), np.uint8),
                                     "trainer_id": trainer_id},
                          timeout_ms=int(timeout_ms)
                          if timeout_ms is not None else None)

    def send_complete(self, endpoint, trainer_id=0):
        """Executor.close() -> SendComplete (executor.cc:138)."""
        try:
            return self._call(endpoint, {"method": "complete",
                                         "trainer_id": trainer_id})
        except OSError:
            return None
