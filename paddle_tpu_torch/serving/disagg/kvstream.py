"""kv_stream: chunked, crc'd paged-KV block transfer prefill -> decode
(port of ``paddle_tpu/serving/disagg/kvstream.py``, a copy: host Python
over the port's ``FrameServer``; frames are byte for byte the
reference's, so either package's sender streams into the other's
listener).

The transfer unit is exactly the PagedAttention block (the pool's arena
layout): the prefill replica exports a slot's chain —
``[n_blocks, block_size, *tail]`` per plane, int8 K/V arenas + fp32
scale planes in quantized mode (~1/4 the fp32 bytes on the wire) — and
streams it to the decode replica's ingest listener as a sequence of
``kv_stream`` frames:

    begin   reserve blocks decode-side (same allocator as local
            admission: LRU cache eviction under pressure, PoolExhausted
            gates on free blocks exactly like a local prompt)
    block*  one plane x block-range per chunk, crc32-checked payload
    commit  re-home the chain into the decode pool's prefix cache
            (dedup against locally-cached prefixes; COW forks keep
            serving) — the decode leg's ordinary ``admit`` then
            prefix-hits every block
    abort   return every reserved block to the free list (idempotent)

Discipline (rides the hardened RPC client wholesale): per-chunk
deadline, retry-with-backoff — chunks are ``(xfer, seq)``-keyed and the
ingestor acks an already-applied seq WITHOUT re-applying, which is what
makes the method idempotent — and the per-endpoint circuit breaker.  A
failed stream is torn down by an explicit ``abort`` from the sender's
error path, or by the ingestor's TTL reaper when the sender died too
hard to say goodbye; either way the reserved blocks provably return
(``ingest_abort_blocks_returned``, asserted by the chaos drill).

Tracing: the sender wraps each chunk RPC in an ``rpc/kv_stream`` span
and the whole leg in ``disagg/kv_transfer`` — ``critical_path`` bills
both (and the remote ``rpc/serve/kv_stream`` spans) to the
``kv_transfer`` stage, so the transfer leg is first-class in
per-request attribution.
"""

import collections
import json
import threading
import time
import zlib

import numpy as np

from ...distributed.transport import FrameServer
from ...observability import trace as _trace
from ..batcher import ServingError

__all__ = ["KVStreamError", "KVIngestor", "KVStreamServer",
           "stream_slot", "stream_export", "stream_export_multi",
           "send_abort"]

# one chunk's payload budget; at least one block per chunk regardless
DEFAULT_CHUNK_BYTES = 1 << 20


class KVStreamError(ServingError):
    """Typed kv_stream failure: crc mismatch, unknown transfer, plane
    mismatch, or a peer's reply_error — the DisaggRouter's signal to
    abort the transfer and fall back to co-located serving."""


def _json_bytes(obj):
    return np.frombuffer(json.dumps(obj).encode(), np.uint8)


def _meta(msg):
    try:
        return json.loads(bytes(msg["meta"]).decode())
    except (KeyError, ValueError) as e:
        raise KVStreamError(f"malformed kv_stream header: {e}") from e


class KVIngestor:
    """Decode-side protocol state machine over one ``KVBlockPool``.

    Chunk handling is (xfer, seq)-idempotent: every applied seq is
    remembered per transfer, and finalized transfers keep their
    outcome in a bounded LRU so a timeout-retried commit/abort is
    re-acked from the stored result instead of re-applied."""

    def __init__(self, pool, ttl_s=60.0):
        self.pool = pool
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._live = {}     # xfer -> {"applied": set, "t": last activity}
        self._done = collections.OrderedDict()  # xfer -> reply dict
        self._done_cap = 256
        self._c = {"chunks": 0, "dup_chunks": 0, "crc_errors": 0,
                   "streams_committed": 0, "streams_aborted": 0,
                   "streams_reaped": 0}

    def counters(self):
        with self._lock:
            return dict(self._c)

    def _reap_locked(self, now):
        stale = [x for x, st in self._live.items()
                 if now - st["t"] > self.ttl_s]
        for x in stale:
            del self._live[x]
            self.pool.abort_ingest(x)
            self._c["streams_reaped"] += 1
            self._finish_locked(x, self._ok(0, outcome="reaped"))

    def _finish_locked(self, xfer, reply):
        self._done[xfer] = reply
        while len(self._done) > self._done_cap:
            self._done.popitem(last=False)

    @staticmethod
    def _ok(seq, **extra):
        r = {"method": "reply_ok", "round": int(seq)}
        if extra:
            r = {"method": "reply_value", "round": int(seq),
                 "value": _json_bytes(extra)}
        return r

    def handle(self, msg):
        """FrameServer handler for one kv_stream frame.  Raises
        KVStreamError on protocol violations (the server shapes it
        into a reply_error; the sender re-raises it typed)."""
        xfer, seq = msg.get("xfer", ""), int(msg.get("seq", 0))
        meta = _meta(msg)
        kind = meta.get("kind")
        now = time.monotonic()
        with self._lock:
            self._reap_locked(now)
            self._c["chunks"] += 1
            done = self._done.get(xfer)
            if done is not None:
                # finalized transfer: re-serve the stored outcome (a
                # retried commit/abort), or plain-ack a straggler chunk
                self._c["dup_chunks"] += 1
                return done if kind in ("commit", "abort") \
                    else self._ok(seq)
            st = self._live.get(xfer)
            if st is not None and seq in st["applied"]:
                self._c["dup_chunks"] += 1      # re-delivered chunk:
                st["t"] = now                   # ack, never re-apply
                return self._ok(seq)
        if kind == "begin":
            if int(meta["block_size"]) != self.pool.block_size:
                raise KVStreamError(
                    f"block_size mismatch: sender "
                    f"{meta['block_size']}, pool {self.pool.block_size}"
                    " — prefill and decode tiers must share the paged"
                    " layout")
            n = self.pool.begin_ingest(xfer, int(meta["n_tokens"]))
            reply = self._ok(seq, reserved=int(n))
        elif kind == "block":
            payload = bytes(msg.get("value", b""))
            if zlib.crc32(payload) != int(meta["crc"]):
                with self._lock:
                    self._c["crc_errors"] += 1
                raise KVStreamError(
                    f"crc mismatch on {xfer!r} chunk {seq} "
                    f"(plane {meta.get('plane')!r}) — torn frame, "
                    f"sender should retry")
            arr = np.frombuffer(payload, np.dtype(meta["dtype"])) \
                .reshape(meta["shape"])
            start = int(meta["start"])
            for i in range(arr.shape[0]):
                self.pool.ingest_block(xfer, start + i,
                                       meta["plane"], arr[i])
            reply = self._ok(seq)
        elif kind == "commit":
            try:
                registered, deduped = self.pool.commit_ingest(xfer)
            except KeyError as e:
                raise KVStreamError(
                    f"commit for unknown transfer {xfer!r} (reaped or"
                    f" never begun)") from e
            reply = self._ok(seq, registered=int(registered),
                             deduped=int(deduped))
            with self._lock:
                self._c["streams_committed"] += 1
                self._live.pop(xfer, None)
                self._finish_locked(xfer, reply)
            return reply
        elif kind == "abort":
            returned = self.pool.abort_ingest(xfer)
            reply = self._ok(seq, returned=int(returned))
            with self._lock:
                self._c["streams_aborted"] += 1
                self._live.pop(xfer, None)
                self._finish_locked(xfer, reply)
            return reply
        else:
            raise KVStreamError(f"unknown kv_stream kind {kind!r}")
        with self._lock:
            st = self._live.setdefault(
                xfer, {"applied": set(), "t": now})
            st["applied"].add(seq)
            st["t"] = now
        return reply


class KVStreamServer:
    """A decode replica's ingest listener: a FrameServer dispatching
    ``kv_stream`` frames into a :class:`KVIngestor` over the replica's
    paged pool.  Bind with port=0 to let the OS pick; the endpoint is
    ``.endpoint``.  Propagated trace trailers open
    ``rpc/serve/kv_stream`` spans (the shared serve_framed seam)."""

    def __init__(self, pool, host="127.0.0.1", port=0, ttl_s=60.0,
                 threads=2):
        self.ingestor = KVIngestor(pool, ttl_s=ttl_s)
        self._server = FrameServer(host, port, self._handle,
                                   threads=threads)
        self.host = host
        self.port = self._server.port
        self.endpoint = f"{host}:{self.port}"

    def _handle(self, msg):
        if msg.get("method") != "kv_stream":
            return {"method": "reply_error",
                    "error": f"KVStreamError: unexpected method "
                             f"{msg.get('method')!r} on a kv_stream "
                             f"listener"}
        return _trace.TRACER.serve_framed(self.ingestor.handle, msg)

    def shutdown(self):
        self._server.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


def _call(rpc, endpoint, xfer, seq, header, payload=b"",
          timeout_ms=None):
    """One chunk through the hardened client, with reply_error mapped
    to the typed KVStreamError (RPCClient surfaces handler errors as
    RuntimeError; transport failures stay ConnectionError/OSError for
    the breaker/fallback discipline)."""
    sp = _trace.TRACER.start_span(
        "rpc/kv_stream", _trace.current(),
        attrs={"endpoint": endpoint, "xfer": xfer, "seq": int(seq),
               "bytes": len(payload)})
    try:
        with _trace.TRACER.use_span(sp) if sp is not None \
                else _nullcontext():
            r = rpc.kv_stream(endpoint, xfer, seq, header, payload,
                              timeout_ms=timeout_ms)
    except RuntimeError as e:
        _trace.TRACER.end_span(sp, error=e)
        if isinstance(e, (ConnectionError, OSError)):
            raise
        raise KVStreamError(str(e)) from e
    except BaseException as e:
        _trace.TRACER.end_span(sp, error=e)
        raise
    _trace.TRACER.end_span(sp)
    if isinstance(r, dict) and "value" in r:
        try:
            return json.loads(bytes(np.asarray(r["value"],
                                               np.uint8)).decode())
        except ValueError:
            return {}
    return {}


def _nullcontext():
    import contextlib

    return contextlib.nullcontext()


def _build_frames(export, chunk_bytes=DEFAULT_CHUNK_BYTES):
    """Serialize an ``export_slot()`` snapshot ONCE into the ordered
    kv_stream frame list ``[(seq, header, payload), ...]`` — begin,
    per-plane crc'd block chunks, commit.  Fanning the same frames out
    to N receivers costs one serialization total, not one per target.
    Returns
    ``(frames, base_manifest)``."""
    planes = export["planes"]
    n_blocks = int(export["n_blocks"])
    frames = [(0, {"kind": "begin",
                   "n_tokens": int(export["n_tokens"]),
                   "block_size": int(export["block_size"]),
                   "planes": {n: {"dtype": str(a.dtype),
                                  "tail": list(a.shape[2:])}
                              for n, a in planes.items()}}, b"")]
    seq = 0
    total = 0
    by_plane = {}
    for name in sorted(planes):
        arr = np.ascontiguousarray(planes[name])
        per_block = max(1, arr[:1].nbytes)
        step = max(1, int(chunk_bytes) // per_block)
        sent = 0
        for start in range(0, n_blocks, step):
            seg = arr[start:start + step]
            payload = seg.tobytes()
            seq += 1
            frames.append((seq,
                           {"kind": "block", "plane": name,
                            "start": start, "shape": list(seg.shape),
                            "dtype": str(seg.dtype),
                            "crc": zlib.crc32(payload)}, payload))
            sent += len(payload)
        by_plane[name] = sent
        total += sent
    seq += 1
    frames.append((seq, {"kind": "commit"}, b""))
    return frames, {"n_tokens": int(export["n_tokens"]),
                    "n_blocks": n_blocks, "chunks": seq + 1,
                    "bytes": total, "bytes_by_plane": by_plane}


def stream_export(rpc, endpoint, export, xfer,
                  chunk_bytes=DEFAULT_CHUNK_BYTES, timeout_ms=None):
    """Stream an already-exported chain snapshot to one ingest
    listener.  A drain path (the reference's serving.elastic) exports a
    slot, FREES it locally, then streams the snapshot — so the export
    argument is first-class here, not an internal detail.

    On ANY failure the caller owns cleanup (the original exception
    propagates untouched — ConnectionError keeps feeding the breaker
    discipline): ``send_abort`` best-effort frees the receiver's
    reservation, and the ingestor's TTL reaper covers the case where
    even the abort cannot get through."""
    frames, base = _build_frames(export, chunk_bytes)
    r = {}
    for seq, header, payload in frames:
        r = _call(rpc, endpoint, xfer, seq, header, payload,
                  timeout_ms=timeout_ms)
    return {"xfer": xfer, **base,
            "registered": int(r.get("registered", 0)),
            "deduped": int(r.get("deduped", 0))}


def stream_slot(rpc, endpoint, pool, slot, xfer,
                chunk_bytes=DEFAULT_CHUNK_BYTES, timeout_ms=None):
    """Stream a prefill-side slot's chain to `endpoint`'s ingest
    listener: export under the pool lock, then begin / block chunks /
    commit.  Returns the transfer manifest — token and block counts,
    chunk count, payload bytes total and per plane (the int8-arena
    bytes the acceptance criteria compare against fp32).

    On ANY failure the caller owns cleanup: ``send_abort`` (best
    effort) frees the decode-side reservation, and the ingestor's TTL
    reaper covers the case where even the abort cannot get through."""
    return stream_export(rpc, endpoint, pool.export_slot(slot), xfer,
                         chunk_bytes=chunk_bytes, timeout_ms=timeout_ms)


def stream_export_multi(rpc, endpoints, export, xfer,
                        chunk_bytes=DEFAULT_CHUNK_BYTES,
                        timeout_ms=None):
    """Stream one exported chain to N ingest listeners, serializing
    each frame ONCE (payload bytes + crc shared across targets; frames
    fan out in protocol order, so all receivers progress together).
    A target that fails mid-stream is dropped — its reservation is
    best-effort aborted — while the surviving targets finish; once no
    target is left alive the remaining frames are skipped.

    Returns ``{"manifests": {endpoint: manifest},
    "errors": {endpoint: exception}}``.  Raises only when NOTHING
    committed: the single-target case re-raises the original exception
    (so breaker/fallback discipline sees ConnectionError untouched),
    the multi-target all-failed case raises an aggregate
    KVStreamError naming every target's failure."""
    endpoints = list(endpoints)
    if not endpoints:
        raise KVStreamError("stream_export_multi: no target endpoints")
    frames, base = _build_frames(export, chunk_bytes)
    alive = dict.fromkeys(endpoints, True)
    errors = {}
    commits = {}
    for seq, header, payload in frames:
        targets = [ep for ep in endpoints if alive[ep]]
        if not targets:
            break
        for ep in targets:
            try:
                r = _call(rpc, ep, xfer, seq, header, payload,
                          timeout_ms=timeout_ms)
                if header["kind"] == "commit":
                    commits[ep] = r
            except (KVStreamError, ConnectionError, OSError) as e:
                alive[ep] = False
                errors[ep] = e
                send_abort(rpc, ep, xfer,
                           reason=f"multi-target peer failed: "
                                  f"{type(e).__name__}",
                           timeout_ms=timeout_ms)
    if not commits:
        if len(endpoints) == 1:
            raise errors[endpoints[0]]
        raise KVStreamError(
            f"kv_stream to all {len(endpoints)} targets failed: "
            + "; ".join(f"{ep}: {type(e).__name__}: {e}"
                        for ep, e in errors.items()))
    manifests = {
        ep: {"xfer": xfer, **base,
             "registered": int(r.get("registered", 0)),
             "deduped": int(r.get("deduped", 0))}
        for ep, r in commits.items()}
    return {"manifests": manifests, "errors": errors}


def send_abort(rpc, endpoint, xfer, reason="", timeout_ms=None):
    """Best-effort decode-side teardown of a failed transfer; swallows
    transport errors (the TTL reaper is the backstop) and returns the
    number of blocks the abort freed, or None when unreachable."""
    try:
        r = _call(rpc, endpoint, xfer, 1 << 30,
                  {"kind": "abort", "reason": str(reason)},
                  timeout_ms=timeout_ms)
        return int(r.get("returned", 0))
    except (KVStreamError, ConnectionError, OSError):
        return None
