"""Typed binary RPC frames over TCP sockets (the pure-Python transport of
``paddle_tpu/distributed/transport.py``).

No pickle on the wire: the frame is a fixed typed layout, and parsing it
allocates numpy views, never executes anything.  Frames are byte for byte
the JAX package's, so either package's peer decodes the other's.

Layout (little-endian), after a u32 length prefix:
    u8  method
    i32 trainer_id
    u16 name_len, name utf-8
    u8  n_tensors
    n_tensors x { u8 dtype, u8 ndim, i64 dims[ndim], i64 nbytes }
    the n_tensors payloads, in order
    i64 extra
    optional 21-byte trace trailer (see TRACE_MAGIC)

The reference's native arm (``csrc/rpc.cc`` through ctypes: gather-write
sends, zero-copy receives, GIL-free socket I/O) is not ported; this
module is its pure-Python fallback, which speaks the same frames.
"""

import socket
import struct
import threading

import numpy as np

# -- method codes -----------------------------------------------------------

METHODS = {"send": 1, "get": 2, "prefetch": 3, "send_sparse": 4,
           "send_barrier": 5, "fetch_barrier": 6, "complete": 7,
           "reply_ok": 8, "reply_value": 9, "reply_error": 10,
           "get_monomer": 11, "reply_sparse": 12, "ping": 13,
           "checkpoint_notify": 14, "preempt": 15, "cache_fill": 16,
           # sharded embedding-table engine (the JAX package's sparse): ids in
           # these frames are SHARD-LOCAL indices — the client owns the
           # row->shard map and translates, so a shard server never
           # needs the global partition to serve
           "sparse_lookup": 17, "sparse_push": 18,
           # unified telemetry (the JAX package's observability): fetch the
           # peer's MetricsRegistry snapshot — reply_value carries the
           # JSON document as uint8 bytes (no pickle, cache_fill
           # discipline)
           "metrics_pull": 19,
           # elastic scale-out (the JAX package's elastic): membership-change
           # RPCs.  `join` = a new rank announces itself to the
           # coordinator (value tensor: its JSON member record as
           # uint8); `remesh` = the coordinator commits a new
           # generation's membership directive to a member (value
           # tensor: the JSON directive, extra: the new generation);
           # `elastic_step` = one rank's step contribution to the
           # coordinator's reducer (value tensor: a float64 partial-sum
           # vector, name: the generation, extra: the step).
           "join": 20, "remesh": 21, "elastic_step": 22,
           # disaggregated serving (the JAX package's serving.disagg): one
           # chunk of a paged-KV block transfer from a prefill replica
           # to a decode replica.  `meta` = the chunk's JSON header as
           # uint8 (kind/plane/block range/dtype/shape/crc32), `value`
           # = the raw plane bytes as uint8 (empty for control chunks);
           # name carries the transfer id, extra the chunk sequence
           "kv_stream": 23}
METHOD_NAMES = {v: k for k, v in METHODS.items()}

# -- fault-injection seam ---------------------------------------------------
# A single process-wide hook (resilience.FaultPlan.install) sees every
# frame at three seams: client send ("send", msg), client receive
# ("recv", None — before the read), and server dispatch ("serve", msg —
# after decode).  The hook may sleep (delayed frame), raise (errored
# frame), or return "drop" (swallowed frame: the peer sees a silent
# timeout / closed connection).  None installed = zero overhead beyond
# one global read.

_fault_hook = None

# -- trace-context trailer ---------------------------------------------------
# Optional 21 bytes appended AFTER the frame's `extra` i64: magic u32 +
# trace_id u64 + span_id u64 + flags u8 (bit 0 = sampled).  decode()
# parses it only when present AND magic-tagged, so peers interoperate
# freely across versions: an old peer ignores the trailing bytes (its
# decode stops at `extra`), and a frame without the trailer reads as an
# unsampled context (msg carries no "trace" key).  The provider hook is
# installed lazily by observability.propagate — an untraced process
# pays one `is not None` per send, exactly the fault-hook discipline.

TRACE_MAGIC = 0x50545243                 # "CRTP"
_TRACE_TRAILER = struct.Struct("<IQQB")


def pack_trace(trace_id, span_id, flags):
    return _TRACE_TRAILER.pack(TRACE_MAGIC, trace_id, span_id, flags)


_trace_hook = None


def set_trace_hook(hook):
    """Install `hook(msg) -> (trace_id, span_id, flags) | None` (None
    clears); a non-None return rides the frame as the trace trailer."""
    global _trace_hook
    prev = _trace_hook
    _trace_hook = hook
    return prev


def set_fault_hook(hook):
    """Install `hook(where, msg)` (None to clear); returns the previous
    hook.  Deterministic chaos tests drive this via
    ``resilience.faults.FaultPlan``."""
    global _fault_hook
    prev = _fault_hook
    _fault_hook = hook
    return prev


def get_fault_hook():
    return _fault_hook

# tensor slots per method, in wire order
_TENSOR_SLOTS = {"send": ("value",), "prefetch": ("ids",),
                 "send_sparse": ("rows", "values"),
                 "reply_value": ("value",),
                 "reply_sparse": ("rows", "values"),
                 # jitcache fill broadcast: name = entry key, value =
                 # the raw (crc-framed) cache entry bytes as uint8
                 "cache_fill": ("value",),
                 # sparse engine: name = table, ids/rows = local indices
                 "sparse_lookup": ("ids",),
                 "sparse_push": ("rows", "values"),
                 # elastic membership: JSON payloads as uint8 bytes
                 # (join = member record, remesh = directive) and the
                 # float64 step-contribution vector
                 "join": ("value",), "remesh": ("value",),
                 "elastic_step": ("value",),
                 # kv_stream chunk: JSON header + raw plane bytes, both
                 # uint8 (dtype/shape ride the header, not the frame —
                 # the payload is an opaque crc'd byte run)
                 "kv_stream": ("meta", "value")}

_DTYPES = ["float32", "float64", "int32", "int64", "uint8", "bool",
           "float16", "uint32", "uint64", "int16", "int8", "uint16"]
_DTYPE_CODE = {np.dtype(d): i for i, d in enumerate(_DTYPES)}
_CODE_DTYPE = {i: np.dtype(d) for i, d in enumerate(_DTYPES)}
try:  # bf16 rides as a distinct code (numpy has it through ml_dtypes)
    import ml_dtypes

    _DTYPE_CODE[np.dtype(ml_dtypes.bfloat16)] = 12
    _CODE_DTYPE[12] = np.dtype(ml_dtypes.bfloat16)
except ImportError:                                   # pragma: no cover
    pass


def encode(msg):
    """msg dict -> (header bytes, [payload arrays], extra bytes)."""
    method = msg["method"]
    code = METHODS[method]
    name = msg.get("name", "") or (msg.get("error", "")
                                   if method == "reply_error" else "")
    # name/error rides a u16 length — truncate (UTF-8-safely) rather than
    # blow up struct.pack inside a server reply path, where the raised
    # error would be swallowed and the client would only see a generic
    # ConnectionError instead of the handler's message
    nb = name.encode()
    if len(nb) > 0xFFFF:
        nb = nb[:0xFFFF]
        # strip only if the cut split a multibyte character (a cut that
        # lands exactly on a character boundary must keep the final
        # complete character)
        while nb:
            try:
                nb.decode()
                break
            except UnicodeDecodeError:
                nb = nb[:-1]
    tensors = []
    for slot in _TENSOR_SLOTS.get(method, ()):
        a = np.ascontiguousarray(np.asarray(msg[slot]))
        if a.dtype not in _DTYPE_CODE:
            raise TypeError(f"unsupported RPC dtype {a.dtype}")
        tensors.append(a)
    hdr = [struct.pack("<Bi", code, int(msg.get("trainer_id", 0))),
           struct.pack("<H", len(nb)), nb,
           struct.pack("<B", len(tensors))]
    for a in tensors:
        hdr.append(struct.pack("<BB", _DTYPE_CODE[a.dtype], a.ndim))
        hdr.append(struct.pack(f"<{a.ndim}q", *a.shape))
        hdr.append(struct.pack("<q", a.nbytes))
        # payload itself rides separately (see send_frame)
    tail = struct.pack("<q", int(msg.get("round",
                                         msg.get("extra",
                                                 msg.get("step", 0)))))
    return b"".join(hdr), tensors, tail


def decode(buf):
    """One frame (bytes-like over the full payload) -> msg dict.  Tensor
    values are numpy views INTO buf (zero-copy)."""
    view = memoryview(buf)
    off = 0
    code, tid = struct.unpack_from("<Bi", view, off)
    off += 5
    (nlen,) = struct.unpack_from("<H", view, off)
    off += 2
    name = bytes(view[off:off + nlen]).decode()
    off += nlen
    (nt,) = struct.unpack_from("<B", view, off)
    off += 1
    method = METHOD_NAMES.get(code)
    if method is None:
        raise ValueError(f"bad RPC method code {code}")
    # all descriptors first, then the payload blocks in the same order —
    # matching encode/send_frame's gather-write ([hdr][data...][extra])
    descs = []
    for _ in range(nt):
        dt_code, ndim = struct.unpack_from("<BB", view, off)
        off += 2
        dims = struct.unpack_from(f"<{ndim}q", view, off)
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<q", view, off)
        off += 8
        descs.append((_CODE_DTYPE[dt_code], dims, nbytes))
    tensors = []
    for dt, dims, nbytes in descs:
        a = np.frombuffer(view[off:off + nbytes], dtype=dt).reshape(dims)
        off += nbytes
        tensors.append(a)
    (extra,) = struct.unpack_from("<q", view, off)
    off += 8
    msg = {"method": method, "trainer_id": tid}
    # optional trace trailer (see TRACE_MAGIC above): parsed only when
    # the trailing bytes are exactly a magic-tagged trailer; anything
    # else (an old peer, a future extension) is ignored, never an error
    if len(view) - off >= _TRACE_TRAILER.size:
        magic, t_tid, t_sid, t_flags = _TRACE_TRAILER.unpack_from(
            view, off)
        if magic == TRACE_MAGIC:
            msg["trace"] = (t_tid, t_sid, t_flags)
    if method == "reply_error":
        msg["error"] = name
    elif name:
        msg["name"] = name
    for slot, a in zip(_TENSOR_SLOTS.get(method, ()), tensors):
        msg[slot] = a
    if method in ("reply_ok", "reply_value"):
        msg["round"] = extra
        msg.setdefault("ok", True)
    elif method == "checkpoint_notify":
        # name slot carries the checkpoint root dir, extra the step
        msg["dirname"] = name
        msg["step"] = extra
    elif method == "preempt":
        # extra carries the cluster-wide cut step (resilience.preempt)
        msg["step"] = extra
    elif method in ("send_barrier", "fetch_barrier"):
        # extra carries the round the trainer is completing (idempotent
        # barrier retries, rpc.ParameterServer); legacy senders ship 0.
        # The name slot optionally carries the sender's membership
        # GENERATION (the JAX package's elastic): a rank removed at generation
        # G whose delayed retry arrives during G+1 is acked-not-counted
        msg["round"] = extra
        if msg.get("name"):
            try:
                msg["generation"] = int(msg.pop("name"))
            except ValueError:
                pass
    elif method in ("join", "remesh"):
        # extra carries the membership generation
        msg["generation"] = extra
    elif method == "elastic_step":
        # name carries the generation, extra the step
        msg["step"] = extra
        try:
            msg["generation"] = int(msg.pop("name", "") or 0)
        except ValueError:
            msg["generation"] = 0
    elif method == "kv_stream":
        # name carries the transfer id, extra the chunk sequence — the
        # (xfer, seq) pair is the receiver's idempotency key
        msg["xfer"] = msg.pop("name", "")
        msg["seq"] = extra
    return msg


# -- socket transport ---------------------------------------------------------

MAX_FRAME_BYTES = 1 << 30


def send_frame(sock, msg):
    if _fault_hook is not None and \
            _fault_hook("send", msg) == "drop":
        return                       # swallowed frame: peer times out
    hdr, tensors, tail = encode(msg)
    if _trace_hook is not None:
        t = _trace_hook(msg)
        if t is not None:
            tail += pack_trace(*t)
    total = len(hdr) + sum(a.nbytes for a in tensors) + len(tail)
    if total > MAX_FRAME_BYTES:
        # the reference's receivers refuse to allocate on a length above
        # 1 GiB (csrc/rpc.cc kMaxFrameBytes); giant tensors ride sliced
        raise ValueError(
            f"RPC frame too large: {total} bytes > 1 GiB — split the "
            "tensor into row blocks")
    payload = hdr + b"".join(a.tobytes() for a in tensors) + tail
    sock.sendall(struct.pack("<I", len(payload)) + payload)


def recv_frame(sock):
    if _fault_hook is not None and \
            _fault_hook("recv", None) == "drop":
        return None                  # reads as peer-closed
    hdr = b""
    while len(hdr) < 4:
        part = sock.recv(4 - len(hdr))
        if not part:
            return None
        hdr += part
    (n,) = struct.unpack("<I", hdr)
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(1 << 20, n - got))
        if not k:
            return None
        got += k
    return decode(buf)


class Connection:
    """One request/response exchange at a time.

    Reusable across calls: ``call`` closes the socket on ANY failure (a
    timeout or a partial frame leaves the stream position unknowable)
    and reconnects lazily on the next call, so a long-lived holder keeps
    working through a peer restart."""

    def __init__(self, host, port, timeout_ms=180000):
        self.host = host
        self.port = port
        self.timeout_ms = timeout_ms
        self.sock = None
        self._connect()

    def _connect(self):
        self.sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout_ms / 1000)

    @property
    def connected(self):
        return self.sock is not None

    def call(self, msg):
        if not self.connected:
            self._connect()          # lazy reconnect after a failure
        try:
            send_frame(self.sock, msg)
            r = recv_frame(self.sock)
        except Exception:
            self.close()
            raise
        if r is None:
            # timeout / peer died mid-reply: never let a dropped reply
            # read as success (grads silently lost, barrier "passed")
            self.close()
            raise ConnectionError(
                f"RPC reply lost for {msg.get('method')} to "
                f"{self.host}:{self.port} (peer timeout or closed "
                "connection)")
        return r

    def close(self):
        if self.sock is not None:
            self.sock.close()
        self.sock = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class FrameServer:
    """Accept loop: a small pool of acceptor threads hands each request
    to a FRESH per-request thread — handlers may block, so requests must
    never queue behind them.  One request and one reply per connection.

    Bind with port=0 to let the OS pick; the bound port is `.port`.
    ``shutdown`` closes the listening socket and joins the acceptors."""

    def __init__(self, host, port, handler, threads=2):
        self.handler = handler
        self._threads = []
        self._stopped = False
        self.lsock = socket.socket()
        self.lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.lsock.bind((host, port))
        self.lsock.listen(128)
        # a bounded accept wait, so the acceptors see shutdown even on a
        # platform where closing the socket does not wake accept()
        self.lsock.settimeout(0.5)
        self.port = self.lsock.getsockname()[1]
        for _ in range(threads):
            t = threading.Thread(target=self._accept_loop, daemon=True)
            t.start()
            self._threads.append(t)

    def _handle_one(self, conn):
        """Per-request thread: read the frame (bounded by the socket's
        receive timeout), run the handler, reply.  A failing handler
        answers the client instead of killing anything; a malformed frame
        just drops the connection."""
        try:
            try:
                msg = recv_frame(conn)
                if msg is None:
                    return
            except Exception:
                return                # malformed frame: drop, keep serving
            if _fault_hook is not None:
                try:
                    if _fault_hook("serve", msg) == "drop":
                        return        # no reply ever: client times out
                except Exception:
                    return            # injected server fault: close conn
            try:
                reply = self.handler(msg)
            except Exception as e:
                reply = {"method": "reply_error",
                         "error": f"{type(e).__name__}: {e}"}
            try:
                send_frame(conn, reply)
            except Exception:
                pass                  # client gone; nothing to tell it
        finally:
            conn.close()

    def _accept_loop(self):
        while not self._stopped:
            try:
                conn, _ = self.lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                if self._stopped:
                    return
                continue
            conn.settimeout(120)
            threading.Thread(target=self._handle_one, args=(conn,),
                             daemon=True).start()

    def shutdown(self):
        if self._stopped:
            return
        self._stopped = True
        try:
            self.lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.lsock.close()
        for t in self._threads:
            t.join(timeout=5)
