"""Cross-host trace-context propagation over the frame transport (a copy
of ``paddle_tpu/observability/propagate.py``).

The wire format is owned by ``distributed.transport`` (a 21-byte
trailer after the frame's ``extra`` i64).  :func:`ensure_installed`
registers a provider hook with the transport: a frame sent while a
SAMPLED context is ambient on the sending thread carries the trailer,
so the receiving shard server's span parents under the caller's.
Installation is LAZY (the tracer's first sampled span): a process that
never samples never touches the transport.
"""

from .trace import TRACER, current

_installed = False


def _wire_provider(msg):
    """transport.send_frame hook: the trailer triple for the ambient
    sampled context, or None (no trailer)."""
    ctx = current()
    if ctx is None or not ctx.sampled:
        return None
    TRACER._c["propagated_out"] += 1     # int += under the GIL
    return ctx.to_wire()


def ensure_installed():
    """Idempotently register the trailer provider with the transport."""
    global _installed
    if _installed:
        return
    from ..distributed import transport

    transport.set_trace_hook(_wire_provider)
    _installed = True
