"""Host-side op handlers of the sharded embedding engine (the sharded
arms of ``paddle_tpu/distributed/host_ops.py``).

A ``sharded_lookup_table`` or ``sharded_push_grad`` op cannot run as a
device kernel: it dedups ids on the host and talks to the table's shard
servers; the debug ``print`` op (``layers.Print``) prints a value on the
host.  The Executor dispatches these op types here
(``core/executor.py``).  The parameter-server op types (send, recv,
barriers, ``distributed_lookup_table``, ``listen_and_serv``, ...) are
queued with the pserver tier (ROADMAP queue 1 item 11) and raise.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

HOST_OP_TYPES = {"sharded_lookup_table", "sharded_push_grad", "print"}

# lookup-flavored host ops sharing the issue/collect contract: the
# executor issues at the op and collects before the first reader
LOOKUP_HOST_OPS = {"sharded_lookup_table"}

# host ops of the parameter-server tier: the Executor routes them here
# so they fail with a named error instead of "no kernel registered"
QUEUED_HOST_OP_TYPES = {"send", "recv", "send_barrier", "fetch_barrier",
                        "listen_and_serv", "checkpoint_notify",
                        "distributed_lookup_table", "send_sparse_grad"}


def is_host_op(op_type):
    """Whether the Executor runs `op_type` here instead of through a
    kernel (the engine's host ops and the parameter-server tier's)."""
    return op_type in HOST_OP_TYPES or op_type in QUEUED_HOST_OP_TYPES


def issue_lookup_op(op, env, attrs, tid):
    """Dispatch the ISSUE phase of a lookup host op; returns its
    collect() continuation."""
    from ..sparse.engine import issue_sharded_lookup

    return issue_sharded_lookup(op, env, attrs, tid)


# ---------------------------------------------------------------------------
# Per-endpoint ordered RPC lanes (the reference's DensePullThread /
# AsyncExecutorThreadWorker overlap, executor_thread_worker.h:67,197):
# every RPC to an endpoint runs on that endpoint's single-worker lane, so
#  - RPCs to DIFFERENT shards overlap each other (and the device work
#    dispatched between them), and
#  - issue order per endpoint == apply order: a grad push enqueued
#    before the next step's lookup is observed by it (read-your-writes
#    without any global barrier — async-mode consistency).
# Grad pushes are fire-and-forget (futures tracked, flushed at
# Executor.close()); lookups wait their own futures.
# ---------------------------------------------------------------------------

_lanes = {}
_lanes_lock = threading.Lock()
_pending = {}            # endpoint -> in-flight fire-and-forget sends
_pending_lock = threading.Lock()
_MAX_PENDING = 32        # per-endpoint backpressure bound


def _lane(endpoint):
    with _lanes_lock:
        pool = _lanes.get(endpoint)
        if pool is None:
            pool = _lanes[endpoint] = ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix=f"rpc-lane-{endpoint}")
        return pool


def _track(future, what, endpoint):
    drain = None
    with _pending_lock:
        q = _pending.setdefault(endpoint, [])
        q.append((future, what))
        if len(q) > _MAX_PENDING:
            # backpressure drains the SAME endpoint's oldest push, so a
            # failure always surfaces inside the cluster that caused it
            drain = q.pop(0)
    if drain is not None:         # wait outside the lock
        f, w = drain
        try:
            f.result()
        except Exception as e:    # noqa: BLE001 — keep op context
            raise RuntimeError(f"async push failed: {w}: {e}") from e


def flush_pending_sends(endpoints=None):
    """Barrier semantics: wait until every fire-and-forget push has been
    applied (Executor.close, SparseTableClient.flush).

    endpoints: restrict to pushes destined for these endpoints, so one
    executor's close never consumes — or misattributes the failure of —
    ANOTHER cluster's pushes in the same process."""
    with _pending_lock:
        keys = list(_pending) if endpoints is None else \
            [ep for ep in _pending if ep in set(endpoints)]
        items = []
        for ep in keys:
            items.extend(_pending.pop(ep, []))
    errs = []
    for f, what in items:
        try:
            f.result()
        except Exception as e:        # noqa: BLE001 — aggregate & rethrow
            errs.append(f"{what}: {e}")
    if errs:
        raise RuntimeError("async push failed: " + "; ".join(errs))


def run_host_op(op, env):
    t = op.type
    attrs = op.attrs
    tid = attrs.get("trainer_id", 0)
    if t == "sharded_lookup_table":
        issue_lookup_op(op, env, attrs, tid)()
        return
    if t == "sharded_push_grad":
        from ..sparse.engine import run_sharded_push

        run_sharded_push(op, env, attrs, tid)
        return
    if t == "print":
        import numpy as np
        import torch

        name = op.input("In")[0] if op.input("In") else op.input("X")[0]
        v = env[name]
        if isinstance(v, torch.Tensor):
            v = v.detach().float().cpu().numpy() \
                if v.dtype == torch.bfloat16 else v.detach().cpu().numpy()
        print(f"{attrs.get('message', name)}: {np.asarray(v)}")
        return
    if t in QUEUED_HOST_OP_TYPES:
        raise NotImplementedError(
            f"host op {t!r} belongs to the parameter-server tier, which "
            "the port has not ported yet (ROADMAP queue 1 item 11); the "
            "sharded embedding engine (paddle_tpu_torch.sparse) runs")
    raise NotImplementedError(f"host op {t}")


def send_complete(endpoints, trainer_id=0, client=None):
    """Executor.close() on a trainer of sharded tables (executor.cc:138)."""
    from .rpc import RPCClient

    client = client or RPCClient()
    for ep in endpoints:
        client.send_complete(ep, trainer_id=trainer_id)
