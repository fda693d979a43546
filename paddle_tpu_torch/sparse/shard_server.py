"""One rank's shard of the sharded embedding-table engine (the port of
``paddle_tpu/sparse/shard_server.py``).

A :class:`SparseShardServer` owns the shard-local ``[H_s, D]`` block of
every declared table (plus the touched-rows optimizer slot state) as
host numpy, and serves the engine's two wire methods over the frame
transport:

- ``sparse_lookup`` — batched, deduped, SHARD-LOCAL indices in, value
  block out.  With ``device_table=True`` the block has a mirror on a
  device (``cuda:0`` unless a CPU place is given) and rows gather through
  K11 (``sparse.gather``); the default gathers from the host block with
  a numpy take (the CPU-pserver regime).
- ``sparse_push`` — async touched-rows optimizer update applied on
  arrival under the table lock (no round barrier; read-your-writes
  ordering is the client's per-endpoint lane).

Errors are NAMED: an unknown table or out-of-range index answers a
``reply_error`` carrying the table/shard/endpoint, so a mispartitioned
client fails with a located message instead of a silent wrong row.
``complete`` counts trainers for a clean ``run_until_complete`` exit.
``checkpoint_notify`` raises until ``sparse/checkpoint.py`` is ported
(ROADMAP queue 1 item 11).
"""

import threading

import numpy as np
import torch

from ..core.executor import device_of
from ..core.framework import CUDAPlace
from ..distributed import transport
from .optim import SparseOptimizer


class SparseShardServer:
    """Serve shard `shard_idx` of every table in `tables`.

    tables — {name: ShardedTableConfig}; this server owns shard
    ``shard_idx`` of each (all tables in one job share the shard
    topology, like the reference's pserver tier).  place — where the
    ``device_table`` mirror lives: ``CUDAPlace(0)`` by default, which
    raises without a CUDA device; pass ``CPUPlace()`` to mirror on the
    CPU.
    """

    def __init__(self, endpoint, shard_idx, tables, num_trainers=1,
                 device_table=False, place=None):
        self.endpoint = endpoint
        self.shard_idx = int(shard_idx)
        self.tables = dict(tables)
        self.num_trainers = int(num_trainers)
        self.device_table = bool(device_table)
        self.device = device_of(place if place is not None
                                else CUDAPlace(0)) \
            if self.device_table else None
        self.values = {}
        self.optim = {}
        self._dev = {}               # name -> torch mirror (device_table)
        self._lock = threading.Condition()
        self._completed = set()
        self._server = None
        for name, cfg in self.tables.items():
            if not 0 <= self.shard_idx < cfg.num_shards:
                raise ValueError(
                    f"shard {self.shard_idx} out of range for table "
                    f"{name!r} ({cfg.num_shards} shards)")
            self.values[name] = cfg.init_shard_values(self.shard_idx)
            self.optim[name] = SparseOptimizer(
                cfg.optimizer, cfg.learning_rate,
                self.values[name].shape, cfg.dtype,
                attrs=cfg.optimizer_attrs)

    # -- table access -------------------------------------------------------

    def _cfg(self, name):
        cfg = self.tables.get(name)
        if cfg is None:
            raise KeyError(
                f"sparse table {name!r} not declared on shard server "
                f"{self.endpoint} (shard {self.shard_idx}; have "
                f"{sorted(self.tables)})")
        return cfg

    def _check_local(self, name, ids):
        """Bounds-check shard-local indices (shared by lookup and push: a
        numpy gather would grab the wrong row for a negative index — both
        must surface the same NAMED mispartition error instead)."""
        h = self.values[name].shape[0]
        if ids.size and (ids.min() < 0 or ids.max() >= h):
            bad = int(ids[(ids < 0) | (ids >= h)][0])
            raise IndexError(
                f"local index {bad} outside shard {self.shard_idx} of "
                f"table {name!r} (height {h}) on {self.endpoint} — "
                f"client/server partition mismatch?")

    def load_dense(self, name, dense):
        """Take this shard's rows of a full ``[vocab, D]`` table:
        ``dense[partition.shard_rows(shard_idx)]`` becomes the block (a
        copy), and the device mirror is rebuilt from it at the next
        lookup."""
        cfg = self._cfg(name)
        dense = np.asarray(dense)
        if dense.shape != (cfg.vocab, cfg.dim):
            raise ValueError(f"table {name!r} is [{cfg.vocab}, {cfg.dim}], "
                             f"not {list(dense.shape)}")
        block = dense[cfg.partition.shard_rows(self.shard_idx)].astype(
            np.dtype(cfg.dtype))
        with self._lock:
            self.values[name] = block
            self._dev.pop(name, None)

    def lookup_local(self, name, local_ids):
        """Rows for shard-local indices (host numpy) — the in-process
        fast path the colocated trainer uses directly (no RPC)."""
        self._cfg(name)
        ids = np.asarray(local_ids).reshape(-1)
        self._check_local(name, ids)
        with self._lock:
            if self.device_table:
                from .gather import gather_rows

                dev = self._dev.get(name)
                if dev is None:
                    dev = self._dev[name] = torch.from_numpy(
                        self.values[name]).to(self.device, copy=True)
                return gather_rows(dev, ids).cpu().numpy()
            return self.values[name][ids]

    def push_local(self, name, local_rows, grads):
        """Apply one async touched-rows update (local indices)."""
        self._cfg(name)
        rows = np.asarray(local_rows).reshape(-1).astype(np.int64)
        self._check_local(name, rows)
        with self._lock:
            # SparseOptimizer.apply updates the host block in place
            vals = self.values[name] = self.optim[name].apply(
                self.values[name], rows, grads)
            dev = self._dev.get(name)
            if dev is not None:
                # refresh the mirror by an indexed copy of the TOUCHED
                # rows, in place (O(touched) transfer) — dropping it would
                # make the next lookup re-upload the whole [H_s, D] block
                dev.index_copy_(
                    0, torch.from_numpy(rows).to(self.device),
                    torch.from_numpy(vals[rows]).to(self.device))

    # -- frame handler ------------------------------------------------------

    def _handle(self, msg):
        method = msg["method"]
        if method == "sparse_lookup":
            return {"method": "reply_value",
                    "value": self.lookup_local(msg["name"], msg["ids"])}
        if method == "sparse_push":
            self.push_local(msg["name"], msg["rows"], msg["values"])
            return {"method": "reply_ok"}
        if method == "ping":
            return {"method": "reply_ok"}
        if method == "checkpoint_notify":
            raise NotImplementedError(
                "checkpoint_notify needs sparse/checkpoint.py, which the "
                "port has not ported yet (ROADMAP queue 1 item 11)")
        if method == "complete":
            with self._lock:
                self._completed.add(msg.get("trainer_id", 0))
                self._lock.notify_all()
            return {"method": "reply_ok"}
        return {"method": "reply_error",
                "error": f"sparse shard server {self.endpoint}: "
                         f"unknown method {method!r}"}

    def _handle_framed(self, msg):
        try:
            if msg.get("trace") is not None:
                # propagated trace context: the handler records an
                # rpc/serve/<method> span parented to the remote caller
                from ..observability.trace import TRACER

                return TRACER.serve_framed(self._handle, msg,
                                           endpoint=self.endpoint,
                                           shard=self.shard_idx)
            return self._handle(msg)
        except Exception as e:       # surface named, keep serving
            return {"method": "reply_error",
                    "error": f"{type(e).__name__}: {e}"}

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        host, port = self.endpoint.rsplit(":", 1)
        self._server = transport.FrameServer(host, int(port),
                                             self._handle_framed,
                                             threads=4)
        if int(port) == 0:           # OS-assigned: publish the real one
            self.endpoint = f"{host}:{self._server.port}"
        return self

    @property
    def port(self):
        return self._server.port

    def run_until_complete(self, timeout=None):
        """Serve until every trainer sent ``complete`` (or `timeout`
        seconds passed: returns False), then shut down."""
        with self._lock:
            done = self._lock.wait_for(
                lambda: len(self._completed) >= self.num_trainers,
                timeout=timeout)
        self.shutdown()
        return done

    def shutdown(self):
        if self._server is not None:
            self._server.shutdown()
            self._server = None


def load_table(servers, name, dense):
    """Load a full ``[vocab, D]`` table into its shard servers, shard by
    shard (:meth:`SparseShardServer.load_dense`) — the one way to carry a
    dense table (e.g. the JAX package's, or a startup run's) into the
    sharded engine.  `servers` must hold every shard of the table once."""
    cfg = servers[0]._cfg(name)
    got = sorted(s.shard_idx for s in servers)
    if got != list(range(cfg.num_shards)):
        raise ValueError(f"table {name!r} has shards "
                         f"0..{cfg.num_shards - 1}; servers hold {got}")
    for s in servers:
        s.load_dense(name, dense)
