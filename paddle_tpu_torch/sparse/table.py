"""Sharded-table declarations: the process-wide registry the engine and
the op dispatch consult (a copy of ``paddle_tpu/sparse/table.py``).

A table is *declared* sharded with :func:`declare_sharded_table`; from
then on ``sparse.shard_program`` rewrites lookups on it into the
engine's host ops.  Tables
below ``FLAGS_sparse_shard_min_rows`` stay on the dense path by design
— sharding a tiny table buys nothing and costs an RPC per batch — and
the skip is warned once, naming the table and both numbers.
"""

import sys
import threading

import numpy as np

from .partition import RowPartition


class ShardedTableConfig:
    """Declaration of one row-sharded embedding table.

    endpoints — one ``host:port`` per shard (len == num_shards); the
    shard index IS the position in this list.  ``local_shard`` may name
    a shard served in-process (trainer-colocated rank): lookups for it
    bypass RPC and gather straight from the local server's device/host
    table.
    """

    def __init__(self, name, vocab, dim, endpoints, dtype="float32",
                 padding_idx=-1, optimizer="sgd", learning_rate=0.01,
                 init_scale=0.01, seed=0, optimizer_attrs=None):
        self.name = name
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.endpoints = list(endpoints)
        if not self.endpoints:
            raise ValueError(f"sharded table {name!r} needs >= 1 "
                             "endpoint (one per shard)")
        self.num_shards = len(self.endpoints)
        self.partition = RowPartition(self.vocab, self.num_shards)
        self.dtype = dtype
        from ..ops.nn_ops import normalize_padding_idx

        self.padding_idx = normalize_padding_idx(padding_idx, self.vocab)
        self.optimizer = optimizer
        self.learning_rate = float(learning_rate)
        self.init_scale = float(init_scale)
        self.seed = int(seed)
        self.optimizer_attrs = dict(optimizer_attrs or {})

    def init_shard_values(self, shard_idx, num_shards=None):
        """Deterministic initial values for one shard's local block —
        seeded per (table seed, shard), so a restarted shard server
        reconstructs the identical block it first served (what keeps a
        kill-before-first-checkpoint resume on the baseline
        trajectory)."""
        part = self.partition if num_shards is None else \
            RowPartition(self.vocab, num_shards)
        h = part.shard_height(shard_idx)
        rng = np.random.RandomState(
            (self.seed * 1000003 + shard_idx * 7919) % (2 ** 31))
        if self.init_scale == 0.0:
            return np.zeros((h, self.dim), self.dtype)
        return rng.uniform(-self.init_scale, self.init_scale,
                           (h, self.dim)).astype(self.dtype)

    def meta(self):
        """The IR-visible declaration record ``shard_program`` stamps
        onto rewritten programs (what the verifier's
        sparse-undeclared-table rule checks against)."""
        return {"vocab": self.vocab, "dim": self.dim,
                "num_shards": self.num_shards,
                "endpoints": list(self.endpoints),
                "dtype": self.dtype, "padding_idx": self.padding_idx}

    def __repr__(self):
        return (f"ShardedTableConfig({self.name!r}, vocab={self.vocab}, "
                f"dim={self.dim}, shards={self.num_shards}, "
                f"opt={self.optimizer!r})")


# -- process-wide registry --------------------------------------------------

_TABLES = {}
_LOCAL_SERVERS = {}          # (table, shard_idx) -> SparseShardServer
_lock = threading.Lock()


def declare_sharded_table(name, vocab, dim, endpoints, **kw):
    """Declare (or re-declare) a sharded table; returns the config."""
    cfg = ShardedTableConfig(name, vocab, dim, endpoints, **kw)
    with _lock:
        _TABLES[name] = cfg
    return cfg


def get_table(name):
    with _lock:
        return _TABLES.get(name)


def is_sharded(name):
    with _lock:
        return name in _TABLES


def tables():
    with _lock:
        return dict(_TABLES)


def bind_local_server(name, shard_idx, server):
    """Register an in-process shard server so the client short-circuits
    RPC for the shard this rank itself owns (the colocated-rank path:
    the locally-owned rows gather on-device, never over the wire)."""
    with _lock:
        _LOCAL_SERVERS[(name, int(shard_idx))] = server


def local_server(name, shard_idx):
    with _lock:
        return _LOCAL_SERVERS.get((name, int(shard_idx)))


def clear_tables():
    """Test hygiene: drop every declaration and local binding — and the
    engine's cached clients, so a re-declared table can't route through
    a stale RowPartition."""
    with _lock:
        _TABLES.clear()
        _LOCAL_SERVERS.clear()
    from .engine import clear_clients

    clear_clients()


# -- warn-once notices -----------------------------------------------------

_warned = set()


def warn_once(key, message):
    """Print `message` to stderr at most once per process per `key`."""
    with _lock:
        if key in _warned:
            return False
        _warned.add(key)
    print(f"[paddle_tpu_torch.sparse] {message}", file=sys.stderr)
    return True
