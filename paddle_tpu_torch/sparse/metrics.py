"""Sparse-engine metrics: dedup/padding ratios, RPC fan-out, and
lookup/push latency histograms — exported as a plain dict exactly like
``serving.metrics`` (a copy of ``paddle_tpu/sparse/metrics.py``).

The load-bearing counters:

- ``ids_total`` vs ``ids_unique`` — the batch dedup ratio.  A CTR batch
  repeats hot ids constantly; every duplicate removed is one row that
  never crosses the wire or device memory.
- ``rows_padded`` — rows added by bucket padding of the unique-id count
  (stable shapes for the device gather), the sparse analogue of the
  serving batcher's pad-to-bucket waste.
- ``rpc_calls`` vs ``lookups`` — shard fan-out per lookup (the batched
  engine does ≤ num_shards RPCs per batch; the naive path does O(ids)).
"""

import threading

from ..observability.hist import Histogram


class SparseMetrics:
    """One process's sparse-engine counters; mutators take the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()
        from ..observability import REGISTRY

        REGISTRY.attach("sparse", self)

    def reset(self):
        with self._lock:
            self.lookup_ms = Histogram()   # issue -> rows assembled
            self.push_ms = Histogram()     # merge+route (client side)
            self._c = {
                "lookups": 0,          # batched lookup calls
                "ids_total": 0,        # ids requested (incl. duplicates)
                "ids_unique": 0,       # ids after host-side dedup
                "rows_padded": 0,      # bucket-padding rows added
                "rpc_calls": 0,        # per-shard lookup RPCs issued
                "rpc_rows": 0,         # rows fetched over RPC
                "local_gather_rows": 0,  # rows served by the in-process
                                         # shard (no RPC)
                "pushes": 0,           # batched grad pushes
                "push_rows": 0,        # unique rows pushed
                "push_rpc_calls": 0,
                "shard_errors": 0,     # named shard-loss errors raised
            }

    def inc(self, name, n=1):
        with self._lock:
            self._c[name] += n

    def get(self, name):
        with self._lock:
            return self._c[name]

    def observe_lookup(self, total_ids, unique_ids, padded_rows,
                       rpc_calls, rpc_rows, local_rows, ms):
        with self._lock:
            self._c["lookups"] += 1
            self._c["ids_total"] += int(total_ids)
            self._c["ids_unique"] += int(unique_ids)
            self._c["rows_padded"] += int(padded_rows)
            self._c["rpc_calls"] += int(rpc_calls)
            self._c["rpc_rows"] += int(rpc_rows)
            self._c["local_gather_rows"] += int(local_rows)
            self.lookup_ms.observe(ms)

    def observe_push(self, rows, rpc_calls, ms):
        with self._lock:
            self._c["pushes"] += 1
            self._c["push_rows"] += int(rows)
            self._c["push_rpc_calls"] += int(rpc_calls)
            self.push_ms.observe(ms)

    def snapshot(self):
        """Plain-dict export.  dedup_ratio = ids_total / ids_unique
        (≥ 1; how many wire/device rows dedup saved), padding_waste =
        fraction of gathered rows that were bucket padding."""
        with self._lock:
            c = dict(self._c)
            uniq = c["ids_unique"]
            gathered = uniq + c["rows_padded"]
            return {
                "counters": c,
                "lookup_ms": self.lookup_ms.as_dict(),
                "push_ms": self.push_ms.as_dict(),
                "dedup_ratio": round(c["ids_total"] / uniq, 3)
                if uniq else 0.0,
                "padding_waste": round(c["rows_padded"] / gathered, 4)
                if gathered else 0.0,
                "rpcs_per_lookup": round(c["rpc_calls"] / c["lookups"],
                                         3) if c["lookups"] else 0.0,
            }


METRICS = SparseMetrics()
