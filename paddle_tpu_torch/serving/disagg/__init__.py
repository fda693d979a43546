"""paddle_tpu_torch.serving.disagg — disaggregated prefill/decode serving
(port of ``paddle_tpu.serving.disagg``).

The DistServe/Splitwise-shaped tier over the fleet: prompt prefill and
token decode run on SEPARATE replica pools so neither phase's batching
discipline pollutes the other's latency, with the paged KV cache
streamed between them block-by-block:

- ``kvstream``: the chunked, crc'd ``kv_stream`` transport method —
  prefill exports a slot's block chain (int8 arenas ride as-is, ~1/4
  the fp32 bytes), decode-side :class:`KVIngestor` reserves/writes/
  commits blocks with (xfer, seq) idempotency, and an aborted stream
  provably returns every reserved block.
- ``prefill``: :class:`PrefillEngine`/:class:`PrefillReplica` — the
  prompt-forward tier staging KV through a small local pool.
- ``router``: :class:`DisaggRouter` — classifies by prompt length,
  runs prefill and decode legs as one traced causal tree
  (``disagg/request`` -> ``disagg/prefill`` -> ``disagg/kv_transfer``
  -> decode), and falls back to co-located serving whenever the split
  path is unroutable: degradation, never an outage.

The reference's ``sharded`` module (``ShardedReplica``, ``ChipDown``: a
replica-group over a mesh slice) needs one process per card and waits
for the multi-process mesh (ROADMAP queue 1 item 15); decode replicas
here are plain ``fleet.Replica`` objects.
"""

from .kvstream import (KVIngestor, KVStreamError,  # noqa: F401
                       KVStreamServer, send_abort, stream_export,
                       stream_export_multi, stream_slot)
from .prefill import PrefillEngine, PrefillReplica  # noqa: F401
from .router import DisaggConfig, DisaggRouter  # noqa: F401

__all__ = [
    "KVStreamError", "KVIngestor", "KVStreamServer", "stream_slot",
    "stream_export", "stream_export_multi", "send_abort",
    "PrefillEngine", "PrefillReplica",
    "DisaggConfig", "DisaggRouter",
]
