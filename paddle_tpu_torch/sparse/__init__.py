"""paddle_tpu_torch.sparse — the sharded embedding-table engine of CTR
models (the port of ``paddle_tpu/sparse``).

Tables too big for any one device are partitioned by row-hash across
shard ranks (``partition.RowPartition`` — round-robin, bijective, the
one map every layer shares).  Lookups run as a batched, deduplicated
gather: host-side dedup of the batch's ids, one RPC per owning shard
over the typed-frame transport (``sparse_lookup``/``sparse_push``), and
the hand-written row-gather kernel K11 (``csrc/gather_rows.cu``) on a
shard's device table.  Gradients flow back as merged SelectedRows routed
per shard and applied by async touched-rows optimizer updates on the
owning rank.

Typical use::

    import paddle_tpu_torch.sparse as sparse

    cfg = sparse.declare_sharded_table(
        "ctr_table", vocab=1_000_000, dim=16,
        endpoints=["h0:7000", "h1:7000"], optimizer="sgd",
        learning_rate=1e-3)
    # ... build the model with fluid.layers.embedding on "ctr_table",
    # optimizer.minimize(loss), then:
    trainer_prog, trainer_startup = sparse.shard_program(main, startup)

Shard checkpoints (``sparse/checkpoint.py``) are not ported yet.
"""

from .client import SparseTableClient, TableShardLostError
from .engine import (SHARDED_LOOKUP_OP, SHARDED_PUSH_OP, install_client,
                     shard_program)
from .gather import dedup_gather, dedup_ids, gather_rows, pad_bucket
from .metrics import METRICS, SparseMetrics
from .optim import SparseOptimizer
from .partition import RowPartition
from .shard_server import SparseShardServer, load_table
from .table import (ShardedTableConfig, bind_local_server,
                    clear_tables, declare_sharded_table, get_table,
                    is_sharded, tables)

__all__ = [
    "RowPartition", "ShardedTableConfig", "SparseMetrics", "METRICS",
    "SparseOptimizer", "SparseShardServer", "SparseTableClient",
    "TableShardLostError", "SHARDED_LOOKUP_OP", "SHARDED_PUSH_OP",
    "bind_local_server", "clear_tables", "declare_sharded_table",
    "dedup_gather", "dedup_ids", "gather_rows", "get_table",
    "install_client", "is_sharded", "load_table", "pad_bucket",
    "shard_program", "tables",
]
