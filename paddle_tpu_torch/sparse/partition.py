"""Row partitioning for sharded embedding tables (a copy of
``paddle_tpu/sparse/partition.py``).

One :class:`RowPartition` object is the single source of truth for the
row→shard map everywhere it is consulted — trainer-side lookup/push
routing, shard-server bounds checks, checkpoint save/restore, and
reshard-load — so the map can never drift between layers.

Scheme: round-robin row-hash.  ``shard_of(r) = r % num_shards`` and the
shard-local index space is ``local_of(r) = r // num_shards`` — a dense,
bounded [0, shard_height) range per shard, which is what lets each
shard hold its rows as one contiguous ``[H_s, D]`` block (the device
gather kernel's layout) instead of a hash table.  CTR pipelines hash
raw features into the id space upstream (the reference's slot ids are
already hashes), so consecutive-id hot spots are an artifact of the
hashing, and round-robin spreads any residual locality across every
shard.  The map is bijective: ``to_global(shard, local)`` inverts it
exactly, which is what makes save-on-N / restore-on-M resharding a
deterministic row shuffle rather than a rehash of unknown keys.
"""

import numpy as np


class RowPartition:
    """Row→shard map for a ``[vocab, ...]`` table split ``num_shards``
    ways.  All array methods accept and return numpy integer arrays
    (any shape) and never copy more than the output."""

    __slots__ = ("vocab", "num_shards")

    def __init__(self, vocab, num_shards):
        vocab = int(vocab)
        num_shards = int(num_shards)
        if vocab <= 0:
            raise ValueError(f"vocab must be positive, got {vocab}")
        if not 1 <= num_shards <= vocab:
            raise ValueError(
                f"num_shards must be in [1, vocab={vocab}], "
                f"got {num_shards}")
        self.vocab = vocab
        self.num_shards = num_shards

    def shard_of(self, rows):
        """Owning shard index for each global row id."""
        return np.asarray(rows) % self.num_shards

    def local_of(self, rows):
        """Shard-local index for each global row id (dense per shard)."""
        return np.asarray(rows) // self.num_shards

    def to_global(self, shard, local):
        """Inverse map: (shard, local index) -> global row id."""
        return np.asarray(local) * self.num_shards + shard

    def shard_height(self, shard):
        """Rows owned by `shard`: |{r < vocab : r % n == shard}|."""
        shard = int(shard)
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"shard {shard} out of range "
                             f"[0, {self.num_shards})")
        return (self.vocab - shard + self.num_shards - 1) \
            // self.num_shards

    def shard_rows(self, shard):
        """All global row ids owned by `shard`, ascending (loading a
        dense table into its shards, checkpoint reassembly)."""
        return np.arange(shard, self.vocab, self.num_shards,
                         dtype=np.int64)

    def check_rows(self, rows, shard=None):
        """Validate global ids in [0, vocab) (and, with `shard`, that
        every id is owned by that shard) — raises IndexError naming the
        first offender instead of letting a bad id silently gather row
        0 or wrap negative."""
        rows = np.asarray(rows)
        if rows.size == 0:
            return
        bad = (rows < 0) | (rows >= self.vocab)
        if bad.any():
            r = int(rows[bad][0])
            raise IndexError(
                f"row id {r} outside table [0, {self.vocab})")
        if shard is not None:
            wrong = self.shard_of(rows) != shard
            if wrong.any():
                r = int(rows[wrong][0])
                raise IndexError(
                    f"row id {r} belongs to shard "
                    f"{int(self.shard_of(r))}, not shard {shard}")

    def __repr__(self):
        return (f"RowPartition(vocab={self.vocab}, "
                f"num_shards={self.num_shards})")

    def __eq__(self, other):
        return (isinstance(other, RowPartition) and
                self.vocab == other.vocab and
                self.num_shards == other.num_shards)
