"""Paged KV pool: a block-table allocator over a fixed-shape arena.

The PagedAttention memory model (Kwon et al., SOSP 2023 — PAPERS.md)
applied under a fixed-shape discipline: sequence
context lives in fixed-size **blocks** of a ``[num_blocks, block_size,
...]`` arena, and each decode slot owns a row of a fixed-shape
``[slots, max_blocks]`` int32 **block table** naming its blocks in
order.  Admission, retirement, copy-on-write forks and prefix sharing
all rewrite table rows and a free-list — never a tensor shape — so the
executables stepping over the pool see ONE physical signature at any
occupancy (the Orca-entry contract delta: vLLM grows dynamic tensors,
this pool never does).

What this buys over the dense ``[slots, max_len]`` pool: a
sequence that generates 5 tokens holds ``ceil(6/block_size)`` blocks,
not ``max_len`` rows — decode memory is O(tokens actually live), so at
a fixed arena budget the scheduler sustains far more concurrent
sequences at mixed output lengths (``bench.py --fleet`` measures the
ratio).

Sharing model (the vLLM prefix-cache design, refcounted):

- every block carries a **refcount**; a block is freed exactly when it
  reaches 0 (``free-list ⇔ refcount 0`` is an asserted invariant).
- prompt blocks written at admission are **registered** in a prefix
  cache keyed by ``(parent chain, token bytes)`` — a later prompt that
  starts with the same tokens re-uses the chain (refcount++) instead
  of re-writing it, so a thousand requests sharing a system prompt
  store its KV once.  Cache entries hold their own pin (+1) and are
  LRU-evicted under allocation pressure.
- a write into a block whose refcount is > 1 triggers **copy-on-write**:
  the writer gets a private copy (all planes copied), the shared block
  keeps serving its other readers.  The first generated token after a
  shared partial-tail prompt block is the canonical COW site.

The pool stores a mandatory ``tokens`` plane (int64 ids; the dense
``token_view()`` is the step-function feed) plus arbitrary per-token
value planes (``value_spec``) — the K/V arenas a paged-attention
kernel gathers through ``table_view()`` (K4/K5, ``ops/paged_kernels``
and ``ops/quant_kernels``; the decode step, as the JAX package's, does
not call them and recomputes over ``token_view()``).

Block 0 is reserved as the all-pad block: unassigned table entries
point at it, so the dense gather needs no second masking pass and the
device-side block-table gather is always in-bounds.

Thread model: one writer (the engine's scheduler thread) mutates;
``snapshot()``/``stats`` readers take the same lock.  The pool attaches
itself to the observability registry (``kv/<n>``), so
``registry.snapshot()`` carries live block-occupancy gauges — the
chaos stage asserts leak-freedom through exactly that surface.
"""

import collections
import threading

import numpy as np

__all__ = ["KVBlockPool", "PagedKVConfig", "PoolExhausted"]


class PoolExhausted(RuntimeError):
    """No free block and nothing evictable — the caller's admission /
    preemption policy decides what yields."""


class PagedKVConfig:
    """Paged-pool knobs for ``ContinuousConfig(kv=...)``.

    - block_size: tokens per block (None = FLAGS_kv_block_size)
    - num_blocks: arena blocks INCLUDING the reserved pad block
      (None = FLAGS_kv_num_blocks; 0 derives slots * max_blocks + 1,
      the no-savings sizing)
    - cache_prefixes: register prompt blocks for shared-prefix dedup
    - value_spec: {name: (tail_shape, dtype)} extra per-token planes
      (K/V arenas) carried alongside the token plane
    - kv_dtype: dtype of the K/V planes :meth:`kv_value_spec` builds
      (None = float32).  ``"int8"`` is the quantized-arena mode
     : the K/V planes store int8 values and fp32 per-token
      SCALE planes ride alongside — the operand layout of the JAX
      package's ``paged_attention_quant``, at 1/4 the arena bytes.  The pool itself is dtype-agnostic (COW,
      truncate and preemption copy/zero planes bytewise); kv_dtype
      only shapes the spec.
    """

    def __init__(self, block_size=None, num_blocks=None,
                 cache_prefixes=True, value_spec=None, kv_dtype=None):
        from ...flags import get_flag

        self.block_size = int(block_size if block_size is not None
                              else get_flag("kv_block_size"))
        if self.block_size < 1:
            raise ValueError("kv block_size must be >= 1")
        self.num_blocks = int(num_blocks if num_blocks is not None
                              else get_flag("kv_num_blocks"))
        self.cache_prefixes = bool(cache_prefixes)
        self.value_spec = dict(value_spec or {})
        self.kv_dtype = kv_dtype

    def kv_value_spec(self, heads, head_dim):
        """K/V value-plane spec for an attention arena over this pool:
        ``{"k"/"v": ((heads, head_dim), kv_dtype)}`` plus — in int8
        mode — fp32 per-token ``"k_scale"``/``"v_scale"`` planes
        (scalar tail: one symmetric scale per token, the JAX
        package's ``quantize_kv`` layout).  Merge the result into
        ``value_spec`` when constructing the config."""
        dt = self.kv_dtype or "float32"
        spec = {"k": ((heads, head_dim), dt),
                "v": ((heads, head_dim), dt)}
        # accept every int8 spelling ("int8", np.int8, np.dtype) — a
        # numpy-typed config silently missing its scale planes would
        # fail far from the misconfiguration, at decode time
        try:
            int8 = np.dtype(dt) == np.dtype(np.int8)
        except TypeError:
            int8 = str(dt) == "int8"
        if int8:
            spec["k_scale"] = ((), "float32")
            spec["v_scale"] = ((), "float32")
        return spec

    def resolve_num_blocks(self, slots, max_blocks):
        """Arena size: explicit, or slots*max_blocks (+pad block)."""
        if self.num_blocks:
            return self.num_blocks
        return slots * max_blocks + 1


class _Chain:
    """Cache-key helper: a registered block's identity is the hash
    chain (parent identity, its token bytes, fill count) — two chains
    match iff every prefix block's tokens match positionally."""

    __slots__ = ()

    @staticmethod
    def key(parent_key, tokens):
        return (parent_key, tokens.tobytes(), int(tokens.size))


class KVBlockPool:
    """Block-table allocator; see module docstring for the model."""

    def __init__(self, slots, max_blocks, config, pad_id=0):
        cfg = config if isinstance(config, PagedKVConfig) \
            else PagedKVConfig(**(config or {}))
        self.config = cfg
        self.slots = int(slots)
        self.max_blocks = int(max_blocks)
        self.block_size = cfg.block_size
        self.num_blocks = cfg.resolve_num_blocks(slots, max_blocks)
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (pad block + 1)")
        self.pad_id = int(pad_id)
        N, Bs = self.num_blocks, self.block_size
        # table rows default to the reserved pad block 0
        self._table = np.zeros((self.slots, self.max_blocks), np.int32)
        self._nblocks = np.zeros((self.slots,), np.int32)
        self._lengths = np.zeros((self.slots,), np.int64)
        self._tokens = np.full((N, Bs), self.pad_id, np.int64)
        self._values = {
            n: np.zeros((N, Bs) + tuple(tail), dtype)
            for n, (tail, dtype) in cfg.value_spec.items()}
        self._refcount = np.zeros((N,), np.int32)
        self._free = collections.deque(range(1, N))   # 0 = pad block
        self._in_free = np.ones((N,), bool)
        self._in_free[0] = False
        # prefix cache: chain key -> block id (insertion order = LRU)
        self._cache = collections.OrderedDict()
        self._block_key = {}          # block id -> its cache key
        # in-flight kv_stream ingests: xfer id -> reserved-block state.
        # Reserved blocks hold ONE ownership ref (the transfer's) and
        # are invisible to tables and cache until commit — so they are
        # neither free nor evictable while the stream is in flight
        self._ingests = {}
        self._lock = threading.Lock()
        self._c = {"allocs": 0, "frees": 0, "cow_forks": 0,
                   "prefix_hits": 0, "prefix_hit_tokens": 0,
                   "evictions": 0, "admits": 0, "releases": 0,
                   "peak_live": 0,
                   "ingests_begun": 0, "ingests_committed": 0,
                   "ingests_aborted": 0, "ingest_blocks_reserved": 0,
                   "ingest_blocks_deduped": 0,
                   "ingest_abort_blocks_returned": 0,
                   "cache_dropped": 0}
        from ...observability import REGISTRY

        REGISTRY.attach("kv", self)

    # ---- allocation core (caller holds self._lock) ----

    def _alloc_locked(self):
        """Pop a free block; under pressure evict LRU cache-only blocks
        (refcount == 1, pinned solely by the prefix cache).  Raises
        PoolExhausted when neither works — never double-allocates (the
        in-free bitmap is the asserted guard)."""
        while not self._free:
            if not self._evict_one_locked():
                raise PoolExhausted(
                    f"KV pool exhausted: {self.num_blocks - 1} usable "
                    f"blocks all live (block_size={self.block_size})")
        b = self._free.popleft()
        assert self._in_free[b], \
            f"free-list handed out block {b} twice"
        assert self._refcount[b] == 0, \
            f"block {b} on the free list with refcount " \
            f"{self._refcount[b]}"
        self._in_free[b] = False
        self._refcount[b] = 1
        self._tokens[b] = self.pad_id
        for a in self._values.values():
            a[b] = 0
        self._c["allocs"] += 1
        self._c["peak_live"] = max(self._c["peak_live"],
                                   self._live_locked())
        return b

    def _decref_locked(self, b):
        if b == 0:
            return
        self._refcount[b] -= 1
        assert self._refcount[b] >= 0, f"block {b} refcount underflow"
        if self._refcount[b] == 0:
            key = self._block_key.pop(b, None)
            if key is not None:                  # pragma: no cover —
                self._cache.pop(key, None)       # cache pin makes this
            assert not self._in_free[b], \
                f"block {b} freed twice"         # unreachable by design
            self._in_free[b] = True
            self._free.append(b)
            self._c["frees"] += 1

    def _evict_one_locked(self):
        """Drop the least-recently-used cache entry whose block is held
        ONLY by the cache (refcount 1) — its decref frees it."""
        for key, b in self._cache.items():
            if self._refcount[b] == 1:
                del self._cache[key]
                self._block_key.pop(b, None)
                self._decref_locked(b)
                self._c["evictions"] += 1
                return True
        return False

    def _live_locked(self):
        return self.num_blocks - 1 - len(self._free)

    def _register_locked(self, key, b):
        """Pin block `b` in the prefix cache under `key` (+1 ref)."""
        if not self.config.cache_prefixes or key in self._cache:
            return
        self._cache[key] = b
        self._block_key[b] = key
        self._refcount[b] += 1

    # ---- capacity queries ----

    def blocks_for(self, n_tokens):
        return -(-int(n_tokens) // self.block_size)

    def can_admit(self, n_tokens):
        """Whether a prompt of n_tokens plus its first generated token
        could be placed right now, before prefix-cache hits are known
        — conservative.  Deliberately the same ``blocks_for(n + 1)``
        bound `ContinuousBatchingEngine.submit` accepts against: a
        submit-accepted prompt is always admittable once the pool
        drains (a stricter bound here would strand it at the queue
        head forever)."""
        need = self.blocks_for(n_tokens + 1)
        with self._lock:
            evictable = sum(1 for b in self._cache.values()
                            if self._refcount[b] == 1)
            return len(self._free) + evictable >= need

    def capacity_blocks(self):
        return self.num_blocks - 1

    def free_blocks(self):
        with self._lock:
            return len(self._free)

    def live_blocks(self):
        with self._lock:
            return self._live_locked()

    # ---- slot lifecycle ----

    def admit(self, slot, tokens, values=None):
        """Write a prompt into `slot` (must be released/empty):
        full and partial-tail blocks are looked up in the prefix cache
        first (hit = share + refcount++), misses allocate, write, and
        register.  `values` optionally carries per-token planes
        ``{name: [len, *tail]}`` written alongside.  Raises
        PoolExhausted when allocation fails mid-way (already-placed
        blocks are rolled back)."""
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        n = tokens.size
        if self.blocks_for(n + 1) > min(self.capacity_blocks(),
                                        self.max_blocks):
            raise PoolExhausted(
                f"prompt of {n} tokens can never fit: needs "
                f"{self.blocks_for(n + 1)} blocks, pool has "
                f"{self.capacity_blocks()} and a sequence may hold "
                f"at most {self.max_blocks}")
        Bs = self.block_size
        with self._lock:
            assert self._nblocks[slot] == 0, \
                f"slot {slot} admitted while still holding blocks"
            placed = []
            parent = None
            try:
                for j in range(self.blocks_for(n)):
                    blk_toks = tokens[j * Bs:(j + 1) * Bs]
                    key = _Chain.key(parent, blk_toks)
                    hit = self._cache.get(key) \
                        if self.config.cache_prefixes else None
                    if hit is not None:
                        self._refcount[hit] += 1
                        self._cache.move_to_end(key)
                        self._c["prefix_hits"] += 1
                        self._c["prefix_hit_tokens"] += blk_toks.size
                        b = hit
                    else:
                        b = self._alloc_locked()
                        self._tokens[b, :blk_toks.size] = blk_toks
                        if values:
                            for name, arr in values.items():
                                self._values[name][
                                    b, :blk_toks.size] = \
                                    arr[j * Bs:j * Bs + blk_toks.size]
                        self._register_locked(key, b)
                    self._table[slot, j] = b
                    placed.append(b)
                    parent = key
            except PoolExhausted:
                for b in placed:
                    self._decref_locked(b)
                self._table[slot, :len(placed)] = 0
                raise
            self._nblocks[slot] = len(placed)
            self._lengths[slot] = n
            self._c["admits"] += 1

    def append(self, slot, token, values=None):
        """Append one token at the slot's current length.  Allocates a
        fresh block at a boundary; a write landing in a block shared
        with other readers (or pinned by the cache) copy-on-writes a
        private block first.  Returns False when allocation fails (the
        caller preempts or waits) — slot state is unchanged in that
        case."""
        Bs = self.block_size
        with self._lock:
            pos = int(self._lengths[slot])
            j, r = divmod(pos, Bs)
            if j >= self.max_blocks:
                raise IndexError(
                    f"slot {slot} append past max_blocks "
                    f"({self.max_blocks})")
            if r == 0:
                # boundary: a fresh, always-private block
                try:
                    b = self._alloc_locked()
                except PoolExhausted:
                    return False
                self._table[slot, j] = b
                self._nblocks[slot] = j + 1
            else:
                b = int(self._table[slot, j])
                if self._refcount[b] > 1:
                    # shared (other slots and/or the cache pin read
                    # it): fork a private copy — COW.  Note a
                    # REGISTERED block is always refcount >= 2 when a
                    # slot holds it (owner ref + cache pin), so every
                    # registered tail takes this branch and the cached
                    # copy stays pristine for future prompts
                    try:
                        nb = self._alloc_locked()
                    except PoolExhausted:
                        return False
                    self._tokens[nb] = self._tokens[b]
                    for a in self._values.values():
                        a[nb] = a[b]
                    self._decref_locked(b)
                    self._table[slot, j] = nb
                    self._c["cow_forks"] += 1
                    b = nb
            self._tokens[b, r] = int(token)
            if values:
                for name, val in values.items():
                    self._values[name][b, r] = val
            self._lengths[slot] = pos + 1
            return True

    def truncate(self, slot, new_len):
        """Roll a slot back to `new_len` tokens (the speculative-decode
        reject path): blocks past the new tail are released, and the
        tail block's now-dead positions are re-padded so the dense view
        stays garbage-free."""
        Bs = self.block_size
        with self._lock:
            old = int(self._lengths[slot])
            new_len = int(new_len)
            assert 0 <= new_len <= old
            if new_len == old:
                return
            keep = self.blocks_for(new_len)
            for j in range(keep, int(self._nblocks[slot])):
                self._decref_locked(int(self._table[slot, j]))
                self._table[slot, j] = 0
            self._nblocks[slot] = keep
            r = new_len - (keep - 1) * Bs if keep else 0
            if keep and r < Bs:
                b = int(self._table[slot, keep - 1])
                # dead tail positions in a PRIVATE block are re-padded;
                # a shared block's extra positions were never written
                # by this slot (appends COW first), so content is
                # already consistent for its other readers.  refcount
                # 1 implies unregistered: a registered block held by
                # this slot carries the cache pin on top (>= 2)
                if self._refcount[b] == 1:
                    self._tokens[b, r:] = self.pad_id
                    for a in self._values.values():
                        a[b, r:] = 0
            self._lengths[slot] = new_len

    def release(self, slot):
        """Retire a slot: decref every held block (refcount 0 => back
        on the free list), reset the table row to the pad block."""
        with self._lock:
            for j in range(int(self._nblocks[slot])):
                self._decref_locked(int(self._table[slot, j]))
            self._table[slot, :] = 0
            self._nblocks[slot] = 0
            self._lengths[slot] = 0
            self._c["releases"] += 1

    def drop_cache(self):
        """Release every prefix-cache pin (the drain decommission
        sweep): entries whose block is held ONLY by the cache free
        outright; entries shared with live slots or in-flight ingests
        merely lose the cache pin.  After every slot is released and
        every ingest settled, ``blocks_live`` reads 0 — the strongest
        leak assertion a drained replica's pool can offer.  Returns
        the number of cache entries dropped."""
        with self._lock:
            dropped = len(self._cache)
            for key, b in list(self._cache.items()):
                del self._cache[key]
                self._block_key.pop(b, None)
                self._decref_locked(b)
            self._c["cache_dropped"] += dropped
            return dropped

    # ---- kv_stream export / ingest (serving.disagg) ----

    def export_slot(self, slot):
        """Block-granular snapshot of a slot's chain for a `kv_stream`
        transfer: every plane (tokens + value planes) gathered in
        block-table order as ``[n_blocks, block_size, *tail]`` arrays.
        The copy is taken under the pool lock, so a concurrent append
        on another slot cannot tear it."""
        with self._lock:
            k = int(self._nblocks[slot])
            blocks = [int(self._table[slot, j]) for j in range(k)]
            planes = {"tokens": self._tokens[blocks].copy()}
            for name, a in self._values.items():
                planes[name] = a[blocks].copy()
            return {"n_tokens": int(self._lengths[slot]),
                    "n_blocks": k,
                    "block_size": self.block_size,
                    "planes": planes}

    def begin_ingest(self, xfer, n_tokens):
        """Reserve blocks for an inbound `kv_stream` transfer `xfer`
        carrying an `n_tokens` prompt.  Reservation goes through the
        same allocator as local admission (LRU cache eviction under
        pressure, PoolExhausted when nothing yields) — an inbound
        prompt is gated on free blocks exactly like a local one.
        Reserved blocks carry the transfer's ownership ref until
        :meth:`commit_ingest` re-homes them into the prefix cache or
        :meth:`abort_ingest` returns every one to the free list."""
        if not self.config.cache_prefixes:
            raise ValueError(
                "kv_stream ingest requires cache_prefixes=True: "
                "committed blocks land in the prefix cache")
        n = int(n_tokens)
        need = self.blocks_for(n)
        if self.blocks_for(n + 1) > min(self.capacity_blocks(),
                                        self.max_blocks):
            raise PoolExhausted(
                f"inbound prompt of {n} tokens can never fit: needs "
                f"{self.blocks_for(n + 1)} blocks, pool has "
                f"{self.capacity_blocks()} and a sequence may hold "
                f"at most {self.max_blocks}")
        with self._lock:
            if xfer in self._ingests:      # re-delivered begin chunk
                return len(self._ingests[xfer]["blocks"])
            got = []
            try:
                for _ in range(need):
                    got.append(self._alloc_locked())
            except PoolExhausted:
                for b in got:
                    self._decref_locked(b)
                raise
            self._ingests[xfer] = {"blocks": got, "n_tokens": n}
            self._c["ingests_begun"] += 1
            self._c["ingest_blocks_reserved"] += len(got)
            return len(got)

    def ingest_block(self, xfer, index, plane, data):
        """Write one plane of one reserved block (`index` is the
        block's position within the transfer, 0-based).  `data` is the
        ``[fill, *tail]`` per-token array for that block; positions
        past `fill` keep their zero/pad reset from allocation."""
        data = np.asarray(data)
        with self._lock:
            st = self._ingests.get(xfer)
            if st is None:
                raise KeyError(f"unknown kv ingest {xfer!r}")
            b = st["blocks"][index]
            m = data.shape[0]
            if plane == "tokens":
                self._tokens[b, :m] = data.astype(np.int64)
            else:
                self._values[plane][b, :m] = data

    def commit_ingest(self, xfer):
        """Finalize a transfer: walk the reserved chain computing the
        same ``(parent, token bytes)`` keys local admission uses and
        re-home each block into the prefix cache.  A chain prefix the
        cache already holds is deduped — the local copy wins, the
        duplicate inbound block goes back to the free list — so COW
        forks against the cached chain keep serving their readers.
        A later local ``admit`` of the same prompt then prefix-hits
        every block, which is exactly how the decode leg picks the
        transferred KV up.  Returns ``(registered, deduped)``."""
        Bs = self.block_size
        with self._lock:
            st = self._ingests.pop(xfer, None)
            if st is None:
                raise KeyError(f"unknown kv ingest {xfer!r}")
            n = st["n_tokens"]
            parent = None
            registered = deduped = 0
            for j, b in enumerate(st["blocks"]):
                m = min(Bs, n - j * Bs)
                key = _Chain.key(parent, self._tokens[b, :m].copy())
                hit = self._cache.get(key)
                if hit is not None and hit != b:
                    # chain already cached locally: keep that copy
                    # (its COW forks / readers stay valid), drop ours
                    self._cache.move_to_end(key)
                    self._decref_locked(b)
                    deduped += 1
                else:
                    self._register_locked(key, b)   # cache pin (+1)
                    self._decref_locked(b)          # transfer ref (-1)
                    registered += 1
                parent = key
            self._c["ingests_committed"] += 1
            self._c["ingest_blocks_deduped"] += deduped
            return registered, deduped

    def abort_ingest(self, xfer):
        """Tear down a failed/cancelled transfer: every reserved block
        goes straight back to the free list.  Idempotent — aborting an
        unknown (or already finalized) transfer returns 0.  The chaos
        drill asserts ``ingest_abort_blocks_returned`` equals the
        blocks reserved by the killed stream."""
        with self._lock:
            st = self._ingests.pop(xfer, None)
            if st is None:
                return 0
            for b in st["blocks"]:
                self._decref_locked(b)
            self._c["ingests_aborted"] += 1
            self._c["ingest_abort_blocks_returned"] += len(st["blocks"])
            return len(st["blocks"])

    def ingesting_blocks(self):
        with self._lock:
            return sum(len(st["blocks"])
                       for st in self._ingests.values())

    # ---- views ----

    def token_view(self):
        """Dense ``[slots, max_blocks * block_size]`` int64 gather of
        the token plane — the fixed-shape step-function feed.  Unowned
        positions read the pad block / padded tails, so the view is
        exactly the dense pool's prefix buffer."""
        with self._lock:
            S, MB, Bs = self.slots, self.max_blocks, self.block_size
            return self._tokens[self._table].reshape(S, MB * Bs)

    def value_view(self, name):
        """Dense per-slot gather of one value plane
        (``[slots, max_blocks * block_size, *tail]``)."""
        with self._lock:
            S, MB, Bs = self.slots, self.max_blocks, self.block_size
            a = self._values[name][self._table]
            return a.reshape((S, MB * Bs) + a.shape[3:])

    def table_view(self):
        """``[slots, max_blocks]`` int32 copy — a paged-attention
        kernel's block-table operand."""
        with self._lock:
            return self._table.copy()

    def arena(self, name):
        """The raw ``[num_blocks, block_size, *tail]`` plane (no copy)
        — the kernel's K/V arena operand."""
        return self._values[name]

    def tokens_arena(self):
        return self._tokens

    def lengths_view(self):
        with self._lock:
            return self._lengths.copy()

    def read_tokens(self, slot, n=None):
        """The slot's first `n` (default: length) tokens, gathered."""
        with self._lock:
            n = int(self._lengths[slot]) if n is None else int(n)
            Bs = self.block_size
            out = np.empty((n,), np.int64)
            for j in range(self.blocks_for(n)):
                b = int(self._table[slot, j])
                m = min(Bs, n - j * Bs)
                out[j * Bs:j * Bs + m] = self._tokens[b, :m]
            return out

    # ---- observability ----

    def cow_forks(self):
        """Monotonic count of copy-on-write forks — the light accessor
        the decode tracer diffs around a single append (reading the
        int is GIL-atomic; snapshot() would build the whole dict)."""
        return self._c["cow_forks"]

    def snapshot(self):
        """Gauges + counters for the observability registry — the
        chaos stage reads ``blocks_free`` here to assert a killed
        decode step leaked nothing."""
        with self._lock:
            live = self._live_locked()
            shared = int(np.sum(self._refcount > 1))
            cached = len(self._cache)
            cap = self.capacity_blocks()
            ingesting = sum(len(st["blocks"])
                            for st in self._ingests.values())
            return {
                "blocks_total": cap,
                "blocks_free": len(self._free),
                "blocks_live": live,
                "blocks_cached": cached,
                "blocks_shared": shared,
                "blocks_ingesting": ingesting,
                "occupancy": round(live / max(1, cap), 4),
                "shared_ratio": round(shared / max(1, live), 4),
                "block_size": self.block_size,
                "counters": dict(self._c),
            }

    def check_invariants(self):
        """Structural audit (tests): every block is exactly one of
        {free, referenced}; table entries in use are live; cache pins
        are counted; blocks reserved for an in-flight `kv_stream`
        ingest carry exactly the transfer's ownership ref — neither
        free nor leaked.  Returns the live set size."""
        with self._lock:
            ref = np.zeros((self.num_blocks,), np.int64)
            for s in range(self.slots):
                for j in range(int(self._nblocks[s])):
                    ref[int(self._table[s, j])] += 1
            for b in self._cache.values():
                ref[b] += 1
            for st in self._ingests.values():
                for b in st["blocks"]:
                    ref[b] += 1
            ref[0] = 0                       # pad block is unaccounted
            free = set(self._free)
            for b in range(1, self.num_blocks):
                in_free = b in free
                assert in_free == self._in_free[b], \
                    f"block {b}: free-list/bitmap disagree"
                assert self._refcount[b] == ref[b], \
                    f"block {b}: refcount {self._refcount[b]} != " \
                    f"observed references {ref[b]}"
                assert (self._refcount[b] == 0) == in_free, \
                    f"block {b}: refcount {self._refcount[b]} vs " \
                    f"free {in_free}"
            return self._live_locked()
