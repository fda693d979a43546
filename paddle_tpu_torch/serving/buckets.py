"""Shape bucketing + compiled-executable cache.

TPU (XLA) executables are shape-specialized: every distinct input shape
is a retrace + recompile.  The serving layer therefore quantizes the two
dynamic dims of a request stream — the micro-batch row count and an
optional ragged sequence dim — onto a small fixed set of *buckets*, so
steady-state traffic reuses a handful of executables no matter how row
counts and lengths jitter.  The cache itself is a plain LRU keyed by
``(bucket_shape, dtype)`` per input, with hit/miss/eviction counters the
acceptance tests read back.
"""

import collections

import numpy as np


def validate_buckets(entries, name="batch_buckets"):
    """Validate a bucket grid at CONFIG time: every entry must be a
    positive integer and no entry may repeat.  Returns the grid as a
    sorted tuple.  Raises a named ValueError listing exactly the
    offending entries — today a malformed grid only dies later, as an
    opaque cache-key mismatch or a choose_bucket miss deep in the
    worker loop.

    Non-power-of-two entries are legal ("pow2-or-explicit"): an
    operator who measured that 24 is the right bucket may say 24 — the
    grid is explicit policy, the validator only rejects entries that
    can never name a padded shape (non-ints, bools, zero/negative,
    duplicates)."""
    if entries is None:
        return None
    entries = tuple(entries)
    if not entries:
        raise ValueError(f"{name} must not be empty")
    bad = [e for e in entries
           if isinstance(e, bool) or not isinstance(e, int) or e < 1]
    seen, dups = set(), []
    for e in entries:
        if e in seen:
            dups.append(e)
        seen.add(e)
    if bad or dups:
        problems = []
        if bad:
            problems.append(f"non-positive-int entries {bad!r}")
        if dups:
            problems.append(f"duplicate entries {sorted(set(dups))!r}")
        raise ValueError(
            f"invalid {name} grid {list(entries)!r}: "
            + " and ".join(problems)
            + " — buckets must be unique positive ints")
    return tuple(sorted(entries))


def default_batch_buckets(max_batch_size):
    """Powers of two up to max_batch_size (always included), smallest
    first: 1, 2, 4, ... — a partially filled batch pads to the next
    power instead of the full batch, bounding padding waste at 2x."""
    b, out = 1, []
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return tuple(out)


def choose_bucket(n, buckets):
    """Smallest bucket >= n; raises if n exceeds every bucket."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds the largest bucket "
                     f"{max(buckets)}")


def pad_rows(arr, target):
    """Pad the leading (row) dim up to `target` by repeating the last
    row — padding stays in-distribution, so models with row-coupled
    numerics (softmax over the batch never happens, but batch-norm in
    train graphs could) see plausible values, and the pad rows are
    sliced off before anyone reads them."""
    a = np.asarray(arr)
    n = a.shape[0]
    if n == target:
        return a
    if n > target:
        raise ValueError(f"rows {n} > bucket {target}")
    pad = np.repeat(a[-1:], target - n, axis=0)
    return np.concatenate([a, pad], axis=0)


def unpad_rows(arr, n):
    return np.asarray(arr)[:n]


def pad_seq(arr, target, axis=1, value=0):
    """Pad `axis` up to `target` with a constant (0: the id/mask padding
    convention everywhere in this repo's ragged pipelines)."""
    a = np.asarray(arr)
    cur = a.shape[axis]
    if cur == target:
        return a
    if cur > target:
        raise ValueError(f"seq len {cur} > bucket {target}")
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, target - cur)
    return np.pad(a, widths, mode="constant", constant_values=value)


def unpad_seq(arr, n, axis=1):
    a = np.asarray(arr)
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(0, n)
    return a[tuple(sl)]


def signature(feed, order):
    """Hashable grouping key for a normalized feed: per-input shape
    beyond the leading row dim, plus dtype.  Two requests coalesce into
    one micro-batch iff their signatures match (after seq bucketing)."""
    return tuple((n, feed[n].shape[1:], feed[n].dtype.str) for n in order)


class ExecutableCache:
    """LRU over compiled executables keyed by the padded batch's full
    shape signature.  A hit is a dict move-to-end; a miss runs the
    (expensive, seconds-scale) builder and may evict the coldest entry —
    both visible in the metrics counters so tests and dashboards can
    assert "steady state never retraces".

    Thread-safe: the worker loop and ``ServingEngine.warmup`` (which
    precompiles the bucket grid, possibly from another thread) share
    it.  The lock covers only the dict operations — the seconds-scale
    builder runs OUTSIDE it, so a warmup compile never stalls the
    worker's cache hits on other keys.  Two threads racing the same
    missing key may both build it (first insert wins); with the
    jitcache underneath the loser's build is a cheap deserialize, and
    both results are equivalent executables."""

    def __init__(self, capacity, metrics=None):
        import threading

        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self._d = collections.OrderedDict()
        self._metrics = metrics
        self._lock = threading.RLock()

    def __len__(self):
        with self._lock:
            return len(self._d)

    def __contains__(self, key):
        with self._lock:
            return key in self._d

    def get_or_build(self, key, builder):
        with self._lock:
            hit = self._d.get(key)
            if hit is not None:
                self._d.move_to_end(key)
                if self._metrics:
                    self._metrics.inc("cache_hits")
                return hit
            if self._metrics:
                self._metrics.inc("cache_misses")
        built = builder()               # slow: outside the lock
        with self._lock:
            cur = self._d.get(key)
            if cur is not None:         # racing builder beat us
                return cur
            self._d[key] = built
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
                if self._metrics:
                    self._metrics.inc("cache_evictions")
            return built

    def clear(self):
        with self._lock:
            self._d.clear()
