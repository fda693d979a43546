"""LoD (ragged sequence) representation — dense + per-sequence lengths.

The reference packs a minibatch of variable-length sequences into one dense
tensor plus an offset table (``lod_tensor.h:44-58``; "variable-length
sequence without padding", README.md:55).  XLA requires static shapes, so
the TPU-native representation is **padded dense [batch, max_len, ...] plus a
lengths vector [batch]** (the "segment-ids lowering" of SURVEY §5.7).  Every
lod_level>0 variable ``name`` has a companion int32 variable
``name@SEQ_LEN`` carrying the lengths; sequence ops consume and produce the
companion explicitly, so masking is visible to XLA and fuses away.

This module holds the host-side conversion utilities and the user-facing
``LoDTensor`` / ``create_lod_tensor`` API parity surface.
"""

import numpy as np

SEQ_LEN_SUFFIX = "@SEQ_LEN"
SEQ_LEN2_SUFFIX = "@SEQ_LEN2"


def seq_len_name(name):
    return name + SEQ_LEN_SUFFIX


def seq_len2_name(name):
    """Level-2 lengths companion of a lod_level=2 var: [B, S] tokens per
    inner sequence (level 1 keeps [B] inner-sequence counts)."""
    return name + SEQ_LEN2_SUFFIX


def seq_lenk_name(name, k):
    """Level-k lengths companion (k=1 -> @SEQ_LEN, k=2 -> @SEQ_LEN2, ...).

    Reference LoD is a vector of levels with no depth cap
    (``lod_tensor.h:44-58``); every level k of a lod_level=L var has an
    int32 companion of shape [B, S1, ..., S_{k-1}] — counts of level-k
    children under each level-(k-1) node (tokens for k=L)."""
    if k == 1:
        return name + SEQ_LEN_SUFFIX
    return f"{name}@SEQ_LEN{k}"


def to_padded_n(value, level):
    """Arbitrary-depth ragged feed -> dense + per-level lengths.

    `value` nests `level` lists deep (list over samples, then over
    level-2 nodes, ...); leaves are arrays [T, feat...].  Returns
    (dense [B, S1, ..., S_{L-1}, Tmax, feat...], [lens1, ..., lensL])
    with lens_k int32 of shape [B, S1, ..., S_{k-1}]."""
    b = len(value)
    maxs = [0] * level
    trailing, dtype = (), np.float32
    found = [False]

    def scan(node, d):
        nonlocal trailing, dtype
        if d == level:
            a = np.asarray(node)
            maxs[d - 1] = max(maxs[d - 1], a.shape[0])
            if not found[0]:
                trailing = a.shape[1:]
                dtype = a.dtype
                found[0] = True
            return
        maxs[d - 1] = max(maxs[d - 1], len(node))
        for c in node:
            scan(c, d + 1)

    for sample in value:
        scan(sample, 1)
    maxs = [bucket_len(m) for m in maxs]
    dense = np.zeros((b,) + tuple(maxs) + trailing, dtype)
    lens = [np.zeros((b,) + tuple(maxs[:k]), np.int32)
            for k in range(level)]

    def fill(node, path, d):
        if d == level:
            a = np.asarray(node)
            lens[d - 1][path] = a.shape[0]
            dense[path + (slice(0, a.shape[0]),)] = \
                a.reshape((a.shape[0],) + trailing)
            return
        lens[d - 1][path] = len(node)
        for j, c in enumerate(node):
            fill(c, path + (j,), d + 1)

    for i, sample in enumerate(value):
        fill(sample, (i,), 1)
    return dense, lens


def lod_tensor_to_nested(lt):
    """Multi-level LoDTensor -> the nested-list feed form.

    The reference feeds a LoDTensor carrying multi-level lod directly
    (lod_tensor.h:58); here the packed [total, ...] payload is re-split
    by the innermost lengths and grouped per higher level, producing the
    level-deep nested list `to_padded_n` consumes."""
    seq_lens = lt.recursive_sequence_lengths()
    data = np.asarray(lt)
    parts = np.split(data, np.cumsum(seq_lens[-1])[:-1]) \
        if len(seq_lens[-1]) > 1 else [data]
    for lens in reversed(seq_lens[:-1]):
        grouped, i = [], 0
        for n in lens:
            grouped.append(parts[i:i + n])
            i += n
        parts = grouped
    return parts


def nesting_depth(value):
    """List-nesting depth of a ragged feed.  Arrays are leaves; empty or
    array-first samples are skipped when descending (the first sample
    may legitimately be empty).  Leaves should be numpy arrays — a
    Python list-of-scalars leaf reads as one extra level."""
    d = 0
    node = value
    while isinstance(node, list):
        d += 1
        nxt = next((c for c in node if isinstance(c, list)), None)
        if nxt is None:
            break
        node = nxt
    return d


def to_padded2(value):
    """Nested ragged feed (list of list of arrays, one inner list per
    sample) -> ([B, S, T, ...], lens1 [B], lens2 [B, S])."""
    dense, lens = to_padded_n(value, 2)
    return dense, lens[0], lens[1]


class LoDTensor:
    """API-parity LoDTensor: numpy payload + recursive sequence lengths.

    The reference's LoD is a table of *offsets* (``lod_tensor.h:58``);
    user-facing APIs accept/return *lengths* (recursive_sequence_lengths).
    Internally we store lengths; ``lod()`` converts to offsets.
    """

    def __init__(self, data=None, recursive_seq_lens=None):
        self._data = None if data is None else np.asarray(data)
        self._seq_lens = recursive_seq_lens or []

    def set(self, data, place=None):
        self._data = np.asarray(data)

    def set_recursive_sequence_lengths(self, lens):
        self._seq_lens = [list(l) for l in lens]

    def recursive_sequence_lengths(self):
        return self._seq_lens

    def set_lod(self, lod):
        self._seq_lens = [
            [lvl[i + 1] - lvl[i] for i in range(len(lvl) - 1)] for lvl in lod]

    def lod(self):
        out = []
        for lvl in self._seq_lens:
            offs = [0]
            for l in lvl:
                offs.append(offs[-1] + l)
            out.append(offs)
        return out

    def __array__(self, dtype=None):
        a = self._data
        return a.astype(dtype) if dtype is not None else a

    def shape(self):
        return list(self._data.shape)

    def has_valid_recursive_sequence_lengths(self):
        if not self._seq_lens:
            return True
        return sum(self._seq_lens[-1]) == (self._data.shape[0]
                                           if self._data is not None else 0)


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """fluid.create_lod_tensor parity (python/paddle/fluid/lod_tensor.py)."""
    if isinstance(data, list):
        flat = np.concatenate([np.asarray(d).reshape(len(d), -1)
                               for d in data])
        lens = [[len(d) for d in data]]
        return LoDTensor(flat, lens)
    return LoDTensor(np.asarray(data), recursive_seq_lens)


def bucket_len(t):
    """Round a ragged max-length up to its compile bucket.

    XLA compiles one executable per static shape; padding every batch to
    *that batch's* max means one recompile per distinct length.  Bucketing
    to powers of two (FLAGS_seq_len_bucket=pow2, floor
    FLAGS_seq_len_min_bucket) bounds the number of executables at
    log2(max_len) while the lengths vector keeps masking exact.
    """
    from ..flags import get_flag

    policy = get_flag("seq_len_bucket")
    if t <= 0 or policy in (None, "none", "0", "", False):
        return t
    b = max(int(get_flag("seq_len_min_bucket")), 1)
    while b < t:
        b *= 2
    return b


def to_padded(value, dtype=None):
    """Normalize any accepted ragged feed value to (padded, lengths).

    Accepts: LoDTensor (packed [total, ...] + lens), (array, lengths)
    tuple, list of per-example arrays, or an already-padded dense array
    (lengths assumed full).
    """
    if isinstance(value, LoDTensor):
        lens = value.recursive_sequence_lengths()
        if not lens:
            arr = np.asarray(value)
            return arr, np.full((arr.shape[0],), arr.shape[1]
                                if arr.ndim > 1 else 1, np.int32)
        row_lens = lens[-1]
        packed = np.asarray(value)
        return pack_to_padded(packed, row_lens, dtype)
    if isinstance(value, tuple) and len(value) == 2:
        arr, lens = np.asarray(value[0]), np.asarray(value[1], np.int32)
        if arr.ndim > 1:
            t = bucket_len(arr.shape[1])
            if t > arr.shape[1]:
                pad = [(0, 0)] * arr.ndim
                pad[1] = (0, t - arr.shape[1])
                arr = np.pad(arr, pad)
        return arr, lens
    if isinstance(value, list):
        seqs = [np.asarray(s) for s in value]
        lens = np.array([len(s) for s in seqs], np.int32)
        t = bucket_len(int(lens.max())) if len(lens) else 0
        trailing = seqs[0].shape[1:] if seqs and seqs[0].ndim > 1 else ()
        out = np.zeros((len(seqs), t) + trailing,
                       dtype or (seqs[0].dtype if seqs else np.float32))
        for i, s in enumerate(seqs):
            out[i, :len(s)] = s.reshape((len(s),) + trailing)
        return out, lens
    arr = np.asarray(value)
    return arr, np.full((arr.shape[0],),
                        arr.shape[1] if arr.ndim > 1 else 1, np.int32)


def pack_to_padded(packed, row_lens, dtype=None):
    """[total, ...] + lengths -> ([batch, max_len, ...], lengths)."""
    packed = np.asarray(packed)
    lens = np.asarray(row_lens, np.int32)
    b = len(lens)
    t = bucket_len(int(lens.max())) if b else 0
    out = np.zeros((b, t) + packed.shape[1:],
                   packed.dtype if dtype is None else dtype)
    off = 0
    for i, l in enumerate(lens):
        out[i, :l] = packed[off:off + l]
        off += l
    return out, lens


def padded_to_pack(padded, lens):
    """([batch, max_len, ...], lengths) -> [total, ...] (host side)."""
    padded = np.asarray(padded)
    lens = np.asarray(lens)
    return np.concatenate([padded[i, :l] for i, l in enumerate(lens)]) \
        if len(lens) else padded.reshape((0,) + padded.shape[2:])
