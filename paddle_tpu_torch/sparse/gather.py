"""Deduplicated embedding-row gather: host-side dedup, power-of-two
bucketing, and the row-gather kernel K11 — the port of
``paddle_tpu/sparse/gather.py``.

The batch's ids are deduped ON HOST (``np.unique`` — the ids are host
numpy at the lookup host op, so this costs no device round trip), the
unique count is padded to a power-of-two bucket so the gather sees a
handful of stable shapes, and only then do rows move: one gather of
``[U_pad, D]`` instead of ``[N, D]`` with duplicates.

K11.  The TPU kernel ``_pallas_gather`` (:54, reached at ``pl.pallas_call``
:75) moved one ``(1, D)`` row per grid step through a scalar-prefetched
``BlockSpec``.  Here it is ``csrc/gather_rows.cu``, written by hand for
Hopper: a byte copy, so one kernel serves every dtype.  :func:`gather_rows`
launches it on a CUDA table at every N and D (counted in
``gather_rows.launches``) or raises; on a CPU table it runs the plain
version :func:`gather_rows_reference`, ``table.index_select(0, idx)``.
The reference took its kernel only on a TPU with ``D % 128 == 0`` and
XLA's ``take`` elsewhere, by measurement (``_impl_for`` :89-114); the port
has no selection (and no ``FLAGS_sparse_gather_impl``): ``impl="plain"``
forces the plain version, for tests and the chip smoke's comparison.
No backward: grads travel as pushes.
"""

import ctypes

import numpy as np
import torch

from ..ops import cuda_build
from .metrics import METRICS

_MIN_BUCKET = 8
_SOURCE = "gather_rows"
_libs = {}


def dedup_ids(flat_ids):
    """(unique_ids ascending, inverse) — ``unique[inverse] == flat``.
    Host-side numpy; the engine's wire and device traffic is sized by
    ``len(unique)``, not ``len(flat)``."""
    flat = np.asarray(flat_ids).reshape(-1)
    uniq, inv = np.unique(flat, return_inverse=True)
    return uniq, inv.reshape(-1)


def pad_bucket(n, min_bucket=_MIN_BUCKET):
    """Next power-of-two bucket >= n (>= min_bucket)."""
    n = int(n)
    b = int(min_bucket)
    while b < n:
        b <<= 1
    return b


def gather_rows_reference(table, idx):
    """Plain version of K11: rows ``idx`` of ``table``."""
    return table.index_select(0, idx)


def _kernel():
    fn = _libs.get(_SOURCE)
    if fn is None:
        lib = cuda_build.load(_SOURCE)
        entry = lib.gather_rows_fwd
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        entry.argtypes = [p, ll, ll, ll, p, ll, p, p]
        entry.restype = ctypes.c_int
        lib.gather_rows_error_string.argtypes = [ctypes.c_int]
        lib.gather_rows_error_string.restype = ctypes.c_char_p
        fn = _libs[_SOURCE] = (entry, lib.gather_rows_error_string)
    return fn


def _launch(table, idx):
    """K11: out[i] = table[idx[i]] (zeros where idx[i] is outside
    [0, V)), on the current stream."""
    if table.dim() != 2:
        raise ValueError(f"gather_rows takes a [V, D] table, not "
                         f"{tuple(table.shape)}")
    if table.shape[1] > 1 and table.stride(1) != 1:
        raise ValueError("gather_rows: the table's rows must have unit "
                         "stride")
    v, d = table.shape
    n = idx.shape[0]
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n == 0 or d == 0:
        return out
    idx = idx.to(torch.int64).contiguous()
    s = table.element_size()
    fn, err_str = _kernel()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        rc = fn(table.data_ptr(), v, d * s, table.stride(0) * s,
                idx.data_ptr(), n, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows launch failed: "
                           f"{err_str(rc).decode()}")
    gather_rows.launches += 1
    return out


def gather_rows(table, idx, impl=None):
    """``table[idx]`` for a torch table ``[V, D]`` and ids ``[N]`` (numpy
    or torch, any integer type; already deduped/padded by the caller —
    out-of-range ids are the caller's bug, as in the reference, though
    K11 writes their rows as zeros rather than read outside the table).
    Returns a tensor ``[N, D]`` on the table's device.  K11 on a CUDA
    table, the plain version on a CPU table or with ``impl="plain"``."""
    if impl not in (None, "plain"):
        raise ValueError(f"gather_rows impl {impl!r}: None (K11 on a CUDA "
                         "table) or 'plain'")
    if not isinstance(idx, torch.Tensor):
        idx = torch.from_numpy(np.asarray(idx, np.int64))
    idx = idx.to(device=table.device, dtype=torch.int64)
    if impl == "plain" or table.device.type == "cpu":
        return gather_rows_reference(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on CUDA or CPU tables, not "
                         f"{table.device}")
    return _launch(table, idx)


gather_rows.launches = 0


def dedup_gather(table, flat_ids, bucket=True, impl=None):
    """The full dedup'd lookup against a LOCAL torch table: host dedup ->
    bucket-pad -> gather -> inverse scatter.  Returns [N, D] host numpy.
    (The distributed client performs the same steps with the gather split
    per owning shard — this is the single-shard core.)"""
    uniq, inv = dedup_ids(flat_ids)
    n_pad = pad_bucket(len(uniq)) if bucket else len(uniq)
    METRICS.inc("rows_padded", n_pad - len(uniq))
    # padding gathers row 0 — harmless (sliced away before the inverse)
    idx = np.zeros((n_pad,), np.int64)
    idx[:len(uniq)] = uniq
    rows = gather_rows(table, idx, impl=impl).cpu().numpy()
    return rows[:len(uniq)][inv]
