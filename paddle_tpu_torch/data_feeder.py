"""DataFeeder: rows of python/numpy data -> feed dict of batched arrays
(port of ``paddle_tpu/data_feeder.py``).

Reference: ``python/paddle/fluid/data_feeder.py:100`` converts minibatch
rows to LoDTensors per feed var, handling lod_level>0 by building offset
tables.  The port lowers ragged data to dense + lengths (SURVEY §5.7), so
for lod_level>0 vars the feeder pads to the longest sequence in the
batch and emits a companion ``<name>@SEQ_LEN`` int32 array consumed by
sequence ops.

Rows are VALIDATED against the feed var's declared shape/dtype before
they reach a kernel: a silently reshaped/truncated batch surfaces as an
inscrutable shape error (or worse, trains on garbage), so a mismatch
raises a ValueError naming the variable instead.
"""

import numpy as np

from .core.framework import Variable
from .ops.registry import np_dtype


def _check_dtype(var, arr, want):
    """Reject lossy row dtypes: float/complex rows into an integer var
    would silently truncate, int values beyond a narrower int target's
    range would silently wrap, and object/str rows can't become a
    tensor at all.  Precision conversions that are the
    common intended feeds (int rows into a float var, float64 rows
    into a float32 var, in-range ints into a narrower int) stay
    allowed."""
    have = arr.dtype
    if have == want:
        return
    if have.kind in "OUS":
        raise ValueError(
            f"feed var {var.name!r} declares dtype {var.dtype} but got "
            f"rows of non-numeric dtype {have}")
    if want.kind in "iub" and have.kind not in "iub":
        raise ValueError(
            f"feed var {var.name!r} declares dtype {var.dtype} but got "
            f"rows of dtype {have} — refusing to silently truncate "
            "float data into an integer feed")
    if want.kind in "iu" and have.kind in "iu" and \
            have.itemsize > want.itemsize and arr.size and \
            (arr.max() > np.iinfo(want).max or
             arr.min() < np.iinfo(want).min):
        raise ValueError(
            f"feed var {var.name!r} (dtype {var.dtype}, stored as "
            f"{want}) got {have} rows whose values exceed the lowered "
            f"range (max {arr.max()}) — they would silently wrap; "
            "declare a wider dtype")


def _check_row_shape(var, arr, n_rows):
    """Validate the batched array against the var's declared per-example
    shape when every per-example dim is known.  Rows may arrive flat
    (a 784-vector for a (-1, 1, 28, 28) var — fluid's converter
    reshapes those), so the check is on total per-example size."""
    shape = var.shape
    if shape is None:
        return None
    per_ex = tuple(d for d in shape[1:])
    if not per_ex or not all(d is not None and d > 0 for d in per_ex):
        return None
    want = (n_rows,) + per_ex
    if arr.shape == want:
        return None
    if arr.size == int(np.prod(want)):
        return want                      # flat rows: reshape below
    got = arr.shape[1:] if arr.ndim > 1 else (arr.size // max(n_rows, 1),)
    raise ValueError(
        f"feed var {var.name!r} declares per-example shape "
        f"{list(per_ex)} but the fed rows have shape {list(got)} "
        f"({arr.size} elements for {n_rows} rows, expected "
        f"{int(np.prod(want))})")


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_vars = []
        for v in feed_list:
            if not isinstance(v, Variable):
                if program is None:
                    raise ValueError("string feed names need `program`")
                v = program.global_block().var(v)
            self.feed_vars.append(v)
        self.place = place

    def feed(self, iterable):
        rows = list(iterable)
        out = {}
        for i, var in enumerate(self.feed_vars):
            cols = [row[i] for row in rows]
            dtype = np_dtype(var.dtype) if var.dtype != "bfloat16" \
                else np.float32
            if var.lod_level == 0:
                arr = np.asarray(cols)
                _check_dtype(var, arr, np.dtype(dtype))
                if arr.dtype != dtype:
                    arr = arr.astype(dtype)
                want = _check_row_shape(var, arr, len(rows))
                if want is not None:
                    # reshape each row to the declared per-example shape
                    # (fluid's DataFeeder converter does this for rows fed
                    # flat, e.g. a 784-vector for a (-1, 1, 28, 28) var)
                    arr = arr.reshape(want)
                out[var.name] = arr
            else:
                # ragged: pad to the length bucket (lod.to_padded honors
                # FLAGS_seq_len_bucket), emit seq-len sidecar
                from .core.lod import to_padded
                batch, lens = to_padded([np.asarray(c) for c in cols],
                                        dtype=dtype)
                out[var.name] = batch
                out[var.name + "@SEQ_LEN"] = lens
        return out
