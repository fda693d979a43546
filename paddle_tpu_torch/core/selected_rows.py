"""SelectedRows: sparse row-set gradients for embedding tables (port of
``paddle_tpu/core/selected_rows.py``).

Reference: ``paddle/fluid/framework/selected_rows.h:32`` — a (row ids,
dense value block, height) triple used as the gradient type of
``lookup_table`` when ``is_sparse=True``, so a [V, D] table's gradient
costs O(touched rows), not O(V).

Here it is a plain holder of torch tensors.  Sparse-aware optimizer
kernels apply it with one ``index_add`` (duplicate ids accumulate,
matching the reference's merge-add semantics).  PyTorch runs eagerly,
so :meth:`merged` takes the exact unique row set; the JAX package padded
it to a static length with masked sentinels, which a traced step needs
and this one does not.
"""

import torch


class SelectedRows:
    """rows: int64 [N]; values: [N, ...]; height: the table's row count."""

    def __init__(self, rows, values, height):
        self.rows = rows
        self.values = values
        self.height = int(height)

    def to_dense(self):
        shape = (self.height,) + tuple(self.values.shape[1:])
        dense = torch.zeros(shape, dtype=self.values.dtype,
                            device=self.values.device)
        return dense.index_add(0, self.rows, self.values)

    def merged(self):
        """The reference's merge_selected_rows: one entry per distinct
        row, ascending — required before any non-linear use of the values
        (adagrad squares, adam moments)."""
        uniq, inv = torch.unique(self.rows, sorted=True,
                                 return_inverse=True)
        vals = torch.zeros((uniq.shape[0],) + tuple(self.values.shape[1:]),
                           dtype=self.values.dtype, device=self.values.device)
        return SelectedRows(uniq, vals.index_add(0, inv, self.values),
                            self.height)

    def __repr__(self):
        return (f"SelectedRows(rows={tuple(self.rows.shape)}, "
                f"values={tuple(self.values.shape)}, height={self.height})")


def is_selected_rows(x):
    return isinstance(x, SelectedRows)
