"""Async sparse optimizer applied on the owning shard (touched rows
only) — the port of ``paddle_tpu/sparse/optim.py``.

Each grad push is applied the moment it arrives (no round barrier — the
reference's async CTR loop), under the shard server's table lock, and
updates ONLY the touched rows' params and slot state.  The update rules
are not reimplemented: the shard builds a :class:`SelectedRows` grad and
dispatches through the very kernels ``ops/optimizer_ops.py`` registered
for the trainer (the sgd / adagrad / lazy adam SelectedRows arms), so the
server-applied math is the same code the single-process trainer runs.
"""

import numpy as np
import torch

from ..core.selected_rows import SelectedRows


class SparseOptimizer:
    """Touched-rows optimizer state for ONE table shard, on host tensors.

    kind — "sgd" | "adagrad" | "adam" (the reference's sparse-capable
    rules; adam runs lazy_mode=True — only touched rows' moments
    advance, the sparse-table semantics of the reference's
    DownpourSparseTable accessor).
    """

    KINDS = ("sgd", "adagrad", "adam")

    def __init__(self, kind, learning_rate, shape, dtype="float32",
                 attrs=None):
        if kind not in self.KINDS:
            raise ValueError(
                f"sparse optimizer {kind!r} not supported; touched-rows "
                f"variants exist for {self.KINDS}")
        self.kind = kind
        self.lr = float(learning_rate)
        self.shape = tuple(shape)
        self.attrs = dict(attrs or {})
        self.dtype = dtype
        self.slots = {}
        if kind == "adagrad":
            self.slots["Moment"] = np.zeros(shape, dtype)
        elif kind == "adam":
            self.slots["Moment1"] = np.zeros(shape, dtype)
            self.slots["Moment2"] = np.zeros(shape, dtype)
            self.slots["Beta1Pow"] = np.full((1,), 1.0, dtype)
            self.slots["Beta2Pow"] = np.full((1,), 1.0, dtype)
            self.attrs.setdefault("lazy_mode", True)

    def apply(self, values, rows, grads):
        """One async application: ``values`` [H, D] numpy (the shard-local
        table), ``rows`` int [K] LOCAL indices, ``grads`` [K, D].

        Updates ``values`` and the row-shaped slots IN PLACE and returns
        ``values``: the kernel runs on the touched rows' sub-block (the
        unique rows, re-indexed 0..U-1), and the results are written back
        into those rows, so a push costs O(touched rows), not a copy of
        the [H, D] block.  Every rule here touches only the grad's rows
        (adam in lazy mode); non-lazy adam moves every row, so it runs on
        the whole block."""
        from ..ops import registry

        rows = np.asarray(rows).reshape(-1).astype(np.int64)
        if rows.size == 0:
            return values
        if self.kind == "adam" and not self.attrs.get("lazy_mode"):
            touched, local = np.arange(values.shape[0]), rows
        else:
            touched, local = np.unique(rows, return_inverse=True)
        block = {"Param": values[touched]}
        for slot, arr in self.slots.items():
            block[slot] = arr[touched] if arr.shape == self.shape else arr
        sr = SelectedRows(torch.from_numpy(local.reshape(-1)),
                          torch.from_numpy(np.asarray(grads, values.dtype)
                                           .reshape(rows.shape[0], -1)),
                          touched.shape[0])
        ins = {slot: [torch.from_numpy(np.ascontiguousarray(a))]
               for slot, a in block.items()}
        ins["Grad"] = [sr]
        ins["LearningRate"] = [torch.tensor([self.lr],
                                            dtype=ins["Param"][0].dtype)]
        out = registry.run_op(self.kind, ins, dict(self.attrs))
        values[touched] = out["ParamOut"][0].numpy()
        for slot, arr in self.slots.items():
            new = out.get(slot + "Out")
            if not new:
                continue
            if arr.shape == self.shape:
                arr[touched] = new[0].numpy()
            else:
                self.slots[slot] = new[0].numpy().astype(self.dtype)
        return values

    def slot_arrays(self):
        """{slot name: np array} (what a shard checkpoint saves)."""
        return dict(self.slots)
