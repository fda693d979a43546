"""CTR model builders of the sharded-embedding slice, written against a
``fluid`` module given as an argument, so the port and the JAX package
build the same program from one definition:

- :func:`ctr_dnn`, the Wide&Deep CTR model of ``bench.py::_ctr_build``
  (:268-313): Paddle's CTR DNN on Criteo — 26 categorical slots through
  one shared deep table, a wide table of width 1, 13 dense features, a
  400-400-400 MLP, SGD 1e-3 — with the slot count and MLP widths as
  arguments; :func:`ctr_batch` makes a batch for it from a seed, as
  ``bench.py:396-402`` does;
- :func:`wide_deep_sharded`, the zoo's ``wide_deep_sharded`` tower
  (``models/zoo.py:135-173``) over one table looked up twice, Adagrad.

Both look their tables up with ``is_sparse=True``, so a table that stays
on the trainer trains through SelectedRows grads; declared with
``sparse.declare_sharded_table`` and rewritten by ``sparse.shard_program``
it leaves the trainer for the shard servers.
"""

import numpy as np

DEEP_TABLE, WIDE_TABLE = "ctr_deep_table", "ctr_wide_table"
CTR_VOCAB, CTR_DIM = 1000000, 16      # bench.py:316


def ctr_dnn(fluid, vocab, dim, n_slots=26, widths=(400, 400, 400)):
    """Build the CTR DNN into the current programs and minimize it with
    SGD(1e-3); returns the loss.  Feeds: ``C0..C{n_slots-1}`` int64
    [B, 1], ``dense`` float32 [B, 13], ``label`` int64 [B, 1]."""
    ids = [fluid.layers.data(name=f"C{i}", shape=[1], dtype="int64")
           for i in range(n_slots)]
    dense = fluid.layers.data(name="dense", shape=[13], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    deep_attr = fluid.ParamAttr(
        name=DEEP_TABLE,
        initializer=fluid.initializer.UniformInitializer(-0.01, 0.01))
    wide_attr = fluid.ParamAttr(
        name=WIDE_TABLE,
        initializer=fluid.initializer.ConstantInitializer(0.0))
    # ONE lookup per table over the concatenated slots (slot-major
    # [n_slots * B, 1]): each sharded lookup is one RPC round per shard
    all_ids = fluid.layers.concat(ids, axis=0)
    deep_rows = fluid.layers.embedding(
        all_ids, size=[vocab, dim], is_sparse=True, is_distributed=True,
        param_attr=deep_attr)                           # [n_slots*B, D]
    wide_rows = fluid.layers.embedding(
        all_ids, size=[vocab, 1], is_sparse=True, is_distributed=True,
        param_attr=wide_attr)                           # [n_slots*B, 1]
    deep = fluid.layers.reshape(                        # [B, n_slots*D]
        fluid.layers.transpose(
            fluid.layers.reshape(deep_rows, [n_slots, -1, dim]),
            perm=[1, 0, 2]),
        [-1, n_slots * dim])
    wide_sum = fluid.layers.reduce_sum(                 # [B, 1]
        fluid.layers.reshape(wide_rows, [n_slots, -1, 1]), dim=0)
    h = fluid.layers.concat([deep, dense], axis=1)
    for width in widths:
        h = fluid.layers.fc(h, size=width, act="relu")
    logit = fluid.layers.elementwise_add(
        fluid.layers.fc(h, size=1), wide_sum)
    loss = fluid.layers.mean(
        fluid.layers.sigmoid_cross_entropy_with_logits(
            logit, fluid.layers.cast(label, "float32")))
    fluid.optimizer.SGD(learning_rate=1e-3).minimize(loss)
    return loss


def ctr_batch(rng, batch, vocab, n_slots=26):
    """A feed for :func:`ctr_dnn` from a numpy RandomState: ids uniform
    over the vocabulary, dense features in [0, 1), 0/1 labels."""
    f = {f"C{i}": rng.randint(0, vocab, (batch, 1)).astype(np.int64)
         for i in range(n_slots)}
    f["dense"] = rng.rand(batch, 13).astype(np.float32)
    f["label"] = rng.randint(0, 2, (batch, 1)).astype(np.int64)
    return f


def wide_deep_sharded(fluid, vocab=2048, dim=16):
    """The zoo's Wide&Deep tower over ONE table ("wd_table") looked up
    twice, Adagrad(0.05): (main, startup, loss).  Feeds: ``ids``,
    ``wide_ids`` int64 [B, 1], ``dense`` float32 [B, 13], ``y`` float32
    [B, 1]."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        wide_ids = fluid.layers.data(name="wide_ids", shape=[1],
                                     dtype="int64")
        dense = fluid.layers.data(name="dense", shape=[13],
                                  dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(
            input=ids, size=[vocab, dim], is_sparse=True,
            param_attr=fluid.ParamAttr(name="wd_table"))
        wide_emb = fluid.layers.embedding(
            input=wide_ids, size=[vocab, dim], is_sparse=True,
            param_attr=fluid.ParamAttr(name="wd_table"))
        deep = fluid.layers.fc(input=[emb, wide_emb, dense], size=32,
                               act="relu")
        deep = fluid.layers.fc(input=deep, size=16, act="relu")
        wide = fluid.layers.fc(input=dense, size=1, act=None)
        logit = fluid.layers.fc(input=[deep, wide], size=1, act=None)
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(
                x=logit, label=y))
        fluid.optimizer.Adagrad(learning_rate=0.05).minimize(loss)
    return main, startup, loss
