"""The dp x tp x sp x pp training step of ``__graft_entry__.py:132-219``
(``_dryrun_one``), written against a ``fluid`` module given as an
argument, so the port and the JAX package build the same program from
one definition.

Embedding, a column-sharded QKV ``fc``, ``ring_attention(causal=True,
seq_axis="seq", batch_axis="data")``, a row-sharded output ``fc``,
``reduce_mean`` over the sequence, a ``PipelineStack`` of one relu ``fc``
a stage (the ``gpipe`` op), a softmax ``fc``, cross entropy and Momentum.
Run through ``CompiledProgram`` over a mesh with the data, model, seq
and pipe axes, its loss must be the single-device run's within 1e-3.
"""

import numpy as np

VOCAB, CLASSES = 64, 8


def factorizations(n_devices):
    """The (dp, tp, sp, pp) factorizations the reference's dry run takes
    for `n_devices` (8 -> (2,2,1,2) and (2,2,2,1); 16 -> (2,2,2,2))."""
    def f2(n):
        return 2 if n % 2 == 0 and n >= 2 else 1

    dp = f2(n_devices)
    rest = n_devices // dp
    tp = f2(rest)
    rest //= tp
    pp = f2(rest)
    sp = rest // pp
    out = [(dp, tp, sp, pp)]
    if n_devices == 8:
        out.append((2, 2, 2, 1))
    return out


def configs(sp):
    """The reference's two configurations, (d_model, n_heads, seq_len,
    bs_per_dp, microbatches): a tiny wiring check and a BERT-block-shaped
    one."""
    return [(16, 2, 4 * max(sp, 2), 2, 2), (256, 4, 512 * sp, 4, 4)]


def dryrun_program(fluid, d_model, n_heads, seq_len, pp, microbatches):
    """Build the step into the caller's program guard (and name guard);
    returns the loss variable."""
    layers = fluid.layers
    ids = layers.data(name="ids", shape=[seq_len], dtype="int64")
    label = layers.data(name="label", shape=[1], dtype="int64")
    emb = layers.embedding(input=ids, size=[VOCAB, d_model])
    # tensor-parallel QKV projection (column) + output proj (row)
    qkv = layers.fc(input=emb, size=3 * d_model, num_flatten_dims=2,
                    param_attr=fluid.ParamAttr(sharding=(None, "model")))
    q, k, v = layers.split(qkv, 3, dim=-1)

    def heads(x):
        return layers.reshape(x, [-1, seq_len, n_heads, d_model // n_heads])

    attn = layers.ring_attention(heads(q), heads(k), heads(v), causal=True,
                                 seq_axis="seq", batch_axis="data")
    merged = layers.reshape(attn, [-1, seq_len, d_model])
    proj = layers.fc(input=merged, size=d_model, num_flatten_dims=2,
                     param_attr=fluid.ParamAttr(sharding=("model", None)))
    pooled = layers.reduce_mean(proj, dim=1)
    # pipeline-parallel MLP stack over the "pipe" axis (GPipe)
    pipe = layers.PipelineStack(num_stages=pp,
                                num_microbatches=microbatches)
    with pipe.block():
        h = pipe.stage_input(pooled)
        h = layers.fc(h, size=d_model, act="relu")
        pipe.output(h)
    pooled = pipe()
    pred = layers.fc(input=pooled, size=CLASSES, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=pred, label=label))
    fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9) \
        .minimize(loss)
    return loss


def dryrun_feed(batch, seq_len, seed=0):
    """The reference's batch: ids uniform over the vocabulary, labels over
    the classes, from a numpy seed."""
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, VOCAB, (batch, seq_len)).astype(np.int64),
            "label": rng.randint(0, CLASSES, (batch, 1)).astype(np.int64)}
