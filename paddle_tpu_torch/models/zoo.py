"""Named model-zoo program builders (port of ``paddle_tpu/models/zoo.py``).

Each builder constructs a FULL training graph (forward + backward +
optimizer) in fresh programs and returns a :class:`ZooProgram`:
``main``/``startup`` programs, the feed declarations with CONCRETE
example shapes (dynamic -1 dims resolved to a small batch), and the
fetch names.  Every builder emits the JAX package's program op for op,
so a state from either package's ``snapshot_startup`` drives both, and
``run_steps(init_state=)`` compares their loss lists.

Configs are deliberately small: the point is graph SHAPE coverage
(conv / matmul / attention / embedding / control-free CTR), not
benchmark scale.

``snapshot_startup`` and ``run_steps`` run on the card unless the caller
passes ``place=fluid.CPUPlace()``.
"""

import collections

import numpy as np

ZooProgram = collections.namedtuple(
    "ZooProgram", ["name", "main", "startup", "feeds", "fetch_names"])

ZOO = collections.OrderedDict()      # name -> builder()


def zoo_model(name):
    def deco(fn):
        ZOO[name] = fn
        return fn
    return deco


def _fresh():
    import paddle_tpu_torch as fluid

    return fluid, fluid.Program(), fluid.Program()


@zoo_model("fit_a_line")
def _fit_a_line():
    fluid, main, startup = _fresh()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1, act=None)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return ZooProgram("fit_a_line", main, startup,
                      {"x": ((8, 13), "float32"),
                       "y": ((8, 1), "float32")}, [loss.name])


@zoo_model("recognize_digits_conv")
def _recognize_digits_conv():
    fluid, main, startup = _fresh()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1],
                                  dtype="int64")
        c1 = fluid.nets.simple_img_conv_pool(
            input=img, filter_size=5, num_filters=8, pool_size=2,
            pool_stride=2, act="relu")
        c2 = fluid.nets.simple_img_conv_pool(
            input=c1, filter_size=5, num_filters=16, pool_size=2,
            pool_stride=2, act="relu")
        pred = fluid.layers.fc(input=c2, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        acc = fluid.layers.accuracy(input=pred, label=label)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return ZooProgram("recognize_digits_conv", main, startup,
                      {"img": ((4, 1, 28, 28), "float32"),
                       "label": ((4, 1), "int64")},
                      [loss.name, acc.name])


@zoo_model("word2vec")
def _word2vec():
    fluid, main, startup = _fresh()
    dict_size, emb_size = 100, 16
    with fluid.program_guard(main, startup):
        words = [fluid.layers.data(name=f"w{i}", shape=[1],
                                   dtype="int64") for i in range(4)]
        nxt = fluid.layers.data(name="nxt", shape=[1], dtype="int64")
        embs = [fluid.layers.embedding(
            input=w, size=[dict_size, emb_size],
            param_attr=fluid.ParamAttr(name="shared_emb"))
            for w in words]
        concat = fluid.layers.concat(input=embs, axis=1)
        hidden = fluid.layers.fc(input=concat, size=32, act="sigmoid")
        pred = fluid.layers.fc(input=hidden, size=dict_size,
                               act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=nxt))
        fluid.optimizer.SGD(learning_rate=1e-3).minimize(loss)
    feeds = {f"w{i}": ((4, 1), "int64") for i in range(4)}
    feeds["nxt"] = ((4, 1), "int64")
    return ZooProgram("word2vec", main, startup, feeds, [loss.name])


@zoo_model("ctr_wide_deep")
def _ctr_wide_deep():
    """DeepFM-flavored CTR tower: sparse embedding + dense MLP + wide
    linear term (the PAPER.md CTR config, zoo-scale)."""
    fluid, main, startup = _fresh()
    vocab, dim = 50, 8
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        dense = fluid.layers.data(name="dense", shape=[13],
                                  dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(
            input=ids, size=[vocab, dim],
            param_attr=fluid.ParamAttr(name="ctr_table"))
        deep = fluid.layers.fc(input=[emb, dense], size=16, act="relu")
        deep = fluid.layers.fc(input=deep, size=8, act="relu")
        wide = fluid.layers.fc(input=dense, size=1, act=None)
        logit = fluid.layers.fc(input=[deep, wide], size=1, act=None)
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(
                x=logit, label=y))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return ZooProgram("ctr_wide_deep", main, startup,
                      {"ids": ((4, 1), "int64"),
                       "dense": ((4, 13), "float32"),
                       "y": ((4, 1), "float32")}, [loss.name])


@zoo_model("wide_deep_sharded")
def _wide_deep_sharded():
    """Wide&Deep CTR tower over ONE big sparse table ("wd_table") — the
    sharded-embedding-engine surface.  Built as a plain
    single-process program (lints/trains locally as-is); the sparse
    runner declares "wd_table" via sparse.declare_sharded_table and
    rewrites with sparse.shard_program, after which the table leaves
    the trainer program entirely.  Vocab is deliberately above
    FLAGS_sparse_shard_min_rows so the declared table actually
    shards."""
    fluid, main, startup = _fresh()
    vocab, dim = 2048, 16
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
    return ZooProgram("wide_deep_sharded", main, startup,
                      {"ids": ((8, 1), "int64"),
                       "wide_ids": ((8, 1), "int64"),
                       "dense": ((8, 13), "float32"),
                       "y": ((8, 1), "float32")}, [loss.name])


@zoo_model("resnet_cifar10")
def _resnet_cifar10():
    fluid, main, startup = _fresh()
    from . import resnet

    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 32, 32],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1],
                                  dtype="int64")
        pred = resnet.resnet_cifar10(img, class_dim=10, depth=8)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(loss)
    return ZooProgram("resnet_cifar10", main, startup,
                      {"img": ((2, 3, 32, 32), "float32"),
                       "label": ((2, 1), "int64")}, [loss.name])


@zoo_model("vgg16")
def _vgg16():
    fluid, main, startup = _fresh()
    from . import vgg

    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 32, 32],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1],
                                  dtype="int64")
        pred = vgg.vgg16_bn_drop(img, class_dim=10)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return ZooProgram("vgg16", main, startup,
                      {"img": ((2, 3, 32, 32), "float32"),
                       "label": ((2, 1), "int64")}, [loss.name])


@zoo_model("transformer")
def _transformer():
    fluid, main, startup = _fresh()
    from . import transformer as tr

    B, T, H = 2, 8, 2
    with fluid.program_guard(main, startup):
        avg_cost, predict, feed_names = tr.transformer(
            src_vocab_size=32, trg_vocab_size=32, max_length=16,
            n_layer=1, n_head=H, d_key=8, d_value=8, d_model=16,
            d_inner_hid=32, dropout_rate=0.1)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    feeds = {
        "src_word": ((B, T), "int64"), "src_pos": ((B, T), "int64"),
        "trg_word": ((B, T), "int64"), "trg_pos": ((B, T), "int64"),
        "src_slf_attn_bias": ((B, H, T, T), "float32"),
        "trg_slf_attn_bias": ((B, H, T, T), "float32"),
        "trg_src_attn_bias": ((B, H, T, T), "float32"),
        "lbl_word": ((B, T, 1), "int64"),
        "lbl_weight": ((B, T, 1), "float32"),
    }
    return ZooProgram("transformer", main, startup, feeds,
                      [avg_cost.name])


@zoo_model("bert_pretrain")
def _bert_pretrain():
    fluid, main, startup = _fresh()
    from .bert import BertConfig, bert_pretrain

    B, T, M = 2, 16, 3
    cfg = BertConfig(vocab_size=64, hidden_size=32, num_layers=1,
                     num_heads=2, intermediate_size=64,
                     max_position=32, type_vocab_size=2, dropout=0.1)
    with fluid.program_guard(main, startup):
        total_loss, feed_names = bert_pretrain(cfg, max_seq_len=T)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(total_loss)
    feeds = {
        "src_ids": ((B, T), "int64"), "pos_ids": ((B, T), "int64"),
        "sent_ids": ((B, T), "int64"),
        "attn_bias": ((B, 1, 1, T), "float32"),
        "mask_pos": ((B * M, 1), "int64"),
        "mlm_label": ((B * M, 1), "int64"),
        "mlm_weight": ((B * M, 1), "float32"),
        "nsp_label": ((B, 1), "int64"),
    }
    return ZooProgram("bert_pretrain", main, startup, feeds,
                      [total_loss.name])


def build(name):
    if name not in ZOO:
        raise KeyError(f"unknown zoo model {name!r}; "
                       f"known: {sorted(ZOO)}")
    return ZOO[name]()


def names():
    return list(ZOO)


def snapshot_startup(zp, place=None):
    """Run the startup program once and return a host copy of the
    initialized state — the reusable init for paired A/B runs (both
    arms must start from bit-identical parameters, and re-running an
    unseeded startup re-randomizes)."""
    import paddle_tpu_torch as fluid

    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(zp.startup, scope=scope)
    return {n: v.detach().cpu().numpy().copy()
            for n, v in scope.vars.items() if v is not None}


def run_steps(zp, steps=3, seed=0, init_state=None, place=None):
    """Train a ZooProgram for `steps` on its example feed; returns the
    per-step loss list (floats).  With `init_state` (snapshot_startup
    of either package), the scope starts from that state instead of
    running startup — the paired-A/B contract."""
    import paddle_tpu_torch as fluid

    exe = fluid.Executor(place)
    if init_state is None:
        scope = fluid.Scope()
        exe.run(zp.startup, scope=scope)
    else:
        scope = fluid.io.state_from_numpy(
            init_state, scope=fluid.Scope(), place=exe.place,
            main_program=zp.main)
    feed = example_feed_arrays(zp, seed=seed)
    losses = []
    for _ in range(steps):
        out = exe.run(zp.main, feed=feed, fetch_list=zp.fetch_names,
                      scope=scope)
        losses.append(float(np.asarray(out[0])))
    return losses


def example_feed_arrays(zp, seed=0):
    """Concrete arrays matching a ZooProgram's feed specs — int feeds
    get small in-vocab indices, floats get a seeded normal."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, (shape, dtype) in zp.feeds.items():
        if np.issubdtype(np.dtype(dtype), np.integer):
            out[name] = rng.randint(0, 2, size=shape).astype(dtype)
        else:
            out[name] = rng.randn(*shape).astype(dtype)
    return out


def measured_memory(zp, program=None, seed=0):
    """The JAX package reads XLA's compiled memory statistics here, the
    counterpart of the static memory plan; the port has neither the
    planner nor a compiled step yet."""
    raise NotImplementedError(
        "zoo.measured_memory needs the memory planner (memplan/), which "
        "is not ported yet (ROADMAP queue 1 item 7)")
