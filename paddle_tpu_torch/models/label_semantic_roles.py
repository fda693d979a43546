"""The semantic-role labeller of Paddle's book (Fluid 1.3 book chapter
"label_semantic_roles", ``tests/book/test_label_semantic_roles.py``; the
repo's copy is ``tests/book/test_label_semantic_roles.py``), written
against a ``fluid`` module given as an argument, so the port and the JAX
package build the same programs from one definition:

- :func:`db_lstm`: eight features embedded (the six word-context features
  through one frozen pretrained table ``emb``), one fc each summed, then
  a stack of ``depth`` ``dynamic_lstm`` layers of alternating direction
  (sigmoid gates, a relu candidate and a sigmoid cell, the ``lstm`` op's
  peepholes), each fed the sum of two fcs of the layer below, and two
  tanh fcs to the label space summed: the emission;
- :func:`train_net`: the ``linear_chain_crf`` cost over the emission
  (its transition ``crfw`` learning at ``mix_hidden_lr``), Adam under
  ``exponential_decay``, as the repo's test trains it;
- :func:`decode_net`: the same network and ``crf_decoding`` sharing the
  ``crfw`` transition, so run in the training program's scope it decodes
  with the trained weights (every parameter is named);
- :func:`train_batch` and :func:`decode_feed`: a synthetic batch of the
  test's kind (tag = (word + mark) % label dictionary), lengths drawn
  from a range; :func:`pretrained_embedding`: the frozen table, made
  from a seed.

``BOOK`` holds the published sizes: the conll05 dictionaries (words
44068, predicates 3162, labels 106) and the chapter's word_dim 32,
mark_dim 5, hidden_dim 512 (so each LSTM's cell is 128 wide: the
``lstm`` op's input is 4 x its cell), depth 8, mix_hidden_lr 1e-3 and
batch 10 (Fluid 1.3 book, 07.label_semantic_roles/train.py).  ``TEST``
holds the repo test's cut: dictionaries 40, 10 and 9, word_dim 40,
hidden_dim 64, depth 4.
"""

import numpy as np

BOOK = dict(word_dict_len=44068, pred_dict_len=3162, label_dict_len=106,
            mark_dict_len=2, word_dim=32, mark_dim=5, hidden_dim=512,
            depth=8, mix_hidden_lr=1e-3)
BOOK_BATCH = 10
TEST = dict(word_dict_len=40, pred_dict_len=10, label_dict_len=9,
            mark_dict_len=2, word_dim=40, mark_dim=5, hidden_dim=64,
            depth=4, mix_hidden_lr=1e-3)
EMBEDDING_NAME = "emb"
FEATURES = ["word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
            "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data"]


def _fc(fluid, x, size, name, act=None):
    return fluid.layers.fc(input=x, size=size, act=act,
                           param_attr=fluid.ParamAttr(name=f"{name}_w"),
                           bias_attr=fluid.ParamAttr(name=f"{name}_b"))


def feature_inputs(fluid):
    """The eight lod-1 int64 feature inputs, by name."""
    return {name: fluid.layers.data(name=name, shape=[1], dtype="int64",
                                    lod_level=1) for name in FEATURES}


def db_lstm(fluid, feats, word_dict_len, pred_dict_len, label_dict_len,
            mark_dict_len, word_dim, mark_dim, hidden_dim, depth, **_):
    """The emission [B, T, label_dict_len] of the feature inputs."""
    layers = fluid.layers
    predicate_embedding = layers.embedding(
        input=feats["verb_data"], size=[pred_dict_len, word_dim],
        dtype="float32", param_attr=fluid.ParamAttr(name="vemb"))
    mark_embedding = layers.embedding(
        input=feats["mark_data"], size=[mark_dict_len, mark_dim],
        dtype="float32", param_attr=fluid.ParamAttr(name="memb"))
    emb_layers = [
        layers.embedding(
            size=[word_dict_len, word_dim], input=feats[name],
            param_attr=fluid.ParamAttr(name=EMBEDDING_NAME,
                                       trainable=False))
        for name in FEATURES[:6]]
    emb_layers += [predicate_embedding, mark_embedding]

    hidden_0 = layers.sums(input=[
        _fc(fluid, emb, hidden_dim, f"hidden0_{i}")
        for i, emb in enumerate(emb_layers)])
    lstm_0 = layers.dynamic_lstm(
        input=hidden_0, size=hidden_dim, candidate_activation="relu",
        gate_activation="sigmoid", cell_activation="sigmoid",
        param_attr=fluid.ParamAttr(name="lstm0_w"),
        bias_attr=fluid.ParamAttr(name="lstm0_b"))

    input_tmp = [hidden_0, lstm_0[0]]
    for i in range(1, depth):
        mix_hidden = layers.sums(input=[
            _fc(fluid, input_tmp[0], hidden_dim, f"mix{i}_a"),
            _fc(fluid, input_tmp[1], hidden_dim, f"mix{i}_b")])
        lstm = layers.dynamic_lstm(
            input=mix_hidden, size=hidden_dim,
            candidate_activation="relu", gate_activation="sigmoid",
            cell_activation="sigmoid", is_reverse=((i % 2) == 1),
            param_attr=fluid.ParamAttr(name=f"lstm{i}_w"),
            bias_attr=fluid.ParamAttr(name=f"lstm{i}_b"))
        input_tmp = [mix_hidden, lstm[0]]

    return layers.sums(input=[
        _fc(fluid, input_tmp[0], label_dict_len, "out_a", act="tanh"),
        _fc(fluid, input_tmp[1], label_dict_len, "out_b", act="tanh")])


def train_net(fluid, learning_rate=0.001, decay_steps=100000,
              decay_rate=0.5, **sizes):
    """The repo test's training program: the mean CRF cost, minimized by
    Adam under a staircase exponential decay.  Returns (avg_cost,
    emission)."""
    feature_out = db_lstm(fluid, feature_inputs(fluid), **sizes)
    target = fluid.layers.data(name="target", shape=[1], dtype="int64",
                               lod_level=1)
    crf_cost = fluid.layers.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=fluid.ParamAttr(name="crfw",
                                   learning_rate=sizes["mix_hidden_lr"]))
    avg_cost = fluid.layers.mean(crf_cost)
    fluid.optimizer.Adam(
        learning_rate=fluid.layers.exponential_decay(
            learning_rate=learning_rate, decay_steps=decay_steps,
            decay_rate=decay_rate, staircase=True)).minimize(avg_cost)
    return avg_cost, feature_out


def decode_net(fluid, **sizes):
    """The network and its Viterbi decode over the ``crfw`` transition:
    returns the path [B, T, 1] (0 past each length)."""
    feature_out = db_lstm(fluid, feature_inputs(fluid), **sizes)
    return fluid.layers.crf_decoding(
        input=feature_out, param_attr=fluid.ParamAttr(name="crfw"))


def pretrained_embedding(seed, word_dict_len, word_dim, **_):
    """The frozen word table [word_dict_len, word_dim] made from `seed`
    (the book loads conll05's pretrained embedding)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((word_dict_len, word_dim))
            / np.sqrt(word_dim)).astype(np.float32)


def train_batch(rng, batch_size, word_dict_len, pred_dict_len,
                label_dict_len, mark_dict_len, lens=(2, 8), **_):
    """A synthetic batch of the repo test's kind: lengths uniform in
    [lens[0], lens[1]), the context features the word sequence rolled,
    and tag = (word + mark) % label_dict_len, which the frozen table and
    the mark embedding carry through the network."""
    feed = {name: [] for name in FEATURES}
    feed["target"] = []
    for _ in range(batch_size):
        n = int(rng.integers(*lens))
        word = rng.integers(0, word_dict_len, size=(n,))
        mark = rng.integers(0, mark_dict_len, size=(n,))
        feed["word_data"].append(word)
        feed["ctx_n2_data"].append(np.roll(word, 2))
        feed["ctx_n1_data"].append(np.roll(word, 1))
        feed["ctx_0_data"].append(word.copy())
        feed["ctx_p1_data"].append(np.roll(word, -1))
        feed["ctx_p2_data"].append(np.roll(word, -2))
        feed["verb_data"].append(rng.integers(0, pred_dict_len, size=(n,)))
        feed["mark_data"].append(mark)
        feed["target"].append((word + mark) % label_dict_len)
    return feed


def decode_feed(batch):
    """The decode program's feed: a training batch without its target."""
    return {name: batch[name] for name in FEATURES}
