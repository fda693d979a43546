"""The machine-translation model of Paddle's book (Fluid 1.3
``tests/book/test_machine_translation.py``; the repo's copy is
``tests/book/test_machine_translation.py``), written against a ``fluid``
module given as an argument, so the port and the JAX package build the
same programs from one definition:

- :func:`train_net`: an embedding -> fc(tanh) -> ``dynamic_lstm`` encoder
  (its last step the context) and a DynamicRNN decoder with a softmax
  over the dictionary, trained with cross entropy;
- :func:`decode_net`: the same encoder and the static-beam decode: a
  ``While`` loop over tensor arrays of ids, scores, parents and states,
  ``topk`` -> ``beam_search`` -> ``gather`` of the states by parent, then
  ``beam_search_decode``;
- :func:`train_batch` and :func:`decode_feed`: the book test's synthetic
  batch (label = (input + 3) % dictionary, source = the reversed labels)
  and the decode's feed, one row per (sentence, beam).

The encoder and the decoders share parameters by name (``vemb`` between
the source and target embeddings), so a decode program run in the
training program's scope decodes with the trained weights.  The book's
published sizes are ``BOOK``; the repo's test cuts the dictionary to 30.
"""

import numpy as np

BOOK = dict(dict_size=30000, word_dim=16, hidden_dim=32, beam_size=2,
            max_length=8, end_id=10)


def encoder(fluid, dict_size, word_dim, hidden_dim):
    layers = fluid.layers
    src_word_id = layers.data(name="src_word_id", shape=[1], dtype="int64",
                              lod_level=1)
    src_embedding = layers.embedding(
        input=src_word_id, size=[dict_size, word_dim], dtype="float32",
        param_attr=fluid.ParamAttr(name="vemb"))
    fc1 = layers.fc(input=src_embedding, size=hidden_dim * 4, act="tanh",
                    param_attr=fluid.ParamAttr(name="enc_fc_w"),
                    bias_attr=fluid.ParamAttr(name="enc_fc_b"))
    lstm_hidden0, _ = layers.dynamic_lstm(
        input=fc1, size=hidden_dim * 4,
        param_attr=fluid.ParamAttr(name="enc_lstm_w"),
        bias_attr=fluid.ParamAttr(name="enc_lstm_b"))
    return layers.sequence_last_step(input=lstm_hidden0)


def _state_and_score(fluid, word_emb, pre_state, dict_size, decoder_size):
    layers = fluid.layers
    state = layers.fc(
        input=[word_emb, pre_state], size=decoder_size, act="tanh",
        param_attr=[fluid.ParamAttr(name="dec_state_w_word"),
                    fluid.ParamAttr(name="dec_state_w_state")],
        bias_attr=fluid.ParamAttr(name="dec_state_b"))
    score = layers.fc(input=state, size=dict_size, act="softmax",
                      param_attr=fluid.ParamAttr(name="dec_score_w"),
                      bias_attr=fluid.ParamAttr(name="dec_score_b"))
    return state, score


def decoder_train(fluid, context, dict_size, word_dim, decoder_size):
    layers = fluid.layers
    trg_language_word = layers.data(name="target_language_word", shape=[1],
                                    dtype="int64", lod_level=1)
    trg_embedding = layers.embedding(
        input=trg_language_word, size=[dict_size, word_dim],
        dtype="float32", param_attr=fluid.ParamAttr(name="vemb"))
    rnn = layers.DynamicRNN()
    with rnn.block():
        current_word = rnn.step_input(trg_embedding)
        pre_state = rnn.memory(init=context)
        current_state, current_score = _state_and_score(
            fluid, current_word, pre_state, dict_size, decoder_size)
        rnn.update_memory(pre_state, current_state)
        rnn.output(current_score)
    return rnn()


def decoder_decode(fluid, context, dict_size, word_dim, decoder_size,
                   beam_size, max_length, end_id):
    """Static-beam decode: context [B, H] is expanded to [B*K, H]; the
    loop carries (ids, scores, parents, state) tensor arrays."""
    layers = fluid.layers
    init_state = layers.expand(
        layers.reshape(context, shape=[-1, 1, decoder_size]),
        expand_times=[1, beam_size, 1])
    init_state = layers.reshape(init_state, shape=[-1, decoder_size])

    counter = layers.zeros(shape=[1], dtype="int64")
    array_len = layers.fill_constant(shape=[1], dtype="int64",
                                     value=max_length)
    state_array = layers.create_array("float32", capacity=max_length + 1)
    ids_array = layers.create_array("int64", capacity=max_length + 1)
    scores_array = layers.create_array("float32", capacity=max_length + 1)
    parents_array = layers.create_array("int64", capacity=max_length + 1)

    init_ids = layers.data(name="init_ids", shape=[1], dtype="int64")
    init_scores = layers.data(name="init_scores", shape=[1],
                              dtype="float32")
    init_parents = layers.fill_constant_batch_size_like(
        input=init_ids, shape=[-1], dtype="int64", value=0)

    layers.array_write(init_state, array=state_array, i=counter)
    layers.array_write(init_ids, array=ids_array, i=counter)
    layers.array_write(init_scores, array=scores_array, i=counter)
    layers.array_write(init_parents, array=parents_array, i=counter)

    cond = layers.less_than(x=counter, y=array_len)
    while_op = layers.While(cond=cond)
    with while_op.block():
        pre_ids = layers.array_read(array=ids_array, i=counter)
        pre_state = layers.array_read(array=state_array, i=counter)
        pre_score = layers.array_read(array=scores_array, i=counter)
        pre_ids_emb = layers.embedding(
            input=pre_ids, size=[dict_size, word_dim], dtype="float32",
            param_attr=fluid.ParamAttr(name="vemb"))
        current_state, current_score = _state_and_score(
            fluid, pre_ids_emb, pre_state, dict_size, decoder_size)
        topk_scores, topk_indices = layers.topk(current_score, k=beam_size)
        accu_scores = layers.elementwise_add(
            x=layers.log(topk_scores), y=pre_score, axis=0)
        selected_ids, selected_scores, parent_idx = layers.beam_search(
            pre_ids, pre_score, topk_indices, accu_scores, beam_size,
            end_id=end_id)
        # reorder decoder state to the surviving beams' parents
        next_state = layers.gather(current_state, parent_idx)

        layers.increment(x=counter, value=1, in_place=True)
        layers.array_write(next_state, array=state_array, i=counter)
        layers.array_write(selected_ids, array=ids_array, i=counter)
        layers.array_write(selected_scores, array=scores_array, i=counter)
        layers.array_write(parent_idx, array=parents_array, i=counter)
        layers.less_than(x=counter, y=array_len, cond=cond)

    return layers.beam_search_decode(ids_array, scores_array, beam_size,
                                     end_id, parents=parents_array)


def train_net(fluid, dict_size, word_dim, hidden_dim, learning_rate=0.01,
              **_):
    """The training program's body: returns avg_cost after Adam's
    minimize (build it inside a program_guard)."""
    context = encoder(fluid, dict_size, word_dim, hidden_dim)
    rnn_out = decoder_train(fluid, context, dict_size, word_dim, hidden_dim)
    label = fluid.layers.data(name="target_language_next_word", shape=[1],
                              dtype="int64", lod_level=1)
    cost = fluid.layers.cross_entropy(input=rnn_out, label=label)
    avg_cost = fluid.layers.mean(cost)
    fluid.optimizer.Adam(learning_rate=learning_rate).minimize(avg_cost)
    return avg_cost


def decode_net(fluid, dict_size, word_dim, hidden_dim, beam_size,
               max_length, end_id):
    """The decode program's body: returns (translation_ids [B, K,
    max_length + 1], translation_scores [B, K])."""
    context = encoder(fluid, dict_size, word_dim, hidden_dim)
    return decoder_decode(fluid, context, dict_size, word_dim, hidden_dim,
                          beam_size, max_length, end_id)


def train_batch(rng, batch, dict_size):
    """Synthetic translation (the book test's ``_train_batch``): label =
    (decoder input + 3) % dict_size; source = reversed labels, lengths
    2-6.  `rng` is a ``np.random.Generator``."""
    srcs, trgs, labels = [], [], []
    for _ in range(batch):
        n = int(rng.integers(2, 7))
        trg_in = rng.integers(0, dict_size, size=(n,))
        srcs.append(((trg_in + 3) % dict_size)[::-1].copy())
        trgs.append(trg_in)
        labels.append((trg_in + 3) % dict_size)
    return {"src_word_id": srcs, "target_language_word": trgs,
            "target_language_next_word": labels}


def decode_feed(srcs, beam_size, bos_id=1):
    """The decode program's feed for source sentences `srcs`: every beam
    starts at `bos_id`, and only beam 0 of a sentence is live at t = 0."""
    n = len(srcs) * beam_size
    init_ids = np.full((n, 1), bos_id, np.int64)
    init_scores = np.full((n, 1), -1e9, np.float32)
    init_scores[::beam_size] = 0.0
    return {"src_word_id": list(srcs), "init_ids": init_ids,
            "init_scores": init_scores}
