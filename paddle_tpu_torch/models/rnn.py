"""Model builders of the RNN slice, written against a ``fluid`` module
given as an argument, so the port and the JAX package build the same
program from one definition:

- :func:`seq_to_seq_net`, the seq2seq model of Paddle's book
  (``tests/book/test_rnn_encoder_decoder.py``) with its sizes as
  arguments, and :func:`seq2seq_batch`, a ragged batch for it;
- :func:`gru_net` and :func:`seq_softmax_net`, the layer programs that
  reach the ``gru`` and ``sequence_softmax`` ops.
"""

import numpy as np


def seq_to_seq_net(fluid, dict_size, emb, hidden):
    """The seq2seq model of Paddle's book without attention (tests/book/
    test_rnn_encoder_decoder.py): a bi-LSTM encoder (two dynamic_lstm, no
    peepholes) and a DynamicRNN decoder built from raw gate layers, its
    sizes as arguments.  Returns (avg_cost, prediction)."""
    layers = fluid.layers

    def bi_lstm_encoder(input_seq, hidden_size):
        fwd_proj = layers.fc(input=input_seq, size=hidden_size * 4,
                             bias_attr=True)
        forward, _ = layers.dynamic_lstm(input=fwd_proj,
                                         size=hidden_size * 4,
                                         use_peepholes=False)
        bwd_proj = layers.fc(input=input_seq, size=hidden_size * 4,
                             bias_attr=True)
        backward, _ = layers.dynamic_lstm(input=bwd_proj,
                                          size=hidden_size * 4,
                                          is_reverse=True,
                                          use_peepholes=False)
        return (layers.sequence_last_step(input=forward),
                layers.sequence_first_step(input=backward))

    def lstm_step(x_t, hidden_t_prev, cell_t_prev, size):
        def linear(inputs):
            return layers.fc(input=inputs, size=size, bias_attr=True)

        forget_gate = layers.sigmoid(x=linear([hidden_t_prev, x_t]))
        input_gate = layers.sigmoid(x=linear([hidden_t_prev, x_t]))
        output_gate = layers.sigmoid(x=linear([hidden_t_prev, x_t]))
        cell_tilde = layers.tanh(x=linear([hidden_t_prev, x_t]))
        cell_t = layers.sums(input=[
            layers.elementwise_mul(x=forget_gate, y=cell_t_prev),
            layers.elementwise_mul(x=input_gate, y=cell_tilde)])
        hidden_t = layers.elementwise_mul(x=output_gate,
                                          y=layers.tanh(x=cell_t))
        return hidden_t, cell_t

    def decoder(target_embedding, decoder_boot, context, decoder_size):
        rnn = layers.DynamicRNN()
        cell_init = layers.fill_constant_batch_size_like(
            input=decoder_boot, value=0.0, shape=[-1, decoder_size],
            dtype="float32")
        cell_init.stop_gradient = False
        with rnn.block():
            current_word = rnn.step_input(target_embedding)
            context_in = rnn.static_input(context)
            hidden_mem = rnn.memory(init=decoder_boot, need_reorder=True)
            cell_mem = rnn.memory(init=cell_init)
            decoder_inputs = layers.concat(input=[context_in, current_word],
                                           axis=1)
            h, c = lstm_step(decoder_inputs, hidden_mem, cell_mem,
                             decoder_size)
            rnn.update_memory(hidden_mem, h)
            rnn.update_memory(cell_mem, c)
            out = layers.fc(input=h, size=dict_size, bias_attr=True,
                            act="softmax")
            rnn.output(out)
        return rnn()

    src = layers.data(name="source_sequence", shape=[1], dtype="int64",
                      lod_level=1)
    src_emb = layers.embedding(input=src, size=[dict_size, emb],
                               dtype="float32")
    fwd_last, bwd_first = bi_lstm_encoder(src_emb, hidden)
    encoded = layers.concat(input=[fwd_last, bwd_first], axis=1)
    boot = layers.fc(input=bwd_first, size=hidden, bias_attr=False,
                     act="tanh")
    trg = layers.data(name="target_sequence", shape=[1], dtype="int64",
                      lod_level=1)
    trg_emb = layers.embedding(input=trg, size=[dict_size, emb],
                               dtype="float32")
    prediction = decoder(trg_emb, boot, encoded, hidden)
    label = layers.data(name="label_sequence", shape=[1], dtype="int64",
                        lod_level=1)
    cost = layers.cross_entropy(input=prediction, label=label)
    return layers.mean(x=cost), prediction


def seq2seq_batch(rng, batch, dict_size, lo, hi):
    """A ragged translation batch from a numpy RandomState: target tokens,
    labels (the target token + 3, modulo the dictionary) and the reversed
    target as the source, lengths drawn from [lo, hi]."""
    srcs, trgs, labels = [], [], []
    for _ in range(batch):
        n = int(rng.randint(lo, hi + 1))
        trg_in = rng.randint(2, dict_size, size=(n,)).astype(np.int64)
        labels.append((trg_in + 3) % dict_size)
        trgs.append(trg_in)
        srcs.append(trg_in[::-1].copy())
    return {"source_sequence": srcs, "target_sequence": trgs,
            "label_sequence": labels}


def gru_net(fluid, dict_size, hidden, origin_mode):
    """embedding -> fc(3 hidden) -> dynamic_gru(hidden) -> the mean of its
    squared output over the padded [B, T, hidden] (pads are 0).  The
    square keeps the loss away from 0, where the mean of a signed output
    sits, so a relative comparison of two losses means something."""
    layers = fluid.layers
    words = layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    emb = layers.embedding(input=words, size=[dict_size, hidden])
    proj = layers.fc(input=emb, size=3 * hidden)
    h = layers.dynamic_gru(input=proj, size=hidden, origin_mode=origin_mode)
    return layers.mean(x=layers.elementwise_mul(x=h, y=h))


def seq_softmax_net(fluid, width):
    """An fc(1) over a lod input -> sequence_softmax -> the largest weight
    of each sequence, averaged over the batch."""
    layers = fluid.layers
    x = layers.data(name="x", shape=[width], dtype="float32", lod_level=1)
    att = layers.sequence_softmax(input=layers.fc(input=x, size=1))
    return layers.mean(x=layers.sequence_pool(input=att, pool_type="max"))
