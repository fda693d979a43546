"""Transformer encoder/decoder (NMT config #3 of BASELINE.md).

Mirrors the reference's Transformer benchmark model family
(``benchmark/fluid/models/machine_translation.py`` era + the
dist_transformer test model): pre/post-process residual+layernorm+dropout
wrappers, multi-head scaled-dot-product attention, position-wise FFN,
sinusoid position encoding.

TPU notes: attention masks are additive biases fused by XLA; all big
matmuls keep [B*T, D] x [D, D] shapes for the MXU; set
``ParamAttr(sharding=...)`` on the fc weights for tensor parallelism and
swap full attention for ``layers.ring_attention`` for sequence parallelism.
"""

import numpy as np

import paddle_tpu_torch as fluid


def position_encoding_init(n_position, d_model):
    """Sinusoid position encoding table."""
    channels = np.arange(d_model) // 2 * 2
    rates = np.power(10000.0, -channels / d_model)
    pos = np.arange(n_position)[:, None] * rates[None, :]
    enc = np.zeros((n_position, d_model), np.float32)
    enc[:, 0::2] = np.sin(pos[:, 0::2])
    enc[:, 1::2] = np.cos(pos[:, 1::2])
    return enc.astype(np.float32)


def multi_head_attention(queries, keys, values, attn_bias, d_key, d_value,
                         d_model, n_head=1, dropout_rate=0.0,
                         cache=None, param_sharding=None):
    """q/k/v: [B, T, D]; attn_bias: [B, n_head, Tq, Tk] additive or None."""
    keys = queries if keys is None else keys
    values = keys if values is None else values

    def _fc(x, size, sharding=None):
        return fluid.layers.fc(
            input=x, size=size, bias_attr=False, num_flatten_dims=2,
            param_attr=fluid.ParamAttr(sharding=sharding))

    q = _fc(queries, d_key * n_head, param_sharding)
    k = _fc(keys, d_key * n_head, param_sharding)
    v = _fc(values, d_value * n_head, param_sharding)

    def split_heads(x, d):
        reshaped = fluid.layers.reshape(
            x, [0, -1 if x.shape[1] in (None, -1) else x.shape[1],
                n_head, d])
        return fluid.layers.transpose(reshaped, perm=[0, 2, 1, 3])

    q = split_heads(q, d_key)                     # [B, H, Tq, dk]
    k = split_heads(k, d_key)
    v = split_heads(v, d_value)

    # fused scaled-dot-product core: flash/composed measured-win tier
    # (with dropout the composed form is used so the weight mask matches
    # the reference's dropout-on-softmax semantics)
    ctx = fluid.layers.fused_attention(
        q, k, v, bias=attn_bias, dropout_rate=dropout_rate,
        scale=d_key ** -0.5)                      # [B, H, Tq, dv]
    ctx = fluid.layers.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = fluid.layers.reshape(ctx, [0, -1 if ctx.shape[1] in (None, -1)
                                     else ctx.shape[1], d_value * n_head])
    return _fc(ctx, d_model,
               tuple(reversed(param_sharding)) if param_sharding else None)


def positionwise_feed_forward(x, d_inner_hid, d_hid, dropout_rate=0.0,
                              param_sharding=None):
    hidden = fluid.layers.fc(
        input=x, size=d_inner_hid, num_flatten_dims=2, act="relu",
        param_attr=fluid.ParamAttr(sharding=param_sharding))
    if dropout_rate:
        hidden = fluid.layers.dropout(
            hidden, dropout_prob=dropout_rate,
            dropout_implementation="upscale_in_train")
    return fluid.layers.fc(
        input=hidden, size=d_hid, num_flatten_dims=2,
        param_attr=fluid.ParamAttr(
            sharding=tuple(reversed(param_sharding))
            if param_sharding else None))


def pre_post_process_layer(prev_out, out, process_cmd, dropout_rate=0.0):
    """'a': residual add; 'n': layer_norm; 'd': dropout."""
    for cmd in process_cmd:
        if cmd == "a":
            out = fluid.layers.elementwise_add(out, prev_out) \
                if prev_out is not None else out
        elif cmd == "n":
            out = fluid.layers.layer_norm(
                out, begin_norm_axis=len(out.shape) - 1)
        elif cmd == "d" and dropout_rate:
            out = fluid.layers.dropout(
                out, dropout_prob=dropout_rate,
                dropout_implementation="upscale_in_train")
    return out


def encoder_layer(enc_input, attn_bias, n_head, d_key, d_value, d_model,
                  d_inner_hid, dropout_rate=0.0):
    attn_out = multi_head_attention(
        pre_post_process_layer(None, enc_input, "n"), None, None,
        attn_bias, d_key, d_value, d_model, n_head, dropout_rate)
    attn_out = pre_post_process_layer(enc_input, attn_out, "da",
                                      dropout_rate)
    ffd_out = positionwise_feed_forward(
        pre_post_process_layer(None, attn_out, "n"), d_inner_hid, d_model,
        dropout_rate)
    return pre_post_process_layer(attn_out, ffd_out, "da", dropout_rate)


def encoder(enc_input, attn_bias, n_layer, n_head, d_key, d_value, d_model,
            d_inner_hid, dropout_rate=0.0):
    for _ in range(n_layer):
        enc_input = encoder_layer(enc_input, attn_bias, n_head, d_key,
                                  d_value, d_model, d_inner_hid,
                                  dropout_rate)
    return pre_post_process_layer(None, enc_input, "n")


def decoder_layer(dec_input, enc_output, self_attn_bias, cross_attn_bias,
                  n_head, d_key, d_value, d_model, d_inner_hid,
                  dropout_rate=0.0):
    self_attn = multi_head_attention(
        pre_post_process_layer(None, dec_input, "n"), None, None,
        self_attn_bias, d_key, d_value, d_model, n_head, dropout_rate)
    self_attn = pre_post_process_layer(dec_input, self_attn, "da",
                                       dropout_rate)
    cross_attn = multi_head_attention(
        pre_post_process_layer(None, self_attn, "n"), enc_output,
        enc_output, cross_attn_bias, d_key, d_value, d_model, n_head,
        dropout_rate)
    cross_attn = pre_post_process_layer(self_attn, cross_attn, "da",
                                        dropout_rate)
    ffd = positionwise_feed_forward(
        pre_post_process_layer(None, cross_attn, "n"), d_inner_hid,
        d_model, dropout_rate)
    return pre_post_process_layer(cross_attn, ffd, "da", dropout_rate)


def decoder(dec_input, enc_output, self_attn_bias, cross_attn_bias,
            n_layer, n_head, d_key, d_value, d_model, d_inner_hid,
            dropout_rate=0.0):
    for _ in range(n_layer):
        dec_input = decoder_layer(dec_input, enc_output, self_attn_bias,
                                  cross_attn_bias, n_head, d_key, d_value,
                                  d_model, d_inner_hid, dropout_rate)
    return pre_post_process_layer(None, dec_input, "n")


def _embed(ids, pos_ids, vocab_size, max_len, d_model, emb_name):
    word = fluid.layers.embedding(
        input=ids, size=[vocab_size, d_model],
        param_attr=fluid.ParamAttr(name=emb_name))
    word = fluid.layers.scale(word, scale=d_model ** 0.5)
    pos = fluid.layers.embedding(
        input=pos_ids, size=[max_len, d_model],
        param_attr=fluid.ParamAttr(
            name=emb_name + "_pos",
            initializer=fluid.initializer.NumpyArrayInitializer(
                position_encoding_init(max_len, d_model)),
            trainable=False))
    return fluid.layers.elementwise_add(word, pos)


def transformer(src_vocab_size, trg_vocab_size, max_length, n_layer, n_head,
                d_key, d_value, d_model, d_inner_hid, dropout_rate=0.0,
                label_smooth_eps=0.0):
    """Full train graph; returns (avg_cost, predictions, feed names).

    Feeds (dense padded + masks, the TPU lowering of the reference's lod
    pipeline): src_word/src_pos [B,T], trg_word/trg_pos [B,T],
    src_slf_attn_bias [B,H,T,T], trg_slf_attn_bias (causal+pad),
    trg_src_attn_bias, lbl_word [B,T,1], lbl_weight [B,T,1].
    """
    src_word = fluid.layers.data(name="src_word", shape=[-1, -1],
                                 dtype="int64", append_batch_size=False)
    src_pos = fluid.layers.data(name="src_pos", shape=[-1, -1],
                                dtype="int64", append_batch_size=False)
    trg_word = fluid.layers.data(name="trg_word", shape=[-1, -1],
                                 dtype="int64", append_batch_size=False)
    trg_pos = fluid.layers.data(name="trg_pos", shape=[-1, -1],
                                dtype="int64", append_batch_size=False)
    src_slf_attn_bias = fluid.layers.data(
        name="src_slf_attn_bias", shape=[-1, n_head, -1, -1],
        dtype="float32", append_batch_size=False)
    trg_slf_attn_bias = fluid.layers.data(
        name="trg_slf_attn_bias", shape=[-1, n_head, -1, -1],
        dtype="float32", append_batch_size=False)
    trg_src_attn_bias = fluid.layers.data(
        name="trg_src_attn_bias", shape=[-1, n_head, -1, -1],
        dtype="float32", append_batch_size=False)
    lbl_word = fluid.layers.data(name="lbl_word", shape=[-1, -1, 1],
                                 dtype="int64", append_batch_size=False)
    lbl_weight = fluid.layers.data(name="lbl_weight", shape=[-1, -1, 1],
                                   dtype="float32", append_batch_size=False)

    enc_emb = _embed(src_word, src_pos, src_vocab_size, max_length, d_model,
                     "src_emb")
    enc_out = encoder(enc_emb, src_slf_attn_bias, n_layer, n_head, d_key,
                      d_value, d_model, d_inner_hid, dropout_rate)
    dec_emb = _embed(trg_word, trg_pos, trg_vocab_size, max_length, d_model,
                     "trg_emb")
    dec_out = decoder(dec_emb, enc_out, trg_slf_attn_bias,
                      trg_src_attn_bias, n_layer, n_head, d_key, d_value,
                      d_model, d_inner_hid, dropout_rate)
    logits = fluid.layers.fc(input=dec_out, size=trg_vocab_size,
                             num_flatten_dims=2, bias_attr=False)

    if label_smooth_eps:
        label = fluid.layers.label_smooth(
            fluid.layers.one_hot(lbl_word, depth=trg_vocab_size),
            epsilon=label_smooth_eps)
        cost = fluid.layers.softmax_with_cross_entropy(
            logits=logits, label=label, soft_label=True)
    else:
        cost = fluid.layers.softmax_with_cross_entropy(
            logits=logits, label=lbl_word)
    weighted = fluid.layers.elementwise_mul(cost, lbl_weight)
    sum_cost = fluid.layers.reduce_sum(weighted)
    token_num = fluid.layers.reduce_sum(lbl_weight)
    avg_cost = fluid.layers.elementwise_div(sum_cost, token_num)
    predict = fluid.layers.softmax(logits)
    feeds = ["src_word", "src_pos", "trg_word", "trg_pos",
             "src_slf_attn_bias", "trg_slf_attn_bias", "trg_src_attn_bias",
             "lbl_word", "lbl_weight"]
    return avg_cost, predict, feeds


def make_attn_biases(src_lens, trg_lens, n_head, t_src, t_trg, neg=-1e9):
    """Host-side helper building the three additive bias tensors."""
    b = len(src_lens)
    src_mask = (np.arange(t_src)[None, :] >=
                np.asarray(src_lens)[:, None]).astype(np.float32) * neg
    src_bias = np.broadcast_to(src_mask[:, None, None, :],
                               (b, n_head, t_src, t_src)).copy()
    trg_pad = (np.arange(t_trg)[None, :] >=
               np.asarray(trg_lens)[:, None]).astype(np.float32) * neg
    causal = np.triu(np.full((t_trg, t_trg), neg, np.float32), k=1)
    trg_bias = trg_pad[:, None, None, :] + causal[None, None, :, :]
    trg_bias = np.broadcast_to(trg_bias, (b, n_head, t_trg, t_trg)).copy()
    cross = np.broadcast_to(src_mask[:, None, None, :],
                            (b, n_head, t_trg, t_src)).copy()
    return src_bias.astype(np.float32), trg_bias.astype(np.float32), \
        cross.astype(np.float32)


# ---------------------------------------------------------------------------
# The prefill leg of disaggregated decode: the decoder's self-attention K/V
# of a prompt, as the per-token planes a paged pool stores
# ---------------------------------------------------------------------------

def self_attention_taps(program):
    """``[(q, k, v, out)]`` variable names of each decoder layer's
    self-attention ``fused_attention`` op (the ones whose bias is the
    ``trg_slf_attn_bias`` feed), in layer order: Q, K and V as
    ``[B, H, T, D]``, the attention output the same."""
    taps = []
    for op in program.global_block().ops:
        if op.type == "fused_attention" and \
                "trg_slf_attn_bias" in op.inputs.get("Bias", ()):
            taps.append(tuple(op.inputs[s][0] for s in ("Q", "K", "V")) +
                        (op.outputs["Out"][0],))
    return taps


def prefill_feed(tokens, src, n_head):
    """The decode program's feed for one sentence: source `src` [Ts] and
    target prefix `tokens` [T], positions and the three attention biases
    (causal over the prefix)."""
    tokens = np.asarray(tokens, np.int64).reshape(1, -1)
    src = np.asarray(src, np.int64).reshape(1, -1)
    ts, t = src.shape[1], tokens.shape[1]
    sb, tb, cb = make_attn_biases([ts], [t], n_head, ts, t)
    return {"src_word": src,
            "src_pos": np.arange(ts, dtype=np.int64)[None],
            "trg_word": tokens,
            "trg_pos": np.arange(t, dtype=np.int64)[None],
            "src_slf_attn_bias": sb, "trg_slf_attn_bias": tb,
            "trg_src_attn_bias": cb}


def attention_taps(executor, program, tokens, src, n_head, scope=None):
    """Run the decode `program` (the forward cloned for test and pruned
    to its prediction) over one sentence and return, per decoder layer,
    ``{"q", "k", "v", "out"}`` of its self-attention as token-major
    ``[T, H, D]`` float32 arrays.  The decoder is causal, so position t's
    K and V depend on tokens 0..t only: they are what a decode step over
    any longer prefix computes there."""
    taps = self_attention_taps(program)
    names = [n for tap in taps for n in tap]
    got = executor.run(program, feed=prefill_feed(tokens, src, n_head),
                       fetch_list=names, scope=scope)
    planes = [np.ascontiguousarray(np.asarray(a, np.float32)[0]
                                   .transpose(1, 0, 2)) for a in got]
    return [dict(zip(("q", "k", "v", "out"), planes[4 * i:4 * i + 4]))
            for i in range(len(taps))]


def layer_value_spec(kv_config, n_layer, n_head, head_dim):
    """A pool ``value_spec`` carrying every decoder layer's K/V arena:
    ``kv_config.kv_value_spec(n_head, head_dim)``'s planes (``k``, ``v``
    and, in int8 mode, ``k_scale``, ``v_scale``) once per layer, named
    ``l{layer}_{plane}``."""
    spec = kv_config.kv_value_spec(n_head, head_dim)
    return {f"l{i}_{name}": s for i in range(n_layer)
            for name, s in spec.items()}


def make_prefill_fn(executor, program, src, n_head, kv_dtype=None,
                    scope=None):
    """``prefill_fn(tokens) -> {plane: [n, *tail]}`` for a
    ``PrefillEngine``: the decoder self-attention K and V of the prompt
    `tokens` against source sentence `src`, per layer, under
    :func:`layer_value_spec`'s names; with ``kv_dtype="int8"`` each row
    quantized by ``quantize_kv`` (int8 values, one fp32 scale a token)."""
    from ..ops.quant_kernels import quantize_kv

    def prefill_fn(tokens):
        out = {}
        for i, tap in enumerate(attention_taps(executor, program, tokens,
                                               src, n_head, scope)):
            for name in ("k", "v"):
                if kv_dtype == "int8":
                    out[f"l{i}_{name}"], out[f"l{i}_{name}_scale"] = \
                        quantize_kv(tap[name])
                else:
                    out[f"l{i}_{name}"] = tap[name]
        return out

    return prefill_fn
