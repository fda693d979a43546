"""Autoregressive decoding: greedy + beam search for seq2seq models (a
copy of ``paddle_tpu/models/decoding.py``).

Reference surface: ``beam_search_op.cc`` / ``beam_search_decode_op.cc``
drive a per-step LoD beam inside a fluid while-loop.  Here, as in the JAX
package, the decoder program runs over the padded [B*K, max_len] prefix
(static shapes, causal+pad masks), so on the card every step is one feed
signature and replays one captured graph, and the beam bookkeeping —
top-k over K*V candidates, beam reordering, EOS freezing, length penalty
— runs in numpy on the host between steps, bit for bit the JAX package's.
"""

import numpy as np


def _log_softmax(x):
    m = x.max(-1, keepdims=True)
    e = np.exp(x - m)
    return (x - m) - np.log(e.sum(-1, keepdims=True))


def greedy_search(logits_fn, batch_size, bos_id, eos_id, max_len):
    """logits_fn(prefix [N, max_len] int64, cur_len) -> [N, V] next-token
    logits.  Returns [B, max_len] token ids (eos-padded)."""
    seqs = np.full((batch_size, max_len), eos_id, np.int64)
    seqs[:, 0] = bos_id
    alive = np.ones(batch_size, bool)
    for t in range(1, max_len):
        logits = np.asarray(logits_fn(seqs, t))
        nxt = logits.argmax(-1)
        seqs[alive, t] = nxt[alive]
        alive = alive & (nxt != eos_id)
        if not alive.any():
            break
    return seqs


def beam_search(logits_fn, batch_size, beam_size, bos_id, eos_id, max_len,
                length_penalty=0.6):
    """Standard beam search with GNMT length penalty.

    Returns (seqs [B, K, max_len], scores [B, K]), best beam first.
    """
    B, K = batch_size, beam_size
    seqs = np.full((B, K, max_len), eos_id, np.int64)
    seqs[:, :, 0] = bos_id
    scores = np.full((B, K), -1e9, np.float32)
    scores[:, 0] = 0.0                      # only beam 0 live initially
    finished = np.zeros((B, K), bool)

    for t in range(1, max_len):
        flat = seqs.reshape(B * K, max_len)
        logp = _log_softmax(np.asarray(logits_fn(flat, t),
                                       np.float32)).reshape(B, K, -1)
        V = logp.shape[-1]
        # frozen beams may only extend with EOS at no cost
        cand = scores[:, :, None] + logp
        if finished.any():
            frozen = np.full_like(logp, -1e9)
            frozen[:, :, eos_id] = 0.0
            cand = np.where(finished[:, :, None],
                            scores[:, :, None] + frozen, cand)
        flat_cand = cand.reshape(B, K * V)
        top = np.argsort(-flat_cand, axis=1)[:, :K]
        new_scores = np.take_along_axis(flat_cand, top, axis=1)
        beam_idx = top // V
        tok = top % V
        seqs = np.take_along_axis(
            seqs, beam_idx[:, :, None].astype(np.int64), axis=1).copy()
        seqs[:, :, t] = tok
        finished = np.take_along_axis(finished, beam_idx, axis=1) | \
            (tok == eos_id)
        scores = new_scores.astype(np.float32)
        if finished.all():
            break

    # GNMT length penalty over generated lengths
    lens = (seqs != eos_id).sum(-1).clip(1)
    lp = ((5.0 + lens) / 6.0) ** length_penalty
    final = scores / lp
    order = np.argsort(-final, axis=1)
    seqs = np.take_along_axis(seqs, order[:, :, None].astype(np.int64),
                              axis=1)
    final = np.take_along_axis(final, order, axis=1)
    return seqs, final
