"""Tensor-array, beam-search and rank-table kernels (port of
``paddle_tpu/ops/array_ops.py``).

Reference: the ``lod_tensor_array`` ops (``controlflow/while_op.cc``
family: write_to_array / read_from_array / lod_array_length over a host
``std::vector<LoDTensor>``), ``beam_search_op.cc`` and
``beam_search_decode_op.cc`` (ragged LoD beams pruned per step on the
host), and the rank-table family (``lod_rank_table_op.cc``,
``max_sequence_len_op.cc``, ``lod_tensor_to_array_op.cc``,
``array_to_lod_tensor_op.cc``, ``reorder_lod_tensor_by_rank_op.cc``).

The JAX package's design, kept here:

- a tensor array is a dense preallocated ``(buffer [C, ...], count)``
  pair, C the writer op's ``capacity`` attr (``layers.create_array(...,
  capacity=N)``).  It starts as a zero-capacity sentinel whose element
  shape the first write supplies; the write allocates ``[C] + x.shape``.
  The index stays on the device: a write is an ``index_copy`` and a read
  an ``index_select`` at the index tensor, clamped into ``[0, C)`` as
  ``lax.dynamic_update_index_in_dim`` clamps, and the count is
  ``max(count, i + 1)`` on the device, so a loop body that writes and
  reads arrays never waits for the card.  A write returns a new buffer
  (kernels never update in place).
- beams have a static width K: a finished beam (its last id ``end_id``)
  survives as one candidate with its frozen score and ``end_id``, and the
  parents are explicit global row indices (``b * K + beam``).  The top K
  of a sentence's K * K2 candidates are taken by a stable descending sort,
  so equal scores keep the lower candidate index first, as ``lax.top_k``
  does; ``torch.topk`` promises no order among equal values.

Integer outputs are int64 where the JAX package, which runs 64-bit types
as 32-bit, gives int32; the values are the same.
"""

import torch

from .registry import register, first, as_out, current, torch_dtype


def _index(i):
    """An index operand ([1] or scalar) as a one-element int64 tensor."""
    return i.reshape(-1)[:1].long()


@register("tensor_array_create", not_differentiable=True)
def tensor_array_create(ins, attrs):
    # element shape is unknown until the first write: a zero-capacity
    # sentinel the first write_to_array replaces with the real buffer
    dev = current().device
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [(torch.zeros((0,), dtype=dtype, device=dev),
                     torch.zeros((), dtype=torch.int64, device=dev))]}


@register("write_to_array", not_differentiable=True)
def write_to_array(ins, attrs):
    x = first(ins, "X")
    i = _index(first(ins, "I"))
    buf, count = first(ins, "Array")
    if buf.numel() == 0:
        cap = int(attrs.get("capacity", 64))
        buf = torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
    at = i.clamp(0, buf.shape[0] - 1)
    new_buf = buf.index_copy(0, at, x.to(buf.dtype).unsqueeze(0))
    return {"Out": [(new_buf, torch.maximum(count, i[0] + 1))]}


@register("read_from_array", not_differentiable=True)
def read_from_array(ins, attrs):
    buf, _count = first(ins, "X")
    at = _index(first(ins, "I")).clamp(0, buf.shape[0] - 1)
    return as_out(buf.index_select(0, at)[0])


@register("lod_array_length", not_differentiable=True)
def lod_array_length(ins, attrs):
    _buf, count = first(ins, "X")
    return as_out(count.reshape(1).to(torch.int32))


@register("beam_search", not_differentiable=True)
def beam_search(ins, attrs):
    """Static-width beam step.  pre_ids/pre_scores [B*K, 1]; ids/scores
    [B*K, K2] candidate continuations (accumulated log-probs).  Finished
    beams (pre_id == end_id) survive as a single frozen candidate.
    Outputs selected ids/scores [B*K, 1] and the parent's global row
    [B*K] (the lod-encoded parent chain of beam_search_op.cc:211, made
    explicit)."""
    pre_ids = first(ins, "pre_ids")
    pre_scores = first(ins, "pre_scores")
    cand_ids = first(ins, "ids")
    cand_scores = first(ins, "scores")
    k = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    if not attrs.get("is_accumulated", True):
        # reference semantics: raw per-step log-probs, the op accumulates
        cand_scores = cand_scores + pre_scores

    bk, k2 = cand_scores.shape
    b = bk // k
    finished = pre_ids.reshape(b, k) == end_id                      # [B, K]
    scores_r = cand_scores.reshape(b, k, k2)
    ids_r = cand_ids.reshape(b, k, k2).long()
    # finished beams: only slot 0 alive, carrying the frozen score
    scores_r = torch.where(finished[:, :, None],
                           torch.full_like(scores_r, -1e9), scores_r)
    slot0 = torch.where(finished, pre_scores.reshape(b, k).to(
        scores_r.dtype), scores_r[:, :, 0])
    scores_r = torch.cat([slot0[:, :, None], scores_r[:, :, 1:]], dim=2)
    ids_r = torch.where(finished[:, :, None], torch.full_like(ids_r, end_id),
                        ids_r)

    flat_scores = scores_r.reshape(b, k * k2)
    top_scores, top_idx = torch.sort(flat_scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]         # [B, K]
    # global flat parent (b*K + local beam) so the caller can gather
    # decoder state rows directly; local beam = parent_idx % K
    parent = top_idx // k2 + (torch.arange(b, device=top_idx.device)
                              * k)[:, None]
    sel_ids = ids_r.reshape(b, k * k2).gather(1, top_idx)
    return {"selected_ids": [sel_ids.reshape(bk, 1)],
            "selected_scores": [top_scores.reshape(bk, 1)],
            "parent_idx": [parent.reshape(bk)]}


@register("beam_search_decode", not_differentiable=True)
def beam_search_decode(ins, attrs):
    """Backtrack the parent chains of a finished static beam search.
    Ids/Scores/Parents are tensor arrays written once per step; emits
    SentenceIds [B, K, C] (end_id-padded) and SentenceScores [B, K]."""
    ids_buf, count = first(ins, "Ids")          # [C, B*K, 1]
    scores_buf, _ = first(ins, "Scores")        # [C, B*K, 1]
    par_buf, _ = first(ins, "Parents")          # [C, B*K]
    k = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])

    c, bk = ids_buf.shape[0], ids_buf.shape[1]
    b = bk // k
    ids_r = ids_buf.reshape(c, b, k).long()
    par_r = par_buf.reshape(c, b, k).long() % k   # global flat -> local beam
    # cur: [B, K] local beam index at step t + 1 (or the final ranks)
    cur = torch.arange(k, device=ids_buf.device).expand(b, k)
    toks = [None] * c
    for t in range(c - 1, -1, -1):
        valid = count > t
        tok = ids_r[t].gather(1, cur)
        prev = par_r[t].gather(1, cur)
        toks[t] = torch.where(valid, tok, torch.full_like(tok, end_id))
        cur = torch.where(valid, prev, cur)
    sentence_ids = torch.stack(toks, dim=2)                         # [B, K, C]
    last = (count - 1).clamp_min(0).reshape(1)
    sentence_scores = scores_buf.index_select(0, last).reshape(b, k)
    return {"SentenceIds": [sentence_ids],
            "SentenceScores": [sentence_scores]}


# ---------------------------------------------------------------------------
# The LoDRankTable family.  The reference sorts sequences by length and
# runs shrinking per-timestep batches; the dense + lengths lowering keeps
# the full batch and masks, so the table is informational ([index, length]
# sorted by length, longest first) and to/from-array is a time-major
# transpose.
# ---------------------------------------------------------------------------

@register("lod_rank_table", not_differentiable=True)
def lod_rank_table(ins, attrs):
    lens = first(ins, "SeqLen")
    order = torch.argsort(-lens.long(), stable=True)
    return as_out(torch.stack([order.to(torch.int32),
                               lens[order].to(torch.int32)], dim=1))


@register("max_sequence_len", not_differentiable=True)
def max_sequence_len(ins, attrs):
    table = first(ins, "RankTable")
    return as_out(table[:, 1].max().reshape(1).to(torch.int32))


@register("lod_tensor_to_array", not_differentiable=True)
def lod_tensor_to_array(ins, attrs):
    """[B, T, ...] -> a tensor array of T entries, entry t = time step t
    of every sequence (the full batch; consumers mask by length)."""
    buf = first(ins, "X").transpose(0, 1)             # [T, B, ...]
    count = torch.full((), buf.shape[0], dtype=torch.int64,
                       device=buf.device)
    return {"Out": [(buf, count)]}


@register("array_to_lod_tensor", not_differentiable=True)
def array_to_lod_tensor(ins, attrs):
    buf, _count = first(ins, "X")
    lens = first(ins, "SeqLen")
    table = first(ins, "RankTable")
    out = buf.transpose(0, 1)                         # [B, T, ...]
    if lens is None and table is not None:
        # scatter the table's (index, length) rows back to batch order
        lens = torch.zeros((out.shape[0],), dtype=torch.int32,
                           device=out.device).scatter(
            0, table[:, 0].long(), table[:, 1].to(torch.int32))
    if lens is None:
        lens = torch.full((out.shape[0],), out.shape[1], dtype=torch.int32,
                          device=out.device)
    return {"Out": [out], "OutLen": [lens]}


@register("reorder_lod_tensor_by_rank")
def reorder_lod_tensor_by_rank(ins, attrs):
    x = first(ins, "X")
    table = first(ins, "RankTable")
    return {"Out": [x.index_select(0, table[:, 0].long())],
            "OutLen": [table[:, 1]]}    # lengths follow the permutation
