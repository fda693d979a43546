"""Linear-chain CRF kernels (port of ``paddle_tpu/ops/crf_ops.py``).

Reference: ``paddle/fluid/operators/linear_chain_crf_op.h`` (the forward
algorithm over a packed LoD batch, with a hand-written forward-backward
grad) and ``crf_decoding_op.h`` (Viterbi).  The transition layout is the
reference's: row 0 the start weights, row 1 the stop weights, rows 2.. the
tag-to-tag transitions.  ``LogLikelihood`` is the NEGATIVE conditional
log-likelihood (a cost), as ``linear_chain_crf_op.h:192``.

The batch is dense [B, T, K] with int32 lengths [B].  Both recursions are
Python loops over the static T of tensor ops on the batch's device: each
step masks the sequences that have ended by their length, so no step
reads a length back to the host.  The CRF's grad is the generic grad's
autograd over the forward, as the JAX package takes the scan's vjp.
"""

import torch

from .registry import register, first
from .sequence_kernels import length_mask


def _split_transition(w):
    return w[0], w[1], w[2:]       # start [K], stop [K], trans [K, K]


def _label2d(label):
    label = label[..., 0] if label.dim() == 3 else label
    return label.long()


@register("linear_chain_crf")
def linear_chain_crf(ins, attrs):
    em = first(ins, "Emission")            # [B, T, K]
    w = first(ins, "Transition")           # [K+2, K]
    label = _label2d(first(ins, "Label"))  # [B, T]
    lens = first(ins, "SeqLen")
    b, t, _ = em.shape
    start, stop, trans = _split_transition(w)

    # log Z: the forward recursion in log space; a row that has ended
    # keeps its alpha
    alpha = em[:, 0] + start[None]
    for tt in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + em[:, tt]
        alpha = torch.where((tt < lens)[:, None], nxt, alpha)
    log_z = torch.logsumexp(alpha + stop[None], dim=1)               # [B]

    # the gold path's score
    valid = length_mask(lens, t, em.dtype)                          # [B, T]
    em_score = (em.gather(2, label[..., None])[..., 0] * valid).sum(dim=1)
    if t > 1:
        pair = trans[label[:, :-1], label[:, 1:]]                   # [B,T-1]
        trans_score = (pair * valid[:, 1:]).sum(dim=1)
    else:
        trans_score = torch.zeros((b,), dtype=em.dtype, device=em.device)
    last_lbl = label.gather(
        1, (lens.long() - 1).clamp_min(0)[:, None])[:, 0]
    score = em_score + trans_score + start[label[:, 0]] + stop[last_lbl]
    return {"LogLikelihood": [(log_z - score)[:, None]]}


def _first_max(scores, dim):
    """(max, index of its first occurrence) along `dim`, as jnp.max and
    jnp.argmax give them: torch.argmax returns the first maximum on the
    CPU and on CUDA."""
    arg = scores.argmax(dim=dim)
    return scores.gather(dim, arg.unsqueeze(dim)).squeeze(dim), arg


@register("crf_decoding", not_differentiable=True)
def crf_decoding(ins, attrs):
    em = first(ins, "Emission")            # [B, T, K]
    w = first(ins, "Transition")
    lens = first(ins, "SeqLen")
    label = first(ins, "Label")            # optional
    _, t, k = em.shape
    start, stop, trans = _split_transition(w)

    delta = em[:, 0] + start[None]
    identity = torch.arange(k, device=em.device)[None]
    bps = []
    for tt in range(1, t):
        best, arg = _first_max(delta[:, :, None] + trans[None], 1)  # [B, K]
        active = (tt < lens)[:, None]
        # identity backpointers on finished sequences keep the final tag
        # fixed through the backtrack
        delta = torch.where(active, best + em[:, tt], delta)
        bps.append(torch.where(active, arg, identity))
    cur = _first_max(delta + stop[None], 1)[1]                      # [B]
    path = [cur]
    for bp in reversed(bps):
        cur = bp.gather(1, cur[:, None])[:, 0]
        path.append(cur)
    path = torch.stack(path[::-1], dim=1)                           # [B, T]

    valid = length_mask(lens, t, torch.bool)
    path = torch.where(valid, path, torch.zeros_like(path))
    if label is not None:
        # training-time co-op with chunk_eval (crf_decoding_op.cc:46): 1
        # where the Viterbi tag equals the gold tag, else 0
        path = (valid & (path == _label2d(label))).long()
    return {"ViterbiPath": [path[..., None]], "OutLen": [lens]}
