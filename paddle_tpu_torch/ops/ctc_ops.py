"""CTC ops (port of ``paddle_tpu/ops/ctc_ops.py``): ``warpctc``, the loss,
and ``ctc_align``, the greedy decode's post-processing.

Reference: ``paddle/fluid/operators/warpctc_op.cc`` (which binds Baidu's
warp-ctc) and ``ctc_align_op.cc``.

The CTC forward algorithm runs in log space over the padded dense batch:
alphas [B, 2L+1] carried across a Python loop over the static T, with each
row masked by its length on the device.  The gradient is autograd's over
that loop, as the JAX package takes the scan's vjp: no hand-written beta
pass.  Dead paths hold the JAX package's large finite ``_NEG``, not -inf,
so the gradient through an empty path stays finite.  ``ctc_align`` (merge
repeats, drop blanks) compacts each row to the left without changing T.
"""

import torch

from .registry import register, first
from .sequence_kernels import length_mask

_NEG = -1e30


def _logsumexp2(a, b):
    # finite under autograd: the sum is clamped away from 0, so log's grad
    # never sees -inf in the branch `where` discards
    m = torch.maximum(a, b)
    dead = m <= _NEG / 2
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe)
    out = m_safe + torch.log(s.clamp_min(1e-30))
    return torch.where(dead, torch.full_like(out, _NEG), out)


@register("warpctc")
def warpctc(ins, attrs):
    """Logits [B, T, C] (+LogitsLen), Label [B, L] (+LabelLen) -> Loss
    [B, 1], the negative log-likelihood (blank = attr blank)."""
    logits = first(ins, "Logits")
    labels = first(ins, "Label")
    logit_lens = first(ins, "LogitsLen")
    label_lens = first(ins, "LabelLen")
    blank = int(attrs.get("blank", 0))
    if labels.dim() == 3:
        labels = labels[..., 0]
    labels = labels.long()
    b, t, _ = logits.shape
    dev = logits.device
    log_probs = torch.log_softmax(logits.float(), dim=-1)

    # the extended label sequence: blank, l1, blank, l2, ..., blank [2L+1]
    s = 2 * labels.shape[1] + 1
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    # a symbol equal to the one two back cannot be reached by the skip
    same_as_prev2 = torch.cat(
        [torch.zeros((b, 2), dtype=torch.bool, device=dev),
         ext[:, 2:] == ext[:, :-2]], dim=1)[:, :s]
    ext_lens = 2 * label_lens.long() + 1                            # [B]
    pos = torch.arange(s, device=dev)[None, :]
    valid_s = pos < ext_lens[:, None]
    # blanks cannot take the skip transition either
    no_skip = same_as_prev2 | (pos % 2 == 0)

    def emit(tstep):
        """log prob of each extended symbol at time t: [B, S]."""
        return log_probs[:, tstep].gather(1, ext)

    def neg(n):
        return torch.full((b, max(n, 0)), _NEG, device=dev)

    e0 = emit(0)
    alpha = torch.cat([e0[:, :1], torch.where(ext_lens[:, None] > 1,
                                              e0[:, 1:2], neg(1)),
                       neg(s - 2)], dim=1)[:, :s]
    tmask = length_mask(logit_lens, t, torch.bool)                  # [B, T]
    for tstep in range(1, t):
        a_shift1 = torch.cat([neg(1), alpha[:, :-1]], dim=1)
        a_shift2 = torch.cat([neg(2), alpha[:, :-2]], dim=1)[:, :s]
        a_shift2 = torch.where(no_skip, neg(s), a_shift2)
        new = _logsumexp2(_logsumexp2(alpha, a_shift1), a_shift2) \
            + emit(tstep)
        new = torch.where(valid_s, new, neg(s))
        alpha = torch.where(tmask[:, tstep][:, None], new, alpha)

    last = alpha.gather(1, (ext_lens - 1)[:, None])
    last2 = alpha.gather(1, (ext_lens - 2).clamp_min(0)[:, None])
    loss = -_logsumexp2(last, torch.where((ext_lens > 1)[:, None], last2,
                                          neg(1)))
    if attrs.get("norm_by_times", False):
        # the reference (warpctc_op.h:229) applies norm_by_times to the
        # logits' gradient only; the reported Loss stays the raw NLL
        scaled = loss / logit_lens.clamp_min(1)[:, None].to(loss.dtype)
        loss = scaled + (loss - scaled).detach()
    return {"Loss": [loss]}


@register("ctc_align", not_differentiable=True)
def ctc_align(ins, attrs):
    """Greedy CTC decode post-processing (ctc_align_op.cc): merge repeated
    tokens, drop blanks; each row compacted to the left, T unchanged, with
    its new length."""
    x = first(ins, "Input")                # [B, T] int predictions
    lens = first(ins, "SeqLen")
    blank = int(attrs.get("blank", 0))
    squeeze = x.dim() == 3
    v = x[..., 0] if squeeze else x
    b, t = v.shape
    valid = length_mask(lens, t, torch.bool)
    prev = torch.cat([torch.full((b, 1), -1, dtype=v.dtype,
                                 device=v.device), v[:, :-1]], dim=1)
    keep = valid & (v != blank)
    if attrs.get("merge_repeated", True):
        keep = keep & (v != prev)
    new_pos = torch.cumsum(keep.long(), dim=1) - 1
    # every dropped token writes 0 to slot t-1, which lies past the
    # compacted length unless nothing was dropped: only zeros collide, and
    # the max over them is exact in any order
    scatter_pos = torch.where(keep, new_pos, torch.full_like(new_pos, t - 1))
    out = torch.zeros_like(v).scatter_reduce(
        1, scatter_pos, torch.where(keep, v, torch.zeros_like(v)), "amax")
    new_lens = keep.sum(dim=1).to(torch.int32)
    out = out * length_mask(new_lens, t, v.dtype)
    if squeeze:
        out = out[..., None]
    return {"Output": [out], "OutLen": [new_lens]}
