"""Speculative decoding — the draft/verify arm of the decode scheduler.

Leviathan et al. (arXiv:2211.17192, PAPERS.md): a cheap draft model
proposes ``k`` tokens autoregressively, the target model scores all of
them in ONE forward pass (its logits at positions ``base-1 .. base-1+k``
are exactly the next-token distributions given the prompt plus each
draft prefix — causality makes the single call equivalent to k+1
sequential target steps), and the longest prefix of drafts agreeing
with the target is accepted, plus the target's own token at the first
disagreement.  Greedy acceptance is EXACT: the committed tokens are
token-for-token what plain greedy target decode would have produced —
only wall-clock changes (``k+1`` tokens per target call at best, 1 at
worst), never content.  ``ContinuousBatchingEngine`` schedules the arm
at the same token boundaries as plain decode; with no draft model
registered it falls back to the plain path.

Sampled decode uses the paper's FULL acceptance rule
(``accept_drafts_sampled``): accept draft token ``d`` with probability
``min(1, p(d) / q(d))`` where ``p`` is the target's warped distribution
and ``q`` the draft's; on rejection, resample from the normalized
residual ``norm(max(p - q, 0))``; when every draft survives, draw the
bonus token from the target's distribution at the next position.  The
committed tokens are then distributed EXACTLY as plain sampling from
``p`` — distribution-preserving, the property the seeded
statistical-parity test in tests/test_sampling.py checks — and with
temperature 0 (one-hot warps) the rule degenerates to the greedy
equality above.

This module holds the model-free pieces: the config, and the pure
acceptance rules (unit-testable without a scheduler).
"""

import numpy as np

from ...ops.sampling_kernels import (TAG_ACCEPT, TAG_DRAW, TAG_RESIDUAL,
                                     host_draw, host_uniform, host_warp)

__all__ = ["SpeculativeConfig", "accept_drafts", "accept_drafts_sampled"]


class SpeculativeConfig:
    """Draft-model arm for ``ContinuousBatchingEngine``.

    - draft_step_fn: the PLAIN step contract ``(prefix, lengths,
      context) -> [slots, vocab]`` logits, run ``k`` times per round on
      the cheap model (None disables — the engine's typed fallback to
      plain decode)
    - verify_fn: ``(prefix, start_lengths, cur_lengths, context) ->
      [slots, k+1, vocab]`` — ONE target-model call returning logits at
      positions ``start-1 .. start-1+k`` while the prefix already
      carries the drafts (``cur_lengths`` = start + drafts placed; the
      feed/attention masks must admit the draft positions).
      ``make_program_verify_fn`` adapts a fluid inference program.
    - k: draft tokens proposed per round (>= 1)
    """

    def __init__(self, draft_step_fn, verify_fn, k=4):
        if k < 1:
            raise ValueError("speculative k must be >= 1")
        if draft_step_fn is None or verify_fn is None:
            raise ValueError(
                "SpeculativeConfig needs BOTH draft_step_fn and "
                "verify_fn; omit speculative= entirely for plain "
                "decode")
        self.draft_step_fn = draft_step_fn
        self.verify_fn = verify_fn
        self.k = int(k)


def accept_drafts(drafts, verify_logits):
    """The Leviathan greedy acceptance rule for one slot.

    drafts: the ``m`` proposed tokens (ints); verify_logits:
    ``[>= m+1, vocab]`` target logits where row ``j`` scores the token
    at position ``base + j``.  Returns ``(accepted, tokens)`` where
    ``tokens`` is the committed list — the agreeing draft prefix plus
    the target's token at the first disagreement (or the bonus token
    when every draft agreed).  ``len(tokens) == accepted + 1`` always:
    a round commits at least the plain-decode token."""
    target = np.argmax(np.asarray(verify_logits), axis=-1)
    accepted = 0
    for j, d in enumerate(drafts):
        if int(d) != int(target[j]):
            break
        accepted += 1
    return accepted, [int(t) for t in target[:accepted + 1]]


def accept_drafts_sampled(drafts, draft_probs, verify_logits, cfg,
                          base_counter, bias_rows=None):
    """The Leviathan ADJUSTED acceptance rule for one slot (sampled).

    Position ``j`` (absolute counter ``c = base_counter + j``) compares
    the target's warped distribution ``p = warp(verify_logits[j])``
    against the draft distribution ``q = draft_probs[j]`` THE DRAFT WAS
    ACTUALLY DRAWN FROM, and:

    - accepts draft ``d`` iff ``u < min(1, p[d] / q[d])`` with ``u``
      drawn from stream ``(seed, c, TAG_ACCEPT)``;
    - on rejection commits a resample from the normalized residual
      ``max(p - q, 0)`` (stream ``(seed, c, TAG_RESIDUAL)``) and stops;
    - when all ``m`` drafts survive, commits the bonus token from the
      target distribution at position ``m`` (stream TAG_DRAW — the same
      stream a plain draw at that counter uses).

    Marginally each committed token is distributed exactly as plain
    sampling from ``p`` (the rejection-sampling identity:
    ``q(d)·min(1, p/q) + P[reject]·residual = p``), so speculative
    sampling is distribution-preserving at every draft quality — only
    wall-clock changes.  With ``cfg.temperature == 0`` the warps are
    one-hot and this reduces to the greedy equality rule above.

    drafts: the ``m`` proposed tokens; draft_probs: ``m`` warped [vocab]
    draft rows; verify_logits: ``[>= m+1, vocab]`` target logits;
    cfg: the request's SamplingConfig (seed + warp params); bias_rows:
    optional ``m+1`` bias/mask rows, one per position (constrained
    decode advances its mask per draft position).  Returns
    ``(accepted, tokens)`` with ``len(tokens) == accepted + 1``.
    """
    verify_logits = np.asarray(verify_logits, np.float32)
    m = len(drafts)
    seed = cfg.seed

    def target_dist(j):
        bias = None if bias_rows is None else bias_rows[j]
        return np.asarray(host_warp(
            verify_logits[j], cfg.temperature, cfg.top_k, cfg.top_p,
            bias=bias), np.float64)

    tokens = []
    for j, d in enumerate(drafts):
        c = base_counter + j
        d = int(d)
        p = target_dist(j)
        q = np.asarray(draft_probs[j], np.float64)
        ratio = float(p[d]) / max(float(q[d]), 1e-20)
        if host_uniform(seed, c, TAG_ACCEPT) < ratio:
            tokens.append(d)
            continue
        residual = np.maximum(p - q, 0.0)
        total = float(residual.sum())
        # total == 0 means p <= q everywhere, i.e. p == q — then
        # ratio == 1 and rejection is unreachable; the guard keeps a
        # float-exact tie from dividing by zero.
        dist = residual / total if total > 0.0 else p
        tokens.append(host_draw(dist, seed, c, TAG_RESIDUAL))
        return j, tokens
    tokens.append(host_draw(target_dist(m), seed, base_counter + m,
                            TAG_DRAW))
    return m, tokens
