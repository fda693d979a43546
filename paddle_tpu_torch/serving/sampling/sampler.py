"""SlotSampler — heterogeneous per-request configs packed into slot rows.

The continuous-batching engine owns ``[slots, ...]`` planes for tokens and
context; this is the matching plane for sampling state.  Each admitted
request's ``SamplingConfig`` is scattered into per-slot parameter ROWS
(temperature / top-k / top-p / seed / counter vectors plus the lazily
allocated ``[slots, vocab]`` bias plane), and one draw call covers the
whole batch through the shared sampler (``ops/sampling_kernels``) —
different sampling params per slot, ONE step shape, whatever the mix.

Counters are the reproducibility spine: ``counters[i]`` is the absolute
index of the next token slot *i*'s request will generate, advanced once
per COMMITTED token.  ``suspend()`` checkpoints (counter, constraint
state) onto the request at preemption; re-admission resumes both, so a
recomputed sampled sequence replays the identical PRNG streams and
regenerates the identical tokens.
"""

import numpy as np

from ...ops import sampling_kernels as _sk
from .config import GREEDY, SamplingConfig
from .constrain import ConstraintError


def bias_row_for(cfg, state, vocab):
    """The ``[vocab]`` float32 bias row for one request at one position:
    logit_bias scatter + constraint mask (allowed tokens keep their bias,
    everything else -> -inf).  Raises ConstraintError when the combined
    row forbids every token (the draw would be undefined)."""
    row = np.zeros(vocab, np.float32)
    if cfg is None or cfg is GREEDY:
        return row
    if cfg.logit_bias:
        for tok, b in cfg.logit_bias.items():
            if tok < vocab:
                row[tok] = b
    if cfg.constraint is not None:
        mask = np.full(vocab, _sk.MASKED, np.float32)
        ok = [t for t in cfg.constraint.allowed(state, vocab)
              if t is not None and 0 <= int(t) < vocab]
        if ok:
            mask[ok] = 0.0
        row = row + mask
    if (cfg.logit_bias or cfg.constraint is not None) \
            and not np.isfinite(row).any():
        raise ConstraintError(
            f"constraint/logit_bias forbids every token "
            f"(state {state!r}, vocab {vocab})")
    return row


class SlotSampler:
    """Per-slot sampling parameter rows + bias plane for one engine."""

    _RESUME = object()          # sentinel: "no checkpointed state given"

    def __init__(self, slots):
        self.slots = slots
        self.temperature = np.zeros(slots, np.float32)
        self.top_k = np.zeros(slots, np.int32)
        self.top_p = np.ones(slots, np.float32)
        self.seeds = np.zeros(slots, np.uint32)
        self.counters = np.zeros(slots, np.uint32)
        self._cfg = [None] * slots
        self._state = [None] * slots
        self._bias = None               # [slots, vocab], lazy on first draw
        self._vocab = None
        self._shapes = set()            # plane shapes THIS sampler used

    # ---- slot lifecycle ----

    def set_slot(self, i, cfg, counter=0, state=_RESUME):
        """Admit a request's config into slot i.  ``counter``/``state``
        resume a preempted request's checkpoint; a fresh request starts
        at counter 0 with ``constraint.start()``."""
        cfg = SamplingConfig.coerce(cfg)
        self._cfg[i] = cfg
        self.temperature[i] = cfg.temperature
        self.top_k[i] = cfg.top_k
        self.top_p[i] = cfg.top_p
        self.seeds[i] = cfg.seed
        self.counters[i] = counter
        if cfg.constraint is not None and state is SlotSampler._RESUME:
            state = cfg.constraint.start()
        self._state[i] = None if cfg.constraint is None else state
        if self._bias is not None:
            self._bias[i] = bias_row_for(cfg, self._state[i], self._vocab)

    def clear_slot(self, i):
        self._cfg[i] = None
        self._state[i] = None
        self.temperature[i] = 0.0
        self.top_k[i] = 0
        self.top_p[i] = 1.0
        self.seeds[i] = 0
        self.counters[i] = 0
        if self._bias is not None:
            self._bias[i] = 0.0

    def suspend(self, i):
        """Checkpoint (counter, constraint_state) for preemption requeue —
        feed both back into set_slot at re-admission."""
        return int(self.counters[i]), self._state[i]

    def advance(self, i, token):
        """One token COMMITTED on slot i: bump the counter, step the
        constraint, refresh the slot's bias row for the next position."""
        cfg = self._cfg[i]
        if cfg is None:
            return
        self.counters[i] += 1
        if cfg.constraint is not None:
            self._state[i] = cfg.constraint.advance(self._state[i],
                                                    int(token))
            if self._bias is not None:
                self._bias[i] = bias_row_for(cfg, self._state[i],
                                             self._vocab)

    # ---- draw plane ----

    def config_of(self, i):
        return self._cfg[i]

    def plain_greedy(self, slot_ids):
        """True when every listed slot is default-greedy — the engine
        keeps its original host argmax fast path (no sampler dispatch,
        no bias plane) for all-greedy batches."""
        return all(self._cfg[i] is None or self._cfg[i].plain_greedy()
                   for i in slot_ids)

    def _ensure_plane(self, vocab):
        if self._bias is None or self._vocab != vocab:
            self._vocab = vocab
            self._shapes.add((self.slots, vocab))
            self._bias = np.zeros((self.slots, vocab), np.float32)
            for i, cfg in enumerate(self._cfg):
                if cfg is not None:
                    self._bias[i] = bias_row_for(cfg, self._state[i], vocab)
        return self._bias

    def bias_row(self, i, vocab):
        return self._ensure_plane(vocab)[i]

    def draw(self, logits):
        """One seeded draw over the ``[slots, vocab]`` logits plane.
        Pure: advances nothing — the engine calls ``advance`` per
        committed token (speculative rounds may commit several, or
        none of a slot's draws)."""
        logits = np.asarray(logits, np.float32)
        bias = self._ensure_plane(logits.shape[-1])
        toks, _ = _sk.sample_step(
            logits, self.temperature, self.top_k, self.top_p,
            self.seeds, self.counters, bias=bias)
        return toks

    def chain(self, i, vocab):
        """A tentative per-slot chain for speculative drafting: counter,
        constraint state, and mask advance per DRAFT token without
        touching the committed slot state (drafts beyond the accepted
        prefix are rolled back by simply dropping the chain)."""
        self._ensure_plane(vocab)
        return _SpecChain(self._cfg[i] or GREEDY, int(self.seeds[i]),
                          int(self.counters[i]), self._state[i], vocab)

    def stats(self):
        # sampler_shapes counts THIS engine's plane shapes (one per
        # pool, whatever the mix); the port has no compiler, so the
        # reference's process-wide jit-cache count has no counterpart
        return {"sampler_shapes": len(self._shapes)}


class _SpecChain:
    """Tentative (counter, constraint-state) chain for one slot's draft
    loop — see SlotSampler.chain."""

    __slots__ = ("cfg", "seed", "counter", "state", "vocab", "_mask")

    def __init__(self, cfg, seed, counter, state, vocab):
        self.cfg = cfg
        self.seed = seed
        self.counter = counter
        self.state = state
        self.vocab = vocab
        self._mask = None

    def mask(self):
        """Bias row for the CURRENT position (cached until push)."""
        if self._mask is None:
            self._mask = bias_row_for(self.cfg, self.state, self.vocab)
        return self._mask

    def draft(self, logits_row):
        """Warp the draft model's logits row with this request's config
        + current mask and draw the proposal from stream TAG_DRAFT.
        Returns (token, q) where q is the warped draft distribution the
        acceptance rule needs."""
        q = _sk.host_warp(logits_row, self.cfg.temperature,
                          self.cfg.top_k, self.cfg.top_p, bias=self.mask())
        tok = _sk.host_draw(q, self.seed, self.counter, _sk.TAG_DRAFT)
        return tok, q

    def push(self, token):
        """Tentatively commit one draft token: counter + grammar step."""
        self.counter += 1
        if self.cfg.constraint is not None:
            self.state = self.cfg.constraint.advance(self.state, int(token))
        self._mask = None
