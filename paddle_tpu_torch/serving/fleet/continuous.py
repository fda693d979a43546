"""Continuous (iteration-level) batching for autoregressive decode (port
of ``paddle_tpu/serving/fleet/continuous.py``, a copy: the module is
host numpy; the step function it drives runs the model on the card).

Orca's observation (OSDI 2022), applied to this stack: request-level
coalescing runs an autoregressive batch at the speed of its LONGEST
member — finished sequences keep occupying their batch rows as dead
weight until the whole batch drains, and waiting requests can't start
until it does.  Scheduling at *token* boundaries instead fixes both:
every decode step, finished sequences retire immediately and queued
requests are admitted into the freed rows.

The design keeps the reference's fixed shapes (its XLA executables were
shape-specialized, and a CUDA graph per step shape is the port's later
counterpart): the batch does NOT grow/shrink physically as occupancy
churns.  The scheduler owns a **fixed-shape slot pool**: `slots` rows
of a `[slots, max_len]` prefix buffer plus per-slot context tensors,
always stepped at full physical shape.  Occupancy changes rewrite rows,
never shapes — ONE step shape serves every step at every occupancy,
which the engine asserts by tracking the shape signatures it dispatched
(`stats()["shape_signatures"]` must stay 1; the port's Executor has no
compiler, so this count is the contract).

**Paged KV mode**: with ``ContinuousConfig(kv=
PagedKVConfig(...))`` the dense per-slot prefix buffer is replaced by a
``serving.kv.KVBlockPool`` block table — decode memory becomes
O(tokens actually live) instead of O(slots · max_len), so at a fixed
arena budget the engine sustains far more concurrent sequences at
mixed output lengths (the PagedAttention model, Kwon et al. SOSP 2023
— PAPERS.md — under the same fixed-shape discipline: admission,
retirement, copy-on-write prefix sharing and block preemption all
rewrite table rows, never shapes).  Admission additionally gates on
free blocks; if the pool runs dry mid-decode, the lowest-priority
youngest sequence is *preempted back to the queue* with its generated
tokens as the re-queued prompt (greedy decode regenerates
deterministically, so no work is lost — vLLM's recompute preemption).
The step contract is unchanged: the engine gathers the pool into the
same fixed-shape prefix view every step (width rounded up to a block
multiple), so one executable still serves every occupancy.

**Speculative decoding** (Leviathan et al., arXiv:2211.17192 —
PAPERS.md): pass ``speculative=SpeculativeConfig(draft_step_fn,
verify_fn, k)`` and each scheduling round drafts ``k`` tokens per slot
with the cheap model, then verifies ALL of them in ONE target-model
call (`serving.kv.speculative`), committing the longest agreeing
prefix plus the target's own next token — identical tokens to plain
greedy decode, fewer target steps.  Sampled requests draft from the
warped draft distribution and commit through the Leviathan ADJUSTED
acceptance rule (accept with prob ``min(1, p/q)``, residual resample
on rejection) — distribution-preserving rather than token-identical,
verified by the seeded parity test.  With no draft model registered
the engine runs the plain path (the typed fallback).

The model side is a pure step function::

    step_fn(prefix  int64 [slots, max_len],
            lengths int64 [slots],
            context {name: [slots, ...]})  ->  logits [slots, vocab]

returning next-token logits for each slot's position ``lengths[i]-1``.
Continuation is greedy (argmax) by default; a request may carry a
``serving.sampling.SamplingConfig`` (temperature / top-k / top-p /
seed / logit_bias / grammar constraint), and the engine packs
heterogeneous configs into per-slot parameter ROWS drawn through one
shared sampler — greedy requests ride as temperature-0 degenerate rows,
so a mixed batch still dispatches ONE step shape
(``stats()["sampling"]`` tracks the sampler's plane shapes; all-plain
batches keep the host argmax fast path).  Empty slots carry a BOS-only
prefix (all-pad in paged mode) and their logits are ignored.
``make_program_step_fn`` adapts a fluid inference program (the
NMT/transformer decoder path) onto this contract;
``make_program_verify_fn`` adapts the same program onto the
speculative verify contract (same feed shapes as the step).

Admission shares the fleet SLA semantics: the wait queue is
priority-ordered (high queue-jumps batch), a full queue sheds the
newest lowest-priority entry for a higher-priority arrival, and
per-request deadlines are enforced at token boundaries — an expired
sequence frees its slot mid-decode instead of burning steps on a
result nobody is waiting for.
"""

import collections
import threading
import time

import numpy as np

from ...observability.trace import TRACER, current_sampled
from ...profiler import record_event
from ..batcher import (DeadlineExceeded, EngineStopped, ResolvableFuture,
                       ServerOverloaded, ServingError,
                       pick_preemption_victim, priority_insert)
from ..kv import KVBlockPool, PagedKVConfig, PoolExhausted
from ..sampling import SamplingConfig, SlotSampler
from .admission import AdmissionPolicy
from .metrics import DecodeMetrics


class EngineDraining(ServerOverloaded):
    """Submit refused because the engine is draining for a migration
    handoff (serving.elastic).  Subclasses ServerOverloaded so the
    fleet router FAILS OVER to a sibling without charging the breaker
    — draining is a planned state, not a fault."""


class DecodeRequest(ResolvableFuture):
    """Future for one sequence; resolves to the generated int64 token
    array INCLUDING the prompt prefix (length = prompt + generated)."""

    __slots__ = ("prompt", "context", "max_new_tokens", "priority",
                 "sla", "enq_t", "deadline", "trace_span", "requeue_t",
                 "sampling", "sample_counter", "constraint_state")

    def __init__(self, prompt, context, max_new_tokens, priority, sla,
                 deadline, sampling=None):
        super().__init__()
        self.prompt = prompt
        self.context = context
        self.max_new_tokens = max_new_tokens
        self.priority = int(priority)
        self.sla = sla
        self.enq_t = time.perf_counter()
        self.deadline = deadline
        # per-request sampling surface: the validated
        # SamplingConfig, plus the PRNG/constraint checkpoint a block
        # preemption saves — sample_counter is the absolute generated-
        # token index (the PRNG stream position), constraint_state the
        # mask stepper's state.  Re-admission resumes both, so a
        # recomputed sampled sequence replays identical streams and
        # regenerates identical tokens.
        self.sampling = SamplingConfig.coerce(sampling)
        self.sample_counter = 0
        self.constraint_state = SlotSampler._RESUME
        # tracing (observability.trace): the sequence's open root span
        # (None when unsampled), and the re-queue timestamp a block
        # preemption stamps so the second queue wait is attributed to
        # the requeue, not the original submit
        self.trace_span = None
        self.requeue_t = None


class ContinuousConfig:
    """Slot-pool / scheduling knobs.

    - slots: physical decode rows (the fixed batch dim)
    - max_len: prefix buffer length (prompt + generated, bos included)
    - bos_id / eos_id / pad_id: token conventions; generation stops at
      eos_id or the per-request max_new_tokens budget
    - context_spec: {name: (tail_shape, dtype)} per-slot model context
      (e.g. the NMT source sentence) — fixed shapes, validated at
      submit (shape AND dtype: non-numeric, float->int, ->bool and
      integer-narrowing casts are rejected with a named error at
      submit, not as an opaque mid-decode step failure; float width
      changes and int widening still cast silently)
    - kv: a serving.kv.PagedKVConfig — decode context lives in a
      refcounted block-table pool (paged mode) instead of the dense
      ``[slots, max_len]`` buffer.  The prefix view handed to step
      functions widens to ``ceil(max_len / block_size) * block_size``
      (still ONE fixed shape).  None = dense (the dense behavior)
    - max_queue: wait-queue bound (beyond it: priority shed, then
      ServerOverloaded)
    - classes: SLA registry mapped onto queue priorities (None =
      fleet default high/batch).  Only the class PRIORITY applies
      here — class deadlines are sized for single-batch inference and
      are not inherited by slot-holding decodes
    - default_timeout_ms: deadline when a submit passes no explicit
      timeout (None = no deadline)
    - drain_timeout_s: stop(drain=True) wait bound
    """

    def __init__(self, slots=8, max_len=64, bos_id=0, eos_id=1,
                 pad_id=None, context_spec=None, max_queue=256,
                 classes=None, default_timeout_ms=None,
                 drain_timeout_s=30.0, kv=None):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if max_len < 2:
            raise ValueError("max_len must be >= 2 (bos + 1 token)")
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.bos_id = int(bos_id)
        self.eos_id = int(eos_id)
        self.pad_id = int(pad_id) if pad_id is not None else int(eos_id)
        self.context_spec = dict(context_spec or {})
        self.max_queue = int(max_queue)
        self.policy = AdmissionPolicy(classes)
        self.default_timeout_ms = default_timeout_ms
        self.drain_timeout_s = drain_timeout_s
        if kv is not None and not isinstance(kv, PagedKVConfig):
            kv = PagedKVConfig(**kv)
        self.kv = kv


# ---------------------------------------------------------------------------
# Token stores: where a slot's prefix lives.  One scheduler, two
# memory models — the store owns placement, the engine owns policy.
# ---------------------------------------------------------------------------

class _DenseStore:
    """The dense memory model: a dense ``[slots, max_len]`` buffer.
    Every slot pays max_len whether it generates 5 tokens or 500 —
    the baseline the paged store's A/B is measured against."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.width = cfg.max_len
        self._prefix = np.full((cfg.slots, self.width), cfg.pad_id,
                               np.int64)
        self._prefix[:, 0] = cfg.bos_id

    def can_admit(self, n_tokens):
        return True

    def write_prompt(self, i, prompt):
        n = prompt.size
        self._prefix[i, :n] = prompt
        self._prefix[i, n:] = self.cfg.pad_id
        return True

    def append(self, i, pos, tok):
        self._prefix[i, pos] = tok
        return True

    def truncate(self, i, old_len, new_len):
        self._prefix[i, new_len:old_len] = self.cfg.pad_id

    def row(self, i, n):
        return self._prefix[i, :n].copy()

    def view(self):
        return self._prefix

    def free(self, i):
        self._prefix[i] = self.cfg.pad_id
        self._prefix[i, 0] = self.cfg.bos_id

    def fork_count(self):
        return None                  # dense rows never fork

    def snapshot(self):
        return None


class _PagedStore:
    """Block-table memory model over ``serving.kv.KVBlockPool`` —
    admission can refuse (no free blocks), appends can fail (pool
    pressure; the engine preempts), prompts dedup through the prefix
    cache, and the dense step view is a gather through the table."""

    def __init__(self, cfg):
        self.cfg = cfg
        bs = cfg.kv.block_size
        self.max_blocks = -(-cfg.max_len // bs)
        self.width = self.max_blocks * bs
        self.pool = KVBlockPool(cfg.slots, self.max_blocks, cfg.kv,
                                pad_id=cfg.pad_id)

    def can_admit(self, n_tokens):
        return self.pool.can_admit(n_tokens)

    def write_prompt(self, i, prompt):
        try:
            self.pool.admit(i, prompt)
            return True
        except PoolExhausted:
            return False

    def append(self, i, pos, tok):
        return self.pool.append(i, tok)

    def truncate(self, i, old_len, new_len):
        self.pool.truncate(i, new_len)

    def row(self, i, n):
        return self.pool.read_tokens(i, n)

    def view(self):
        return self.pool.token_view()

    def free(self, i):
        self.pool.release(i)

    def fork_count(self):
        return self.pool.cow_forks()

    def snapshot(self):
        return self.pool.snapshot()


class ContinuousBatchingEngine:
    """Step-level decode scheduler over a fixed-shape slot pool."""

    def __init__(self, step_fn, config=None, speculative=None):
        self.config = cfg = config or ContinuousConfig()
        self._step_fn = step_fn
        if speculative is not None and not all(
                hasattr(speculative, a)
                for a in ("draft_step_fn", "verify_fn", "k")):
            # fail at construction, not mid-round on the worker thread
            # (where a bad object would kill the loop and hang clients)
            raise TypeError(
                "speculative= expects a serving.kv.SpeculativeConfig "
                f"(draft_step_fn/verify_fn/k), got {type(speculative).__name__}")
        self._spec = speculative
        S = cfg.slots
        self._store = _PagedStore(cfg) if cfg.kv is not None \
            else _DenseStore(cfg)
        self._lengths = np.ones((S,), np.int64)
        self._context = {
            n: np.zeros((S,) + tuple(tail), dtype)
            for n, (tail, dtype) in cfg.context_spec.items()}
        self._slot_req = [None] * S          # DecodeRequest per slot
        self._slot_span = [None] * S         # open decode/occupancy
        self._slot_prompt_len = np.zeros((S,), np.int64)
        # per-slot sampling parameter rows + bias/mask plane; all-plain-
        # greedy batches bypass it entirely (the host argmax fast path)
        self._sampler = SlotSampler(S)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue = collections.deque()    # waiting DecodeRequests
        self._closed = False
        self._draining = False
        # serializes scheduler rounds against external slot extraction
        # (serving.elastic drain): rounds run OUTSIDE the cond lock, so
        # extract_sequences takes this lock to guarantee no step is
        # mid-flight while it lifts sequences out of their slots
        self._round_lock = threading.Lock()
        self._stop_now = threading.Event()
        self._drained = threading.Event()
        self._signatures = set()             # dispatched step shapes
        self._m = DecodeMetrics(S)
        self._worker = threading.Thread(target=self._loop,
                                        name="continuous-decoder",
                                        daemon=True)
        self._worker.start()

    # ---- client surface ----

    def submit(self, prompt, context=None, max_new_tokens=None,
               sla="high", timeout_ms=None, sampling=None,
               resume=None):
        """Enqueue one sequence.  `prompt` is the int token prefix
        (bos prepended if absent); `context` must match context_spec
        exactly (shape + losslessly-castable dtype); `max_new_tokens`
        bounds generation (default: to max_len); `sampling` is a
        SamplingConfig / kwargs dict / None (= greedy) — validated
        HERE with a named SamplingConfigError, the same submit-time
        discipline as the context dtype check below.  `resume` is a
        ``(sample_counter, constraint_state)`` checkpoint from another
        engine's ``extract_sequences`` (serving.elastic migration):
        admission resumes the PRNG stream at that absolute counter, so
        a migrated sampled sequence continues bit-identically.
        Returns a DecodeRequest future resolving to the full token
        array."""
        cfg = self.config
        cls = cfg.policy.resolve(sla)
        sampling = SamplingConfig.coerce(sampling)
        prompt = np.asarray(prompt if prompt is not None else [],
                            np.int64).reshape(-1)
        if prompt.size == 0 or prompt[0] != cfg.bos_id:
            prompt = np.concatenate(
                [np.array([cfg.bos_id], np.int64), prompt])
        if prompt.size >= cfg.max_len:
            raise ServingError(
                f"prompt length {prompt.size} leaves no room to "
                f"generate within max_len {cfg.max_len}")
        if cfg.kv is not None:
            pool = self._store.pool
            need = pool.blocks_for(prompt.size + 1)
            if need > min(pool.capacity_blocks(), pool.max_blocks):
                raise ServingError(
                    f"prompt of {prompt.size} tokens needs {need} KV "
                    f"blocks; the pool holds "
                    f"{pool.capacity_blocks()} and a sequence may "
                    f"use {pool.max_blocks}")
        ctx = {}
        for n, (tail, dtype) in cfg.context_spec.items():
            if context is None or n not in context:
                raise ServingError(f"missing context tensor {n!r}")
            a = np.asarray(context[n])
            want = np.dtype(dtype)
            # dtype/rank validation at SUBMIT: an
            # un-castable or lossy context tensor used to sail through
            # the silent astype here and fail (or corrupt) steps later
            # — mid-decode, for every slot-mate in the batch.
            # Rejected: non-numeric, float->int, anything->bool, and
            # integer NARROWING (values wrap).  Float width changes
            # stay allowed — magnitude survives, and plain-python
            # feeds arrive float64
            lossy = (a.dtype.kind not in "biuf"
                     or want.kind not in "biuf"
                     or (a.dtype.kind == "f" and want.kind in "biu")
                     or (want.kind == "b" and a.dtype.kind != "b")
                     or (a.dtype.kind in "iu" and want.kind in "iu"
                         and a.dtype.itemsize > want.itemsize))
            if a.dtype != want and lossy:
                raise ServingError(
                    f"context {n!r} has dtype {a.dtype}, spec says "
                    f"{want} (lossy or non-numeric casts are "
                    f"rejected at submit)")
            a = a.astype(want, copy=False)
            if a.shape != tuple(tail):
                raise ServingError(
                    f"context {n!r} has shape {a.shape}, spec says "
                    f"{tuple(tail)}")
            ctx[n] = a
        budget = int(max_new_tokens) if max_new_tokens is not None \
            else cfg.max_len
        if budget < 1:
            raise ServingError("max_new_tokens must be >= 1")
        # class deadlines are sized for single-batch inference at the
        # router tier; a decode holds a slot for its whole generation
        # (plus queue time), so the class default is NOT inherited here
        # — only an explicit per-request timeout or the engine-level
        # default applies (None = no deadline).  The class still
        # supplies the PRIORITY.
        timeout_ms = timeout_ms if timeout_ms is not None \
            else cfg.default_timeout_ms
        deadline = time.perf_counter() + timeout_ms / 1000.0 \
            if timeout_ms is not None else None
        req = DecodeRequest(prompt, ctx, budget, cls.priority,
                            cls.name, deadline, sampling=sampling)
        if resume is not None:
            req.sample_counter, req.constraint_state = resume
        if TRACER.enabled():
            # a router-traced request chains under its ambient context;
            # a direct submit rolls its own head-sampling dice
            req.trace_span = TRACER.maybe_trace(
                "decode/sequence", sla=cls.name,
                attrs={"prompt_len": int(prompt.size),
                       "budget": budget, "sla": cls.name},
                parent=current_sampled())
        shed = None
        with self._cond:
            if self._closed:
                exc = EngineStopped(
                    "decode engine is stopped; submit refused")
                # refusals are exactly what postmortems need: close
                # the root with the error instead of leaking it open
                TRACER.end_span(req.trace_span, error=exc)
                raise exc
            if self._draining:
                exc = EngineDraining(
                    "decode engine is draining; submit refused")
                TRACER.end_span(req.trace_span, error=exc)
                raise exc
            if len(self._queue) >= self.config.max_queue:
                shed = pick_preemption_victim(self._queue, req.priority)
                if shed is None:
                    self._inc("shed_overloaded")
                    exc = ServerOverloaded(
                        f"decode wait queue full "
                        f"({self.config.max_queue} pending)")
                    TRACER.end_span(req.trace_span, error=exc)
                    raise exc
                self._queue.remove(shed)
            self._inc("submitted")
            if resume is not None:
                self._inc("migrated_in")
            priority_insert(self._queue, req)
            self._cond.notify_all()
        if shed is not None:
            exc = ServerOverloaded(
                f"shed for a priority-{req.priority} admission")
            shed._set_exception(exc)
            TRACER.end_span(shed.trace_span, error=exc)
            self._inc("shed_preempted")
        return req

    def decode(self, prompt, context=None, max_new_tokens=None,
               sla="high", timeout_ms=None, result_timeout_s=120.0,
               sampling=None):
        """Blocking convenience: submit + result."""
        return self.submit(prompt, context, max_new_tokens, sla,
                           timeout_ms,
                           sampling=sampling).result(result_timeout_s)

    # ---- scheduler ----

    def _free_slot_row(self, i):
        sp = self._slot_span[i]
        if sp is not None:
            # one occupancy segment ends whenever the slot frees —
            # retire, preemption, cancel, failure alike; a preempted
            # sequence's re-admit opens a SECOND segment under the
            # same root (the gap between them IS the preemption cost)
            TRACER.end_span(sp, length=int(self._lengths[i]))
            self._slot_span[i] = None
        self._store.free(i)
        self._lengths[i] = 1
        self._slot_prompt_len[i] = 0
        self._sampler.clear_slot(i)
        for a in self._context.values():
            a[i] = 0
        self._slot_req[i] = None

    def _admit_locked(self, now, expired, rejected):
        """Fill free slots from the wait queue (highest priority first
        — the queue is kept in priority order).  Called with the cond
        lock held; returns how many sequences were admitted.  Expired
        entries are APPENDED to `expired` and sampler-rejected ones
        (a constraint whose start state forbids every token) to
        `rejected` as (req, exc) pairs, not resolved here —
        resolution runs done callbacks, which may re-enter the engine
        and would deadlock on the lock the caller holds.  In paged
        mode admission additionally gates on free KV blocks: when the
        pool can't place the next candidate it goes back to the queue
        FRONT (order preserved) and the pass stops — occupancy is
        capped by tokens live, not slot count."""
        if self._draining:
            # a draining engine admits nothing: queued entries stay
            # queued so extract_sequences can hand them off intact
            return 0
        admitted = 0
        for i in range(self.config.slots):
            if self._slot_req[i] is not None:
                continue
            req = None
            while self._queue:
                cand = self._queue.popleft()
                if cand.done():
                    if cand.cancelled():
                        self._inc("cancelled")
                    continue
                if cand.deadline is not None and now >= cand.deadline:
                    expired.append(cand)
                    continue
                req = cand
                break
            if req is None:
                break
            n = req.prompt.size
            if not self._store.can_admit(n) or \
                    not self._store.write_prompt(i, req.prompt):
                # no KV capacity for the highest-priority waiter:
                # nothing lower would fit either (blocks, not slots,
                # are the scarce resource) — stop this pass
                self._queue.appendleft(req)
                break
            try:
                # scatter the request's SamplingConfig into slot rows,
                # resuming a preempted request's (counter, constraint)
                # checkpoint.  A constraint that forbids EVERY token
                # fails typed here, per-request — not mid-step for the
                # whole batch
                self._sampler.set_slot(i, req.sampling,
                                       counter=req.sample_counter,
                                       state=req.constraint_state)
            except ServingError as e:
                self._store.free(i)
                rejected.append((req, e))
                continue
            self._lengths[i] = n
            self._slot_prompt_len[i] = n
            for name, a in self._context.items():
                a[i] = req.context[name]
            self._slot_req[i] = req
            sp = req.trace_span
            if sp is not None:
                readmit = req.requeue_t is not None
                # a re-queue wait is attributed to PREEMPTION by the
                # critical path (the occupancy-gap rule), so the span
                # carries the readmit flag to avoid double-counting
                TRACER.add_span("decode/queue", sp,
                                req.requeue_t or req.enq_t, now,
                                attrs={"readmit": readmit})
                TRACER.event("admit", span=sp, slot=i,
                             readmit=readmit)
                self._slot_span[i] = TRACER.start_span(
                    "decode/occupancy", sp,
                    attrs={"slot": i, "readmit": readmit})
            admitted += 1
        return admitted

    def _retire(self, i, ok=True, exc=None):
        req = self._slot_req[i]
        if req is None:
            return
        if ok:
            toks = self._store.row(i, int(self._lengths[i]))
            if req._set_result(toks):
                self._inc("completed")
                self._m.inc_class(req.sla)
            else:
                self._inc("cancelled")
        else:
            if req._set_exception(exc):
                self._inc("expired" if isinstance(exc, DeadlineExceeded)
                          else "failed")
        n_toks = int(self._lengths[i])
        self._free_slot_row(i)
        TRACER.end_span(req.trace_span,
                        error=exc if not ok else None,
                        outcome="completed" if ok else
                        type(exc).__name__, tokens=n_toks)

    def _resolve_expired(self, expired, rejected=()):
        """Resolve queue-expired and admission-rejected requests OUTSIDE
        the scheduler lock (their done callbacks may re-enter the
        engine)."""
        for r in expired:
            exc = DeadlineExceeded(
                "deadline passed while queued for a decode slot")
            if r._set_exception(exc):
                self._inc("expired")
            TRACER.end_span(r.trace_span, error=exc)
        for r, exc in rejected:
            if r._set_exception(exc):
                self._inc("failed")
            TRACER.end_span(r.trace_span, error=exc)

    # ---- paged-mode block preemption ----

    def _pick_block_victim(self):
        """The sequence that yields its blocks when the pool runs dry:
        lowest priority first, youngest within a priority (least work
        lost).  Every occupied slot is eligible, INCLUDING the one
        that needs the block — the caller re-queues it rather than
        evict better-ranked work for it."""
        best = None
        best_key = None
        for j in range(self.config.slots):
            req = self._slot_req[j]
            if req is None:
                continue
            key = (req.priority, -req.enq_t)
            if best is None or key < best_key:
                best, best_key = j, key
        return best

    def _preempt_to_queue(self, j):
        """Bounce slot `j` back to the wait queue with its CURRENT
        tokens as the prompt (greedy decode regenerates nothing — the
        re-queued sequence resumes exactly where it stopped) and its
        budget reduced by what it already generated; its blocks free
        for the needy sequence.  vLLM's recompute preemption under the
        fixed-shape discipline."""
        req = self._slot_req[j]
        n = int(self._lengths[j])
        generated = n - int(self._slot_prompt_len[j])
        req.prompt = self._store.row(j, n)
        req.max_new_tokens = max(1, req.max_new_tokens - generated)
        # checkpoint the PRNG stream position + constraint state: the
        # recompute resumes the SAME streams at the SAME counters, so a
        # preempted sampled sequence regenerates identical tokens (the
        # sampled analogue of "greedy decode regenerates nothing")
        req.sample_counter, req.constraint_state = \
            self._sampler.suspend(j)
        self._free_slot_row(j)           # closes the occupancy segment
        req.requeue_t = time.perf_counter()
        if req.trace_span is not None:
            TRACER.event("preempt", span=req.trace_span, slot=j,
                         generated=generated)
        with self._cond:
            priority_insert(self._queue, req)
            self._cond.notify_all()
        self._inc("preempted_for_blocks")

    def _append_token(self, i, pos, tok):
        """Append with block-pressure handling: on allocation failure
        preempt victims (possibly slot `i` itself) until the append
        lands or `i` was re-queued.  Returns True when the token is
        in place; False when slot `i` no longer holds a sequence."""
        while True:
            sp = self._slot_span[i]
            # COW forks surface on the occupancy segment: diff the
            # store's fork counter around this slot's append (the
            # scheduler is single-threaded, so the delta is ours;
            # dense stores report None — rows never fork)
            c0 = self._store.fork_count() if sp is not None else None
            placed = self._store.append(i, pos, tok)
            if c0 is not None and placed and \
                    self._store.fork_count() > c0:
                TRACER.event("cow_fork", span=sp, pos=pos)
            if placed:
                return True
            v = self._pick_block_victim()
            if v == i:
                # i is the cheapest victim.  Re-queue it ONLY if its
                # grown prompt can ever be re-admitted — a sequence
                # whose tokens already need the whole pool would
                # otherwise cycle the queue forever (silent hang);
                # that is a sizing error, surfaced typed instead
                pool = self._store.pool
                if pool.blocks_for(int(self._lengths[i]) + 1) > \
                        min(pool.capacity_blocks(), pool.max_blocks):
                    self._retire(i, ok=False, exc=ServingError(
                        f"sequence of {int(self._lengths[i])} tokens "
                        f"exhausted the KV pool with nothing left to "
                        f"preempt; raise FLAGS_kv_num_blocks"))
                    return False
            self._preempt_to_queue(v)
            if v == i:
                return False

    # ---- the scheduling loop ----

    def _record_signature(self, prefix):
        sig = ((prefix.shape, self._lengths.shape) +
               tuple(sorted((n, a.shape) for n, a in
                            self._context.items())))
        self._signatures.add(sig)

    def _loop(self):
        cfg = self.config
        while not self._stop_now.is_set():
            expired = []
            rejected = []
            stopping = False
            with self._cond:
                now = time.perf_counter()
                # mid-flight means joining a batch that was RUNNING
                # before this admission pass — an admission into a
                # drained (idle) pool is an ordinary batch start
                pre_occupied = any(r is not None
                                   for r in self._slot_req)
                n_admitted = self._admit_locked(now, expired, rejected)
                active = [i for i in range(cfg.slots)
                          if self._slot_req[i] is not None]
                if not active:
                    if self._closed and not self._queue:
                        stopping = True
                    else:
                        self._cond.wait(0.05)
                elif pre_occupied and n_admitted:
                    # a sequence joined a RUNNING batch at a token
                    # boundary — the continuous-batching event itself
                    self._inc("admitted_midflight", n_admitted)
            self._resolve_expired(expired, rejected)
            if stopping:
                break
            if not active:
                continue
            with self._round_lock:
                if self._spec is not None:
                    self._speculative_round(active)
                else:
                    self._plain_round(active)
        # shutdown: resolve everything still queued or in a slot
        with self._cond:
            leftovers = [r for r in self._queue if not r.done()]
            self._queue.clear()
            for i in range(cfg.slots):
                req = self._slot_req[i]
                if req is not None:
                    leftovers.append(req)
                    self._slot_req[i] = None
        for r in leftovers:
            exc = EngineStopped("decode engine stopped")
            if r._set_exception(exc):
                self._inc("failed")
            TRACER.end_span(r.trace_span, error=exc)
        self._drained.set()

    def _plain_round(self, active):
        cfg = self.config
        t0 = time.perf_counter()
        try:
            with record_event("fleet/decode_step"):
                prefix = self._store.view()
                self._record_signature(prefix)
                logits = np.asarray(self._step_fn(
                    prefix, self._lengths, self._context))
        except Exception as e:        # noqa: BLE001 — typed to the
            for i in active:          # waiters, scheduler survives
                self._retire(i, ok=False, exc=ServingError(
                    f"decode step failed: {e!r}"))
            return
        step_ms = (time.perf_counter() - t0) * 1e3
        # all-plain-greedy batches keep the host argmax; any
        # sampled / biased / constrained slot routes the WHOLE plane
        # through the shared sampler (greedy slot-mates ride as
        # temperature-0 degenerate rows — same tokens, one shape)
        use_sampler = not self._sampler.plain_greedy(active)
        if use_sampler:
            try:
                nxt = self._sampler.draw(logits)
            except ServingError as e:
                for i in active:
                    self._retire(i, ok=False, exc=ServingError(
                        f"sampling draw failed: {e!r}"))
                return
        else:
            nxt = np.argmax(logits, axis=-1)
        now = time.perf_counter()
        done_tokens = 0
        sampled_tokens = 0
        constrained_tokens = 0
        for i in active:
            req = self._slot_req[i]
            if req is None:              # preempted for blocks by an
                continue                 # earlier slot this round
            if req.done():               # cancelled mid-decode
                self._inc("cancelled")
                self._free_slot_row(i)
                TRACER.end_span(req.trace_span, outcome="cancelled")
                continue
            if req.deadline is not None and now >= req.deadline:
                # expiry at the token boundary: free the slot NOW
                # instead of decoding for a dead waiter
                self._retire(i, ok=False, exc=DeadlineExceeded(
                    "deadline passed mid-decode"))
                continue
            pos = int(self._lengths[i])
            tok = int(nxt[i])
            if not self._append_token(i, pos, tok):
                continue                 # preempted for blocks
            self._lengths[i] = pos + 1
            sp = self._slot_span[i]
            if sp is not None:
                # each token step is a child EVENT on the occupancy
                # segment (a span per token would explode the store)
                TRACER.event("step", span=sp, pos=pos, tok=tok)
            done_tokens += 1
            scfg = req.sampling
            if not scfg.plain_greedy():
                sampled_tokens += 1
                if scfg.constraint is not None:
                    constrained_tokens += 1
            generated = pos + 1 - int(self._slot_prompt_len[i])
            finished = tok == cfg.eos_id or pos + 1 >= cfg.max_len or \
                generated >= req.max_new_tokens
            if use_sampler and not finished:
                # advance the PRNG counter + constraint mask for the
                # NEXT position (the finishing token draws nothing
                # after it, so its advance is skipped — steppers never
                # see EOS unless their grammar admits it)
                try:
                    self._sampler.advance(i, tok)
                except ServingError as e:
                    self._retire(i, ok=False, exc=e)
                    continue
            if finished:
                self._retire(i)          # immediate slot reuse
        self._inc("tokens_generated", done_tokens)
        if sampled_tokens:
            self._inc("sampled_tokens", sampled_tokens)
        if constrained_tokens:
            self._inc("constrained_tokens", constrained_tokens)
        self._m.observe_step(len(active), step_ms)

    def _speculative_round(self, active):
        """Draft k tokens per slot with the cheap model, verify them in
        ONE target call, commit the longest surviving prefix + one more
        token.  Greedy slots use the exact equality rule (token-for-
        token identical to plain greedy decode); sampled slots draft
        from the WARPED draft distribution (stream TAG_DRAFT) and run
        the Leviathan adjusted acceptance rule — distribution-
        preserving (serving.kv.speculative docstring has the
        argument).  Each round costs one target step regardless of how
        many tokens it commits."""
        from ..kv import accept_drafts, accept_drafts_sampled

        cfg = self.config
        spec = self._spec
        base = self._lengths.copy()
        use_sampler = not self._sampler.plain_greedy(active)
        # per-slot draft room: the drafts plus the verify's bonus
        # token must all fit the budget and the prefix buffer
        room = {}
        for i in active:
            req = self._slot_req[i]
            gen = int(base[i]) - int(self._slot_prompt_len[i])
            room[i] = max(0, min(spec.k,
                                 cfg.max_len - int(base[i]) - 1,
                                 req.max_new_tokens - gen - 1))
        drafts = {i: [] for i in active}
        # sampled-mode per-slot state: the tentative (counter, mask)
        # chain, the warped draft distributions the proposals were
        # drawn from, and the mask row in force at each draft position
        # (the acceptance rule warps the TARGET logits under the same
        # masks) — built lazily once the vocab is known
        chains = {}
        qrows = {i: [] for i in active}
        mask_rows = {i: [] for i in active}
        lens_tmp = base.copy()
        t0 = time.perf_counter()
        try:
            for j in range(max(room.values(), default=0)):
                with record_event("fleet/draft_step"):
                    dlogits = np.asarray(spec.draft_step_fn(
                        self._store.view(), lens_tmp, self._context))
                self._inc("draft_steps")
                if use_sampler and not chains:
                    vocab = dlogits.shape[-1]
                    chains = {i: self._sampler.chain(i, vocab)
                              for i in active}
                for i in active:
                    if j >= room[i]:
                        continue
                    if use_sampler:
                        ch = chains[i]
                        mask = ch.mask()
                        tok, q = ch.draft(dlogits[i])
                    else:
                        tok = int(np.argmax(dlogits[i]))
                    if not self._store.append(
                            i, int(lens_tmp[i]), tok):
                        room[i] = len(drafts[i])   # clip, no preempt
                        continue                   # mid-draft
                    drafts[i].append(tok)
                    if use_sampler:
                        qrows[i].append(q)
                        mask_rows[i].append(mask)
                        ch.push(tok)
                    lens_tmp[i] += 1
            with record_event("fleet/spec_verify"):
                prefix = self._store.view()
                self._record_signature(prefix)
                vlogits = np.asarray(spec.verify_fn(
                    prefix, base, lens_tmp, self._context))
            if use_sampler:
                if not chains:                 # zero draft room
                    vocab = vlogits.shape[-1]
                    chains = {i: self._sampler.chain(i, vocab)
                              for i in active}
                for i in active:
                    # the mask for the position AFTER the last draft —
                    # the bonus/residual position the accept rule warps
                    mask_rows[i].append(chains[i].mask())
        except Exception as e:        # noqa: BLE001 — typed, survives
            for i in active:
                self._retire(i, ok=False, exc=ServingError(
                    f"decode step failed: {e!r}"))
            return
        step_ms = (time.perf_counter() - t0) * 1e3
        now = time.perf_counter()
        done_tokens = 0
        sampled_tokens = 0
        constrained_tokens = 0
        for i in active:
            req = self._slot_req[i]
            if req is None:              # preempted for blocks by an
                continue                 # earlier slot this round
            if req.done():
                self._inc("cancelled")
                self._free_slot_row(i)
                TRACER.end_span(req.trace_span, outcome="cancelled")
                continue
            if req.deadline is not None and now >= req.deadline:
                self._retire(i, ok=False, exc=DeadlineExceeded(
                    "deadline passed mid-decode"))
                continue
            m = len(drafts[i])
            scfg = req.sampling
            if use_sampler and not scfg.plain_greedy():
                # adjusted acceptance over the warped distributions;
                # base_counter is the slot's committed PRNG position
                # (the chain drafted from the same base, so draft /
                # accept / residual streams line up per position)
                accepted, toks = accept_drafts_sampled(
                    drafts[i], qrows[i], vlogits[i, :m + 1], scfg,
                    base_counter=int(self._sampler.counters[i]),
                    bias_rows=mask_rows[i])
                if accepted < m:
                    self._inc("residual_resamples")
            else:
                accepted, toks = accept_drafts(
                    drafts[i], vlogits[i, :m + 1])
            self._inc("draft_tokens", m)
            self._inc("draft_accepted", accepted)
            if self._slot_span[i] is not None:
                TRACER.event("spec_round", span=self._slot_span[i],
                             drafted=m, accepted=accepted)
            # rejected drafts roll back; the accepted prefix is
            # already in place, only the target's token appends
            self._store.truncate(i, int(lens_tmp[i]),
                                 int(base[i]) + accepted)
            self._lengths[i] = int(base[i]) + accepted
            if not self._append_token(i, int(self._lengths[i]),
                                      toks[-1]):
                continue                 # preempted for blocks
            self._lengths[i] += 1
            # commit bookkeeping mirrors the plain loop, applied to
            # every token this round placed (stop conditions scan in
            # order so an early eos cuts the tail exactly like k=0)
            stop_at = None
            for idx, tok in enumerate(toks):
                pos = int(base[i]) + idx + 1     # length after tok
                generated = pos - int(self._slot_prompt_len[i])
                if tok == cfg.eos_id or pos >= cfg.max_len or \
                        generated >= req.max_new_tokens:
                    stop_at = idx
                    break
            if stop_at is not None and stop_at + 1 < len(toks):
                new_len = int(base[i]) + stop_at + 1
                self._store.truncate(i, int(self._lengths[i]),
                                     new_len)
                self._lengths[i] = new_len
            committed = toks if stop_at is None else toks[:stop_at + 1]
            if use_sampler:
                # replay the committed prefix onto the REAL sampler
                # state (the draft chain was tentative): counter +
                # constraint step per committed token, minus the
                # finishing token — exactly the plain-round discipline
                bad = None
                for tok in (committed[:-1] if stop_at is not None
                            else committed):
                    try:
                        self._sampler.advance(i, tok)
                    except ServingError as e:
                        bad = e
                        break
                if bad is not None:
                    self._retire(i, ok=False, exc=bad)
                    continue
            if not scfg.plain_greedy():
                sampled_tokens += len(committed)
                if scfg.constraint is not None:
                    constrained_tokens += len(committed)
            done_tokens += int(self._lengths[i]) - int(base[i])
            if stop_at is not None:
                self._retire(i)
        self._inc("tokens_generated", done_tokens)
        if sampled_tokens:
            self._inc("sampled_tokens", sampled_tokens)
        if constrained_tokens:
            self._inc("constrained_tokens", constrained_tokens)
        self._inc("spec_rounds")
        # one verify call = one target-model step: "steps" stays the
        # comparable unit between plain and speculative scheduling
        self._m.observe_step(len(active), step_ms)

    # ---- lifecycle / observability ----

    def _inc(self, name, n=1):
        self._m.inc(name, n)

    def pending(self):
        with self._lock:
            return len(self._queue)

    def kv_pool(self):
        """The engine's paged ``KVBlockPool`` when configured with
        ``ContinuousConfig(kv=...)``, else None — the seam the
        disaggregated tier (serving.disagg) ingests `kv_stream`
        transfers through."""
        return getattr(self._store, "pool", None)

    # ---- drain / migration (serving.elastic) ----

    def begin_drain(self):
        """Flip the engine into drain mode: submits fail typed
        (:class:`EngineDraining`, a ServerOverloaded subclass — the
        router fails over without a breaker penalty) and the admission
        pass stops pulling from the wait queue, so extract_sequences
        sees a frozen population.  Active slots KEEP decoding until
        extracted — drain never stalls work it hasn't re-homed yet."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def extract_sequences(self):
        """Lift every sequence out of the engine for migration: the
        drain analogue of ``_preempt_to_queue``, aimed at ANOTHER
        replica instead of this engine's own queue.

        For each occupied slot — with the round lock held, so no step
        is mid-flight — the slot's KV chain is exported FIRST
        (``KVBlockPool.export_slot``, a consistent copy under the pool
        lock), then the request is checkpointed exactly like a block
        preemption: current tokens become the prompt, the budget is
        debited by what was generated, and the sampler hands back its
        ``(absolute counter, constraint state)`` so the PRNG stream
        resumes bit-identically on the receiver.  Queued (not yet
        started) requests ride along with no export.  Slots and
        blocks are freed here; the requests' futures stay OPEN — the
        migration layer chains them to the target's futures.

        Returns ``[{"request", "export", "active"}, ...]`` — active
        slot-holders first (most progress to protect), queue order
        preserved after."""
        out = []
        with self._round_lock, self._cond:
            if not self._draining:
                raise ServingError(
                    "extract_sequences requires begin_drain() first")
            for i in range(self.config.slots):
                req = self._slot_req[i]
                if req is None:
                    continue
                if req.done():
                    self._inc("cancelled")
                    self._free_slot_row(i)
                    TRACER.end_span(req.trace_span,
                                    outcome="cancelled")
                    continue
                n = int(self._lengths[i])
                generated = n - int(self._slot_prompt_len[i])
                pool = self.kv_pool()
                export = pool.export_slot(i) if pool is not None \
                    else None
                req.prompt = self._store.row(i, n)
                req.max_new_tokens = max(
                    1, req.max_new_tokens - generated)
                req.sample_counter, req.constraint_state = \
                    self._sampler.suspend(i)
                self._free_slot_row(i)
                req.requeue_t = time.perf_counter()
                if req.trace_span is not None:
                    TRACER.event("migrate_out", span=req.trace_span,
                                 slot=i, generated=generated)
                out.append({"request": req, "export": export,
                            "active": True})
            while self._queue:
                r = self._queue.popleft()
                if r.done():
                    if r.cancelled():
                        self._inc("cancelled")
                    continue
                out.append({"request": r, "export": None,
                            "active": False})
            self._cond.notify_all()
        if out:
            self._inc("migrated_out", len(out))
        return out

    def stats(self):
        m = self._m.snapshot()
        c = m["counters"]
        active = sum(1 for r in self._slot_req if r is not None)
        out = {
            "counters": c,
            "occupancy": m["occupancy"],
            "step_ms": m["step_ms"],
            "completed_by_class": m["completed_by_class"],
            "speculative": m["speculative"],
            "slots": self.config.slots,
            "active_slots": active,
            "draining": self._draining,
            "pending": self.pending(),
            # the fixed-shape invariant: every step this engine ever
            # dispatched used ONE physical shape set
            "shape_signatures": len(self._signatures),
            # the sampler's analogue: one [slots, vocab] plane shape,
            # whatever mix of greedy/sampled/constrained configs ran
            "sampling": self._sampler.stats(),
            "tokens_per_step": round(
                c["tokens_generated"] / c["steps"], 3)
            if c["steps"] else 0.0,
        }
        kv = self._store.snapshot()
        if kv is not None:
            out["kv"] = kv
        return out

    def stop(self, drain=True, timeout_s=None):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if drain:
            self._drained.wait(timeout_s if timeout_s is not None
                               else self.config.drain_timeout_s)
        self._stop_now.set()
        with self._cond:
            self._cond.notify_all()
        self._worker.join(timeout_s if timeout_s is not None
                          else self.config.drain_timeout_s)
        if not self._drained.is_set():
            # forced stop: the loop's shutdown sweep didn't run
            with self._cond:
                leftovers = [r for r in self._queue if not r.done()]
                self._queue.clear()
                leftovers += [r for r in self._slot_req
                              if r is not None and not r.done()]
            for r in leftovers:
                exc = EngineStopped("decode engine stopped")
                r._set_exception(exc)
                TRACER.end_span(r.trace_span, error=exc)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)


def lockstep_decode(step_fn, requests, config):
    """The request-level-coalescing BASELINE the acceptance A/B compares
    against: take up to `slots` requests at a time, decode the whole
    group in lockstep until EVERY member finished (eos / budget /
    max_len), only then start the next group — the pre-Orca regime
    where a batch runs at the speed of its longest member and finished
    rows ride along as padding.

    Same step_fn contract, same fixed physical shapes (paged configs
    use the same block-rounded width so the executable matches).
    Returns (results, steps_executed): results[i] is the full token
    array for requests[i] = (prompt, context, max_new_tokens) tuples."""
    cfg = config
    S = cfg.slots
    if cfg.kv is not None:
        bs = cfg.kv.block_size
        L = (-(-cfg.max_len // bs)) * bs
    else:
        L = cfg.max_len
    results = [None] * len(requests)
    steps = 0
    for g0 in range(0, len(requests), S):
        group = requests[g0:g0 + S]
        prefix = np.full((S, L), cfg.pad_id, np.int64)
        prefix[:, 0] = cfg.bos_id
        lengths = np.ones((S,), np.int64)
        prompt_len = np.zeros((S,), np.int64)
        context = {n: np.zeros((S,) + tuple(tail), dtype)
                   for n, (tail, dtype) in cfg.context_spec.items()}
        budgets = np.zeros((S,), np.int64)
        alive = np.zeros((S,), bool)
        for i, (prompt, ctx, budget) in enumerate(group):
            prompt = np.asarray(prompt, np.int64).reshape(-1)
            if prompt.size == 0 or prompt[0] != cfg.bos_id:
                prompt = np.concatenate(
                    [np.array([cfg.bos_id], np.int64), prompt])
            if prompt.size >= cfg.max_len:
                # same typed contract as submit(): a full prefix has no
                # room to generate (untyped IndexError on step 1 else)
                raise ServingError(
                    f"prompt length {prompt.size} leaves no room to "
                    f"generate within max_len {cfg.max_len}")
            prefix[i, :prompt.size] = prompt
            lengths[i] = prompt.size
            prompt_len[i] = prompt.size
            budgets[i] = budget if budget is not None else cfg.max_len
            for n in context:
                context[n][i] = ctx[n]
            alive[i] = True
        while alive.any():
            logits = np.asarray(step_fn(prefix, lengths, context))
            nxt = np.argmax(logits, axis=-1)
            steps += 1
            for i in range(len(group)):
                if not alive[i]:
                    continue
                pos = int(lengths[i])
                tok = int(nxt[i])
                prefix[i, pos] = tok
                lengths[i] = pos + 1
                generated = pos + 1 - int(prompt_len[i])
                if tok == cfg.eos_id or pos + 1 >= cfg.max_len or \
                        generated >= budgets[i]:
                    alive[i] = False
        for i in range(len(group)):
            results[g0 + i] = prefix[i, :lengths[i]].copy()
    return results, steps


def make_program_step_fn(executor, program, predict_var, feed_builder):
    """Adapt a fluid inference program onto the step_fn contract.

    `feed_builder(prefix, lengths, context) -> feed dict` produces the
    program's FIXED-SHAPE feed for one step (the NMT path: trg prefix +
    per-slot attention biases from lengths + the src context);
    `predict_var` is the [slots, max_len-ish, vocab] per-position
    probability/logit fetch.  The returned step_fn gathers each slot's
    row at position ``lengths[i]-1`` — one executable for every step,
    every occupancy."""
    def step_fn(prefix, lengths, context):
        feed = feed_builder(prefix, lengths, context)
        (out,) = executor.run(program, feed=feed,
                              fetch_list=[predict_var])
        out = np.asarray(out)
        idx = (np.asarray(lengths, np.int64) - 1).clip(0)
        return np.take_along_axis(
            out, idx[:, None, None], axis=1)[:, 0, :]
    return step_fn


def make_program_verify_fn(executor, program, predict_var,
                           feed_builder, k):
    """Adapt the SAME fluid inference program onto the speculative
    verify contract: `(prefix, start_lengths, cur_lengths, context) ->
    [slots, k+1, vocab]` — the per-position logits at sequence
    positions ``start-1 .. start-1+k``, computed while the prefix
    already carries the k drafts (Leviathan et al., arXiv:2211.17192:
    a causal model's one forward pass scores every draft position at
    once).  The feed is built with `cur_lengths` so attention masks
    admit the draft positions; feed SHAPES are identical to the step
    path, so the verify call keeps the step's one shape signature."""
    def verify_fn(prefix, start_lengths, cur_lengths, context):
        feed = feed_builder(prefix, cur_lengths, context)
        (out,) = executor.run(program, feed=feed,
                              fetch_list=[predict_var])
        out = np.asarray(out)
        start = np.asarray(start_lengths, np.int64)
        idx = (start - 1).clip(0)[:, None] + np.arange(k + 1)[None, :]
        idx = idx.clip(0, out.shape[1] - 1)
        return np.take_along_axis(out, idx[:, :, None], axis=1)
    return verify_fn
