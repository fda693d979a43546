"""Decode serving in the port: the paged KV pool (``serving/kv``), the
sampling tier (``ops/sampling_kernels.py``, ``serving/sampling``) and
``ContinuousBatchingEngine`` (``serving/fleet``), held to the behaviours
the JAX package's ``tests/test_paged_kv.py``, ``test_continuous.py`` and
``test_sampling.py`` hold its own to, and to the JAX package itself:
the same pool operations give the same tables, planes and counters; the
warps give the same distributions; the tiny transformer of
``test_paged_kv.py`` decodes the JAX engine's greedy tokens, token for
token, from the same weights.

Sampled draws differ from the JAX package's by design (Philox keyed by
(seed, counter, tag) where it folds jax.random keys), so sampling is
held to reproducibility per seed and to its target distribution.  The
step functions block on events instead of sleeping; every engine is
stopped in a ``finally`` and every result waits with a timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu.models import zoo
from paddle_tpu.ops import sampling_kernels as jax_sk
from paddle_tpu.serving import fleet as jax_fleet
from paddle_tpu.serving import kv as jax_kv
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.models import transformer as port_transformer
from paddle_tpu_torch.ops import registry as port_registry
from paddle_tpu_torch.ops import sampling_kernels as sk
from paddle_tpu_torch.serving import (DeadlineExceeded, EngineStopped,
                                      ServerOverloaded, ServingError)
from paddle_tpu_torch.serving.fleet import (ContinuousBatchingEngine,
                                            ContinuousConfig,
                                            PagedKVConfig,
                                            SpeculativeConfig,
                                            lockstep_decode,
                                            make_program_step_fn,
                                            make_program_verify_fn)
from paddle_tpu_torch.serving.kv import (KVBlockPool, PoolExhausted,
                                         accept_drafts,
                                         accept_drafts_sampled)
from paddle_tpu_torch.serving.sampling import (GREEDY, ConstraintError,
                                               SamplingConfig,
                                               SamplingConfigError,
                                               json_list_dfa)

V = 8
BOS, EOS = 2, 1
CHAIN = [(BOS + 1 + j - 2) % (V - 2) + 2 for j in range(64)]


@pytest.fixture(autouse=True)
def composed_jax_attention(monkeypatch):
    # the JAX side's attention runs its plain composed form, and compiles
    # its steps afresh (the persistent jit cache is shared by the test
    # workers; ROADMAP queue 3)
    monkeypatch.setitem(jax_flags._overrides, "force_attention_impl",
                        "composed")
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)


def _chain_step_fn(gate=None):
    """Deterministic markov toy: next = prev + 1 cycling over 2..V-1.
    With `gate`, each call first waits for the event (at most 30 s)."""
    def step_fn(prefix, lengths, ctx):
        if gate is not None:
            gate.wait(30)
        idx = (np.asarray(lengths) - 1).clip(0)
        prev = np.take_along_axis(np.asarray(prefix), idx[:, None],
                                  axis=1)[:, 0]
        nxt = np.where(prev + 1 >= V, BOS, prev + 1)
        logits = np.full((prefix.shape[0], V), -5.0, np.float32)
        logits[np.arange(prefix.shape[0]), nxt] = 2.0
        return logits
    return step_fn


def _eos_after(k):
    def step_fn(prefix, lengths, ctx):
        logits = _chain_step_fn()(prefix, lengths, ctx)
        hit = np.asarray(lengths) >= k + 1
        logits[hit] = -5.0
        logits[hit, EOS] = 2.0
        return logits
    return step_fn


def _noisy_step_fn(scale=1.5):
    """Pseudo-random logits, a pure function of (last token, length)."""
    def step_fn(prefix, lengths, ctx):
        n = prefix.shape[0]
        idx = (np.asarray(lengths) - 1).clip(0)
        prev = np.take_along_axis(np.asarray(prefix), idx[:, None],
                                  axis=1)[:, 0]
        logits = np.empty((n, V), np.float32)
        for i in range(n):
            rs = np.random.RandomState(
                (int(prev[i]) * 1000003 + int(lengths[i]) * 7919)
                % (2 ** 31))
            logits[i] = rs.randn(V).astype(np.float32) * scale
            logits[i, EOS] = -9.0
        return logits
    return step_fn


def _chain_verify_fn(base_step, k):
    def verify_fn(prefix, start, cur, ctx):
        S = prefix.shape[0]
        probe = base_step(prefix, np.asarray(start), ctx)
        out = np.zeros((S, k + 1) + probe.shape[1:], np.float32)
        out[:, 0] = probe
        for j in range(1, k + 1):
            out[:, j] = base_step(prefix, np.asarray(start) + j, ctx)
        return out
    return verify_fn


def _cfg(**kw):
    kw.setdefault("slots", 4)
    kw.setdefault("max_len", 32)
    kw.setdefault("bos_id", BOS)
    kw.setdefault("eos_id", EOS)
    return ContinuousConfig(**kw)


def _paged(**kw):
    return PagedKVConfig(**kw)


# ---------------------------------------------------------------------------
# the block-table pool
# ---------------------------------------------------------------------------

def _churn(kv, seed, steps=300):
    """Random admit/append/truncate/release churn on a pool of the JAX
    package (kv = its serving.kv) or the port; returns the pool and the
    live token lists, checking invariants and reads at every step."""
    rng = np.random.RandomState(seed)
    pool = kv.KVBlockPool(4, 6, kv.PagedKVConfig(
        block_size=4, num_blocks=21, value_spec={"k": ((2,), np.float32)}))
    live = {}
    for step in range(steps):
        op, s = rng.randint(0, 4), rng.randint(0, 4)
        if op == 0 and s not in live:
            toks = list(rng.randint(0, 50, rng.randint(1, 12)))
            vals = rng.standard_normal((len(toks), 2)).astype(np.float32)
            try:
                pool.admit(s, toks, values={"k": vals})
                live[s] = list(np.asarray(toks, np.int64))
            except kv.PoolExhausted:
                pass
        elif op == 1 and s in live and len(live[s]) < 23:
            t = int(rng.randint(0, 50))
            if pool.append(s, t, values={"k": np.full(2, t, np.float32)}):
                live[s].append(t)
        elif op == 2 and s in live and live[s]:
            n = rng.randint(1, len(live[s]) + 1)
            pool.truncate(s, n)
            live[s] = live[s][:n]
        elif op == 3 and s in live:
            pool.release(s)
            del live[s]
        pool.check_invariants()
        for s2, toks in live.items():
            assert list(pool.read_tokens(s2)) == toks, (step, s2)
    return pool, live


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_churn_refcounts_and_equals_jax_pool(seed):
    """Admit/append/truncate/release churn: the free list never hands
    out a live block, refcount 0 <=> free, reads stay exact — and the
    port's pool ends in the JAX package's pool's state: the same table,
    token and value planes, counters."""
    pool, live = _churn(pfluid.serving.kv, seed)
    jpool, jlive = _churn(jax_kv, seed)
    assert live == jlive
    np.testing.assert_array_equal(pool.table_view(), jpool.table_view())
    np.testing.assert_array_equal(pool.token_view(), jpool.token_view())
    np.testing.assert_array_equal(pool.arena("k"), jpool.arena("k"))
    assert pool.snapshot() == jpool.snapshot()
    for s in list(live):
        pool.release(s)
    pool.check_invariants()
    snap = pool.snapshot()
    assert snap["blocks_live"] == snap["blocks_cached"]
    c = snap["counters"]
    assert c["allocs"] == c["frees"] + snap["blocks_live"]


def test_cow_fork_preserves_read_values():
    pool = KVBlockPool(2, 4, _paged(block_size=4, num_blocks=9,
                                    value_spec={"k": ((2,), np.float32)}))
    vals = np.arange(12, dtype=np.float32).reshape(6, 2)
    pool.admit(0, [1, 2, 3, 4, 5, 6], values={"k": vals})
    pool.admit(1, [1, 2, 3, 4, 5, 6])
    assert pool.snapshot()["counters"]["prefix_hits"] == 2
    assert pool.append(0, 7, values={"k": np.array([9., 8.], np.float32)})
    assert pool.snapshot()["counters"]["cow_forks"] == 1
    assert list(pool.read_tokens(0)) == [1, 2, 3, 4, 5, 6, 7]
    assert list(pool.read_tokens(1)) == [1, 2, 3, 4, 5, 6]
    np.testing.assert_array_equal(pool.value_view("k")[1][:6], vals)
    np.testing.assert_array_equal(pool.value_view("k")[0][:6], vals)
    np.testing.assert_array_equal(pool.value_view("k")[0][6], [9., 8.])
    pool.check_invariants()


def test_shared_prefix_stores_blocks_once():
    pool = KVBlockPool(6, 8, _paged(block_size=4, num_blocks=41))
    prompt = list(range(10, 22))            # 3 full blocks
    for s in range(6):
        pool.admit(s, prompt)
    snap = pool.snapshot()
    assert snap["blocks_live"] == 3
    assert snap["counters"]["prefix_hits"] == 15
    for s in range(6):
        pool.release(s)
    pool.check_invariants()
    pool.admit(0, prompt)                    # served from the cache
    assert pool.snapshot()["counters"]["allocs"] == 3


def test_pool_exhaustion_is_typed_and_rolls_back():
    pool = KVBlockPool(2, 8, _paged(block_size=4, num_blocks=7,
                                    cache_prefixes=False))
    pool.admit(0, list(range(100, 112)))     # 3 blocks
    with pytest.raises(PoolExhausted, match="exhausted"):
        pool.admit(1, list(range(200, 216)))  # needs 4, 3 free
    pool.check_invariants()
    assert pool.live_blocks() == 3


@pytest.mark.parametrize("dtype", [np.int8, np.float16],
                         ids=["int8", "fp16"])
def test_value_plane_dtypes_cow_truncate_and_preemption(dtype):
    """COW copies every plane bytewise, truncate re-pads the private
    tail, and a release/re-admit cycle round-trips plane contents, at
    non-fp32 plane dtypes with an fp32 scale plane alongside."""
    pool = KVBlockPool(2, 4, _paged(
        block_size=4, num_blocks=9,
        value_spec={"k": ((2,), dtype), "k_scale": ((), np.float32)}))
    vals = np.arange(12).reshape(6, 2).astype(dtype)
    scales = (np.arange(6) * 0.25 + 0.25).astype(np.float32)
    pool.admit(0, [1, 2, 3, 4, 5, 6], values={"k": vals, "k_scale": scales})
    pool.admit(1, [1, 2, 3, 4, 5, 6])
    assert pool.arena("k").dtype == np.dtype(dtype)
    assert pool.append(0, 7, values={"k": np.array([9, 8]).astype(dtype),
                                     "k_scale": np.float32(0.5)})
    assert pool.snapshot()["counters"]["cow_forks"] == 1
    for s in (0, 1):
        np.testing.assert_array_equal(pool.value_view("k")[s][:6], vals)
    np.testing.assert_array_equal(pool.value_view("k")[0][6], [9, 8])
    np.testing.assert_array_equal(pool.value_view("k_scale")[0][:6], scales)
    pool.truncate(0, 5)
    np.testing.assert_array_equal(pool.value_view("k")[0][5:8], 0)
    np.testing.assert_array_equal(pool.value_view("k_scale")[0][5:8], 0)
    np.testing.assert_array_equal(pool.value_view("k")[1][:6], vals)
    # preemption: release slot 1, re-admit it with its grown prompt
    assert pool.append(1, 9, values={"k": np.array([4, 4]).astype(dtype)})
    row = pool.read_tokens(1)
    planes = pool.value_view("k")[1][:row.size].copy()
    pool.release(1)
    pool.check_invariants()
    np.testing.assert_array_equal(pool.value_view("k")[0][:5], vals[:5])
    pool.admit(1, row, values={"k": planes})
    np.testing.assert_array_equal(pool.value_view("k")[1][:row.size],
                                  planes)
    pool.check_invariants()


def test_kv_value_spec_int8_layout_equals_jax_arenas():
    """PagedKVConfig(kv_dtype="int8").kv_value_spec gives the quantized
    arena layout (int8 K/V, fp32 per-token scales), and rows written
    through the port's pool land in the same arenas and block table as
    through the JAX package's: the operands its paged-attention kernels
    gather."""
    from paddle_tpu.ops import quant_kernels as jax_qk

    h, d, n_tok = 2, 4, 6
    pools = []
    for kv in (pfluid.serving.kv, jax_kv):
        cfg = kv.PagedKVConfig(block_size=4, num_blocks=9,
                               cache_prefixes=False, kv_dtype="int8")
        spec = cfg.kv_value_spec(h, d)
        assert spec == {"k": ((h, d), "int8"), "v": ((h, d), "int8"),
                        "k_scale": ((), "float32"),
                        "v_scale": ((), "float32")}
        cfg.value_spec.update(spec)
        pools.append(kv.KVBlockPool(2, 4, cfg))
    assert pfluid.serving.kv.PagedKVConfig().kv_value_spec(h, d) == {
        "k": ((h, d), "float32"), "v": ((h, d), "float32")}
    rng = np.random.RandomState(0)
    kq, ks = map(np.asarray, jax_qk.quantize_kv(
        rng.randn(n_tok, h, d).astype(np.float32)))
    vq, vs = map(np.asarray, jax_qk.quantize_kv(
        rng.randn(n_tok, h, d).astype(np.float32)))
    for pool in pools:
        pool.admit(0, list(range(10, 10 + n_tok)),
                   values={"k": kq, "k_scale": ks, "v": vq, "v_scale": vs})
    port, ref = pools
    np.testing.assert_array_equal(port.table_view(), ref.table_view())
    for plane in ("k", "v", "k_scale", "v_scale"):
        assert port.arena(plane).dtype == ref.arena(plane).dtype
        np.testing.assert_array_equal(port.arena(plane), ref.arena(plane))


def test_export_ingest_round_trip_dedups_into_the_prefix_cache():
    """The disaggregated-serving hand-off: a slot exported block by
    block and ingested into another pool commits into its prefix cache,
    so a later admit of the same prompt hits every block."""
    src = KVBlockPool(2, 4, _paged(block_size=4, num_blocks=9,
                                   value_spec={"k": ((2,), np.float32)}))
    prompt = list(range(20, 30))
    vals = np.arange(20, dtype=np.float32).reshape(10, 2)
    src.admit(0, prompt, values={"k": vals})
    exp = src.export_slot(0)
    assert exp["n_tokens"] == 10 and exp["n_blocks"] == 3
    dst = KVBlockPool(2, 4, _paged(block_size=4, num_blocks=9,
                                   value_spec={"k": ((2,), np.float32)}))
    assert dst.begin_ingest("x1", exp["n_tokens"]) == 3
    for j in range(exp["n_blocks"]):
        fill = min(4, exp["n_tokens"] - 4 * j)
        for plane, data in exp["planes"].items():
            dst.ingest_block("x1", j, plane, data[j, :fill])
    assert dst.commit_ingest("x1") == (3, 0)
    dst.admit(1, prompt)
    assert dst.snapshot()["counters"]["prefix_hits"] == 3
    np.testing.assert_array_equal(dst.value_view("k")[1][:10], vals)
    assert dst.begin_ingest("x2", 5) == 2
    assert dst.abort_ingest("x2") == 2 and dst.abort_ingest("x2") == 0
    dst.check_invariants()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", [None, {"block_size": 4, "num_blocks": 13}],
                         ids=["dense", "paged"])
def test_mixed_budgets_retire_admit_midflight_and_match_lockstep(kv):
    budgets = (3, 10, 5, 2, 7, 4, 12, 2)
    step = _chain_step_fn()
    cfg = _cfg(kv=_paged(**kv) if kv else None)
    lock, _ = lockstep_decode(step, [([BOS], {}, n) for n in budgets], cfg)
    eng = ContinuousBatchingEngine(step, cfg)
    try:
        outs = [r.result(60) for r in
                [eng.submit([BOS], max_new_tokens=n) for n in budgets]]
        st = eng.stats()
    finally:
        eng.stop()
    for n, o, want in zip(budgets, outs, lock):
        assert list(o) == [BOS] + CHAIN[:n]
        np.testing.assert_array_equal(o, want)
    assert st["counters"]["completed"] == len(budgets)
    assert st["counters"]["admitted_midflight"] >= 1
    assert st["shape_signatures"] == 1
    assert st["tokens_per_step"] > 1.0
    if kv:
        assert st["kv"]["blocks_total"] == 12
        assert st["kv"]["counters"]["peak_live"] <= 12


def test_eos_prompt_prefix_and_oversized_prompts():
    eng = ContinuousBatchingEngine(_eos_after(3), _cfg())
    try:
        assert list(eng.decode([BOS], max_new_tokens=20)) == \
            [BOS, 3, 4, 5, EOS]
    finally:
        eng.stop()
    eng = ContinuousBatchingEngine(_chain_step_fn(), _cfg())
    try:
        assert list(eng.decode([BOS, 5, 6], max_new_tokens=2)) == \
            [BOS, 5, 6, 7, BOS]
        with pytest.raises(ServingError, match="no room"):
            eng.submit(np.arange(40) % V)
    finally:
        eng.stop()
    eng = ContinuousBatchingEngine(_chain_step_fn(), _cfg(
        slots=2, max_len=30, kv=_paged(block_size=4, num_blocks=5)))
    try:
        with pytest.raises(ServingError, match="KV blocks"):
            eng.submit(np.arange(2, 2 + 20) % V)
    finally:
        eng.stop()


def test_continuous_beats_lockstep_2x_on_mixed_lengths():
    cfg = _cfg(slots=4, max_len=32)
    budgets = [24, 2, 2, 2] * 4
    step = _chain_step_fn()
    _, lock_steps = lockstep_decode(step, [([BOS], {}, n)
                                           for n in budgets], cfg)
    eng = ContinuousBatchingEngine(step, cfg)
    try:
        for r in [eng.submit([BOS], max_new_tokens=n) for n in budgets]:
            r.result(60)
        steps = eng.stats()["counters"]["steps"]
    finally:
        eng.stop()
    assert lock_steps >= 2 * steps, (lock_steps, steps)


def _held_engine(**kw):
    """An engine whose one slot is held by a 'batch' request until the
    returned gate is set."""
    gate = threading.Event()
    eng = ContinuousBatchingEngine(_chain_step_fn(gate), _cfg(
        slots=1, max_len=64, **kw))
    blocker = eng.submit([BOS], max_new_tokens=3, sla="batch")
    deadline = time.monotonic() + 30
    while eng.stats()["active_slots"] == 0 and time.monotonic() < deadline:
        gate.wait(0.001)
    assert eng.stats()["active_slots"] == 1
    return eng, gate, blocker


def test_high_class_queue_jumps_batch():
    eng, gate, blocker = _held_engine()
    try:
        lows = [eng.submit([BOS], max_new_tokens=2, sla="batch")
                for _ in range(3)]
        hi = eng.submit([BOS], max_new_tokens=2, sla="high")
        order = []
        for name, r in [("hi", hi)] + [(f"low{i}", r)
                                       for i, r in enumerate(lows)]:
            r.add_done_callback(lambda _r, n=name: order.append(n))
        gate.set()
        for r in [blocker, hi] + lows:
            r.result(60)
        assert order[0] == "hi", order
    finally:
        gate.set()
        eng.stop()


def test_full_queue_sheds_lowest_priority():
    eng, gate, blocker = _held_engine(max_queue=2)
    try:
        lows = [eng.submit([BOS], max_new_tokens=2, sla="batch")
                for _ in range(2)]
        hi = eng.submit([BOS], max_new_tokens=2, sla="high")
        with pytest.raises(ServerOverloaded, match="shed for"):
            lows[1].result(5)
        gate.set()
        for r in (blocker, lows[0], hi):
            r.result(60)
        st = eng.stats()
        assert st["counters"]["shed_preempted"] == 1
        assert st["completed_by_class"]["high"] == 1
    finally:
        gate.set()
        eng.stop()


def test_deadline_mid_decode_frees_slot():
    """An expired sequence is cut at a token boundary and its slot goes
    to the next request; the step function waits out the deadline (an
    event wait bounded by the 5 ms timeout), nothing sleeps."""
    waited = threading.Event()
    chain = _chain_step_fn()

    def step_fn(prefix, lengths, ctx):
        if not waited.is_set():
            waited.wait(0.005)
            waited.set()
        return chain(prefix, lengths, ctx)

    eng = ContinuousBatchingEngine(step_fn, _cfg(slots=1, max_len=512))
    try:
        doomed = eng.submit([BOS], max_new_tokens=400, timeout_ms=1.0)
        nxt = eng.submit([BOS], max_new_tokens=2, timeout_ms=30000.0)
        with pytest.raises(DeadlineExceeded):
            doomed.result(30)
        assert len(nxt.result(60)) == 3
        st = eng.stats()
        assert st["counters"]["expired"] == 1
        assert st["counters"]["completed"] == 1
    finally:
        eng.stop()


def test_step_failure_resolves_typed_and_scheduler_survives():
    flaky = {"on": True}

    def step_fn(prefix, lengths, ctx):
        if flaky["on"]:
            raise RuntimeError("device hiccup")
        return _chain_step_fn()(prefix, lengths, ctx)

    eng = ContinuousBatchingEngine(step_fn, _cfg(
        kv=_paged(block_size=4, num_blocks=17, cache_prefixes=False)))
    try:
        bad = eng.submit([BOS], max_new_tokens=2)
        with pytest.raises(ServingError, match="decode step failed"):
            bad.result(30)
        assert eng._store.pool.snapshot()["blocks_live"] == 0
        flaky["on"] = False
        assert len(eng.decode([BOS], max_new_tokens=2)) == 3
        eng._store.pool.check_invariants()
    finally:
        eng.stop()


def test_context_validation_and_stop_drain():
    cfg = _cfg(context_spec={"src": ((3,), np.int64)})
    eng = ContinuousBatchingEngine(_chain_step_fn(), cfg)
    try:
        with pytest.raises(ServingError, match="missing context"):
            eng.submit([BOS], max_new_tokens=1)
        for bad, match in ((np.zeros(5, np.int64), "shape"),
                           (np.zeros((3, 1), np.int64), "shape"),
                           (np.zeros(3, np.float32), "src.*dtype"),
                           (np.array(["a", "b", "c"]), "src.*dtype")):
            with pytest.raises(ServingError, match=match):
                eng.submit([BOS], max_new_tokens=1, context={"src": bad})
        widened = eng.submit([BOS], max_new_tokens=1,
                             context={"src": np.zeros(3, np.int32)})
        assert len(widened.result(30)) == 2
        pending = [eng.submit([BOS], context={"src": np.zeros(3, np.int64)},
                              max_new_tokens=3) for _ in range(6)]
    finally:
        eng.stop()                    # drains: every accepted request ends
    assert all(len(r.result(30)) == 4 for r in pending)
    with pytest.raises(EngineStopped):
        eng.submit([BOS], context={"src": np.zeros(3, np.int64)})


def test_paged_preemption_preserves_generated_work():
    eng = ContinuousBatchingEngine(_chain_step_fn(), _cfg(
        slots=4, kv=_paged(block_size=4, num_blocks=11,
                           cache_prefixes=False)))
    try:
        budgets = (24, 24, 6, 6, 6)
        outs = [r.result(60) for r in
                [eng.submit([BOS], max_new_tokens=n) for n in budgets]]
        for n, o in zip(budgets, outs):
            assert list(o) == [BOS] + CHAIN[:n]
        st = eng.stats()
        assert st["counters"]["preempted_for_blocks"] >= 1
        assert st["shape_signatures"] == 1
        assert st["kv"]["blocks_live"] == st["kv"]["blocks_cached"]
    finally:
        eng.stop()


def test_sequence_outgrowing_pool_errors_typed_not_hangs():
    eng = ContinuousBatchingEngine(_chain_step_fn(), _cfg(
        slots=2, max_len=64, kv=_paged(block_size=4, num_blocks=9,
                                       cache_prefixes=False)))
    try:
        req = eng.submit([BOS], max_new_tokens=40)
        with pytest.raises(ServingError, match="exhausted the KV"):
            req.result(30)
        assert len(eng.decode([BOS], max_new_tokens=2)) == 3
        assert eng._store.pool.snapshot()["blocks_live"] == 0
        eng._store.pool.check_invariants()
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------

def test_accept_drafts_rule():
    v = np.full((4, 5), -1.0)
    v[0, 3] = v[1, 1] = v[2, 0] = v[3, 2] = 1.0   # targets 3,1,0,2
    assert accept_drafts([3, 1, 0], v) == (3, [3, 1, 0, 2])
    assert accept_drafts([3, 9, 0], v) == (1, [3, 1])
    assert accept_drafts([9, 9, 9], v) == (0, [3])
    assert accept_drafts([], v[:1]) == (0, [3])


@pytest.mark.parametrize("wrong_every,kv", [
    (0, None), (3, None), (1, None),
    (3, {"block_size": 4, "num_blocks": 15})],
    ids=["hopeless", "every-3rd", "every-1st", "every-3rd-paged"])
def test_speculative_parity_vs_plain_greedy(wrong_every, kv):
    step = _chain_step_fn()

    def draft(prefix, lengths, ctx):
        lg = step(prefix, lengths, ctx)
        if wrong_every:
            wrong = (np.asarray(lengths) % wrong_every) == 0
            lg[wrong] = np.roll(lg[wrong], 1, axis=-1)
        else:
            lg = np.roll(lg, 1, axis=-1)
        return lg

    spec = SpeculativeConfig(draft, _chain_verify_fn(step, 3), k=3)
    budgets = [10, 7, 3, 12, 2, 9]
    cfg = _cfg(kv=_paged(**kv) if kv else None)
    lock, _ = lockstep_decode(step, [([BOS], {}, n) for n in budgets], cfg)
    eng = ContinuousBatchingEngine(step, cfg, speculative=spec)
    try:
        outs = [r.result(60) for r in
                [eng.submit([BOS], max_new_tokens=n) for n in budgets]]
        st = eng.stats()
        if kv:
            eng._store.pool.check_invariants()
    finally:
        eng.stop()
    for a, b in zip(lock, outs):
        np.testing.assert_array_equal(a, b)
    sp = st["speculative"]
    assert sp["rounds"] == st["counters"]["steps"]
    if wrong_every == 3:
        assert 0.0 < sp["accept_rate"] < 1.0
    else:
        assert sp["accept_rate"] == 0.0
    if kv:
        assert st["kv"]["blocks_live"] == st["kv"]["blocks_cached"]


def test_speculative_eos_cut_inside_accepted_run():
    step = _eos_after(4)
    spec = SpeculativeConfig(step, _chain_verify_fn(step, 3), k=3)
    lock, _ = lockstep_decode(step, [([BOS], {}, 20)], _cfg())
    eng = ContinuousBatchingEngine(step, _cfg(), speculative=spec)
    try:
        out = eng.decode([BOS], max_new_tokens=20)
    finally:
        eng.stop()
    np.testing.assert_array_equal(lock[0], out)
    assert out[-1] == EOS


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,field", [
    ({"temperature": -0.5}, "temperature"),
    ({"temperature": float("nan")}, "temperature"),
    ({"top_p": 0.0}, "top_p"), ({"top_p": 1.5}, "top_p"),
    ({"top_k": -3}, "top_k"), ({"seed": 1.5}, "seed"),
    ({"logit_bias": {-1: 2.0}}, "logit_bias"),
    ({"constraint": object()}, "constraint")])
def test_sampling_config_validation_named_errors(kwargs, field):
    with pytest.raises(SamplingConfigError, match=field):
        SamplingConfig(**kwargs)
    eng = ContinuousBatchingEngine(_chain_step_fn(), _cfg())
    try:
        with pytest.raises(SamplingConfigError, match=field):
            eng.submit([BOS], max_new_tokens=2, sampling=kwargs)
        assert len(eng.decode([BOS], max_new_tokens=2)) == 3
    finally:
        eng.stop()


def test_sampling_config_coerce_and_greedy():
    assert SamplingConfig.coerce(None) is GREEDY and GREEDY.plain_greedy()
    c = SamplingConfig.coerce({"temperature": 0.7, "seed": 3})
    assert isinstance(c, SamplingConfig) and not c.plain_greedy()
    assert SamplingConfig.coerce(c) is c
    with pytest.raises(SamplingConfigError):
        SamplingConfig.coerce({"not_a_field": 1})


WARPS = [
    ("greedy", [0.0, 0.0], [0, 0], [1.0, 1.0], False),
    ("temperature", [0.5, 4.0], [0, 0], [1.0, 1.0], False),
    ("top_k", [1.0, 0.8], [2, 5], [1.0, 1.0], False),
    ("top_p", [1.0, 0.8], [0, 0], [0.7, 0.1], False),
    ("mixed", [0.0, 0.8], [3, 5], [0.9, 0.9], False),
    ("bias", [1.0, 0.0], [0, 0], [1.0, 1.0], True),
]


@pytest.mark.parametrize("name,temp,top_k,top_p,bias", WARPS,
                         ids=[w[0] for w in WARPS])
def test_warp_probs_match_jax(name, temp, top_k, top_p, bias):
    """Each warp (greedy one-hot at the biased argmax, temperature,
    top-k by rank, top-p nucleus keeping the top token, -inf bias
    masks) gives the JAX package's distribution, and the host row warp
    equals the plane's row."""
    rng = np.random.RandomState(len(name))
    logits = rng.randn(2, 11).astype(np.float32) * 2
    b = None
    if bias:
        b = np.zeros((2, 11), np.float32)
        b[:, ::2] = -np.inf
        b[1, 3] = 5.0
    args = (np.asarray(temp, np.float32), np.asarray(top_k, np.int32),
            np.asarray(top_p, np.float32))
    want = np.asarray(jax_sk.warp_probs(logits, *args, bias=b))
    got = sk.warp_probs(torch.from_numpy(logits), *args,
                        bias=None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)
    for i in range(2):
        host = sk.host_warp(logits[i], temp[i], top_k[i], top_p[i],
                            bias=None if b is None else b[i])
        np.testing.assert_allclose(host, got[i].numpy(), atol=1e-6)


def _chi2_ok(counts, probs, n):
    """Pearson's chi-square of `counts` against `probs` over the cells
    with probability > 0, below the 0.999 quantile for its degrees of
    freedom (Wilson-Hilferty), and no count in a zero cell."""
    probs = np.asarray(probs, np.float64)
    live = probs > 0
    assert counts[~live].sum() == 0
    e = probs[live] * n
    chi2 = float(((counts[live] - e) ** 2 / e).sum())
    k = int(live.sum()) - 1
    bound = k * (1 - 2 / (9 * k) + 3.09 * np.sqrt(2 / (9 * k))) ** 3
    return chi2 < bound, chi2, bound


def test_sample_step_follows_the_warped_distribution():
    """4000 seeded draws over a [4, V] plane follow the warped target
    (chi-square at 0.999); the same (seed, counter) gives the same
    token; the uniforms are exact float32 in [0, 1)."""
    logits = np.tile(np.asarray([2.0, 1.0, 0.5, -1.0, 0.0, 1.5, -3.0, 0.3],
                                np.float32), (4, 1))
    temp = np.asarray([1.0, 1.0, 0.8, 1.0], np.float32)
    top_k = np.asarray([0, 0, 0, 4], np.int64)
    top_p = np.asarray([1.0, 0.9, 1.0, 1.0], np.float32)
    n = 1000
    counts = np.zeros((4, V))
    for c in range(n):
        toks, probs = sk.sample_step(logits, temp, top_k, top_p,
                                     np.arange(4) + 17, np.full(4, c))
        counts[np.arange(4), toks] += 1
    for i in range(4):
        ok, chi2, bound = _chi2_ok(counts[i], probs[i], n)
        assert ok, (i, chi2, bound)
    again, _ = sk.sample_step(logits, temp, top_k, top_p,
                              np.arange(4) + 17, np.full(4, 7))
    first, _ = sk.sample_step(logits, temp, top_k, top_p,
                              np.arange(4) + 17, np.full(4, 7))
    np.testing.assert_array_equal(again, first)
    u = sk.row_uniforms(np.arange(4096), np.zeros(4096), sk.TAG_DRAW)
    assert u.dtype == torch.float32 and 0 <= u.min() and u.max() < 1
    assert abs(u.mean().item() - 0.5) < 4 * np.sqrt(1 / 12 / 4096)
    seeds = np.random.RandomState(5).randint(0, 2**31, 64)
    counters = seeds[::-1] % 1000
    for tag in (sk.TAG_DRAW, sk.TAG_ACCEPT):
        rows = sk.row_uniforms(seeds, counters, tag)
        assert [sk.host_uniform(s, c, tag) for s, c in
                zip(seeds, counters)] == rows.tolist()


def test_sampling_decode_op_is_pure_in_its_feeds():
    rng = np.random.RandomState(3)
    ins = {"Logits": [torch.from_numpy(rng.randn(3, V).astype(np.float32))],
           "Temperature": [torch.tensor([0.0, 1.0, 0.7])],
           "TopK": [torch.tensor([0, 0, 3], dtype=torch.int32)],
           "TopP": [torch.tensor([1.0, 0.9, 1.0])],
           "Seed": [torch.tensor([1, 2, 3])],
           "Counter": [torch.tensor([0, 5, 9])]}
    a = port_registry.run_op("sampling_decode", ins, {})
    b = port_registry.run_op("sampling_decode", ins, {})
    assert torch.equal(a["Out"][0], b["Out"][0])
    assert a["Out"][0].dtype == torch.int32
    assert int(a["Out"][0][0]) == int(ins["Logits"][0][0].argmax())
    toks, probs = sk.sample_step(
        ins["Logits"][0].numpy(), [0.0, 1.0, 0.7], [0, 0, 3],
        [1.0, 0.9, 1.0], [1, 2, 3], [0, 5, 9])
    np.testing.assert_array_equal(toks, a["Out"][0].numpy())
    np.testing.assert_allclose(probs, a["Probs"][0].numpy())
    assert not port_registry.is_differentiable("sampling_decode")


def test_token_dfa_parses_and_rejects_typed():
    dfa = json_list_dfa(open_id=2, close_id=3, comma_id=4,
                        value_ids=(5, 6), eos_id=EOS, max_items=3)
    rng = np.random.RandomState(0)
    for _ in range(50):
        state, toks = dfa.start(), []
        while True:
            allowed = list(dfa.allowed(state, V))
            t = int(allowed[rng.randint(len(allowed))])
            if t == EOS:
                break
            toks.append(t)
            state = dfa.advance(state, t)
        assert dfa.accepts(toks), toks
    with pytest.raises(ConstraintError):
        dfa.advance(dfa.start(), 5)


def test_mixed_tenants_one_shape_seeds_bias_and_greedy_parity():
    """Greedy, sampled and constrained tenants share one slot pool: one
    step shape, one sampler plane, greedy tokens equal an all-greedy
    run; a seed reproduces its tokens and another seed diverges; a
    logit bias forces or forbids tokens."""
    step = _noisy_step_fn()
    dfa = json_list_dfa(open_id=2, close_id=3, comma_id=4,
                        value_ids=(5, 6, 7), eos_id=EOS, max_items=3)
    eng = ContinuousBatchingEngine(step, _cfg())
    try:
        greedy_alone = eng.decode([BOS], max_new_tokens=6)
        mixes = [None, {"temperature": 0.9, "top_k": 6, "seed": 11},
                 {"temperature": 0.8, "top_p": 0.9, "seed": 12},
                 {"temperature": 0.7, "seed": 13, "constraint": dfa}]
        outs = [r.result(60) for r in
                [eng.submit([BOS], max_new_tokens=6, sampling=s)
                 for s in mixes]]
        np.testing.assert_array_equal(outs[0], greedy_alone)
        state = dfa.start()
        for t in [int(t) for t in outs[3][1:]]:
            if t == EOS:
                break
            state = dfa.advance(state, t)
        s = {"temperature": 1.0, "seed": 99}
        a = eng.decode([BOS], max_new_tokens=12, sampling=dict(s))
        b = eng.decode([BOS], max_new_tokens=12, sampling=dict(s))
        c = eng.decode([BOS], max_new_tokens=12,
                       sampling={"temperature": 1.0, "seed": 100})
        forced = eng.decode([BOS], max_new_tokens=8, sampling={
            "temperature": 1.0, "seed": 5, "logit_bias": {4: 30.0}})
        only6 = eng.decode([BOS], max_new_tokens=8, sampling={
            "temperature": 1.0, "seed": 5,
            "logit_bias": {t: -np.inf for t in range(V) if t != 6}})
        st = eng.stats()
    finally:
        eng.stop()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert set(int(t) for t in forced[1:]) == {4}
    assert set(int(t) for t in only6[1:]) == {6}
    assert st["shape_signatures"] == 1
    assert st["sampling"]["sampler_shapes"] == 1
    assert st["counters"]["sampled_tokens"] > 0
    assert st["counters"]["constrained_tokens"] > 0


def test_preempted_sampled_request_is_bit_reproducible():
    step = _noisy_step_fn()
    scfg = {"temperature": 1.0, "seed": 424242}
    kv = dict(block_size=4, num_blocks=11, cache_prefixes=False)
    ref_eng = ContinuousBatchingEngine(step, _cfg(kv=_paged(**kv)))
    try:
        ref = ref_eng.decode([BOS], max_new_tokens=24, sampling=dict(scfg))
    finally:
        ref_eng.stop()
    eng = ContinuousBatchingEngine(step, _cfg(kv=_paged(**kv)))
    try:
        outs = [r.result(60) for r in
                [eng.submit([BOS], max_new_tokens=n, sampling=dict(scfg))
                 for n in (24, 24, 6, 6, 6)]]
        st = eng.stats()
    finally:
        eng.stop()
    assert st["counters"]["preempted_for_blocks"] >= 1
    np.testing.assert_array_equal(outs[0], ref)
    np.testing.assert_array_equal(outs[1], ref)
    assert st["shape_signatures"] == 1


def test_adjusted_rule_degenerates_to_greedy_equality():
    rng = np.random.RandomState(3)
    for trial in range(50):
        m = rng.randint(1, 5)
        vlogits = rng.randn(m + 1, V).astype(np.float32)
        drafts = [int(rng.randint(V)) for _ in range(m)]
        qrows = [np.eye(V, dtype=np.float32)[d] for d in drafts]
        assert accept_drafts_sampled(drafts, qrows, vlogits,
                                     SamplingConfig(), base_counter=trial) \
            == accept_drafts(drafts, vlogits)


def test_adjusted_rule_matches_its_target_distribution():
    """Leviathan et al.: speculative sampling commits tokens from the
    target distribution whatever the draft.  Over 3000 seeds the first
    committed token follows the target (chi-square at 0.999), and the
    imperfect draft is both accepted and rejected."""
    rng = np.random.RandomState(0)
    tlogits = rng.randn(2, V).astype(np.float32)
    dlogits = tlogits[0] + rng.randn(V).astype(np.float32)
    p = sk.host_warp(tlogits[0], temperature=1.0)
    q = sk.host_warp(dlogits, temperature=1.0)
    n = 3000
    counts = np.zeros(V)
    accepted = 0
    for seed in range(n):
        cfg = SamplingConfig(temperature=1.0, seed=seed)
        d = sk.host_draw(q, seed, 0, sk.TAG_DRAFT)
        acc, toks = accept_drafts_sampled([d], [q], tlogits, cfg,
                                          base_counter=0)
        counts[int(toks[0])] += 1
        accepted += acc
    ok, chi2, bound = _chi2_ok(counts, p, n)
    assert ok, (chi2, bound)
    assert 0.05 < accepted / n < 0.95


def test_speculative_sampled_reproducible_and_greedy_mates_exact():
    step = _noisy_step_fn()

    def draft(prefix, lengths, ctx):
        return np.roll(step(prefix, lengths, ctx), 1, axis=-1)

    spec = SpeculativeConfig(draft, _chain_verify_fn(step, 3), k=3)
    eng = ContinuousBatchingEngine(step, _cfg(), speculative=spec)
    try:
        a = eng.decode([BOS], max_new_tokens=10,
                       sampling={"temperature": 1.0, "seed": 77})
        b = eng.decode([BOS], max_new_tokens=10,
                       sampling={"temperature": 1.0, "seed": 77})
        st = eng.stats()
    finally:
        eng.stop()
    np.testing.assert_array_equal(a, b)
    assert len(a) == 11 and st["counters"]["residual_resamples"] >= 1
    chain = _chain_step_fn()
    spec = SpeculativeConfig(chain, _chain_verify_fn(chain, 3), k=3)
    eng = ContinuousBatchingEngine(chain, _cfg(), speculative=spec)
    try:
        rs = [eng.submit([BOS], max_new_tokens=9),
              eng.submit([BOS], max_new_tokens=9,
                         sampling={"temperature": 1.0, "seed": 8}),
              eng.submit([BOS], max_new_tokens=9)]
        outs = [r.result(60) for r in rs]
    finally:
        eng.stop()
    assert list(outs[0]) == list(outs[2]) == [BOS] + CHAIN[:9]


# ---------------------------------------------------------------------------
# the transformer program path, against the JAX package's engine
# ---------------------------------------------------------------------------

VV, TS, SLOTS, L, H = 12, 5, 4, 16, 2


def _tiny_transformer(pkg):
    fluid, tr, init, names = (
        (jfluid, jax_transformer, jax_init, jax_unique_name) if pkg == "jax"
        else (pfluid, port_transformer, port_init, port_unique_name))
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    with names.guard(), fluid.program_guard(main, startup):
        _cost, predict, _ = tr.transformer(
            src_vocab_size=VV, trg_vocab_size=VV, max_length=16,
            n_layer=1, n_head=H, d_key=8, d_value=8, d_model=16,
            d_inner_hid=32, dropout_rate=0.0)
    return main, startup, predict


def _feed_builder(prefix, lengths, context):
    n = prefix.shape[0]
    sb, tb, cb = port_transformer.make_attn_biases(
        [TS] * n, [int(t) for t in lengths], H, TS, L)
    return {"src_word": context["src"],
            "src_pos": np.tile(np.arange(TS), (n, 1)).astype(np.int64),
            "trg_word": np.asarray(prefix)[:, :L],
            "trg_pos": np.tile(np.arange(L), (n, 1)).astype(np.int64),
            "src_slf_attn_bias": sb, "trg_slf_attn_bias": tb,
            "trg_src_attn_bias": cb,
            "lbl_word": np.zeros((n, L, 1), np.int64),
            "lbl_weight": np.zeros((n, L, 1), np.float32)}


def test_transformer_decode_matches_jax_engine_tokens():
    """From the JAX package's startup state, the port's paged engine
    (shared system prompt, prefix cache, speculative verify with the
    target as its own draft) decodes the JAX engine's greedy tokens,
    token for token, with one step shape, accept rate 1.0 and no block
    left after the drain."""
    jmain, jstart, jpredict = _tiny_transformer("jax")
    zp = zoo.ZooProgram("tiny", jmain, jstart, {}, [])
    state = zoo.snapshot_startup(zp)
    rng = np.random.RandomState(0)
    shared = rng.randint(2, VV, (TS,)).astype(np.int64)
    srcs = [shared] * 3 + [rng.randint(2, VV, (TS,)).astype(np.int64)
                           for _ in range(4)]
    budgets = [6, 2, 4, 3, 5, 2, 7]
    sys_prompt = [0, 3, 4, 5, 6]
    kv = dict(block_size=4, num_blocks=13)

    jexe = jfluid.Executor()
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        for n, v in state.items():
            jscope.set_var(n, np.array(v, copy=True))
        jstep = jax_fleet.make_program_step_fn(
            jexe, jmain.clone(for_test=True), jpredict, _feed_builder)
        jcfg = jax_fleet.ContinuousConfig(
            slots=SLOTS, max_len=L, bos_id=0, eos_id=1,
            context_spec={"src": ((TS,), np.int64)},
            kv=jax_fleet.PagedKVConfig(**kv))
        jeng = jax_fleet.ContinuousBatchingEngine(jstep, jcfg)
        try:
            want = [r.result(120) for r in
                    [jeng.submit(sys_prompt, context={"src": s},
                                 max_new_tokens=n)
                     for s, n in zip(srcs, budgets)]]
        finally:
            jeng.stop()

    pmain, _, ppredict = _tiny_transformer("port")
    scope = pfluid.io.state_from_numpy(state, scope=pfluid.Scope(),
                                       place=pfluid.CPUPlace(),
                                       main_program=pmain)
    exe = pfluid.Executor(pfluid.CPUPlace())
    infer = pmain.clone(for_test=True)
    with pfluid.scope_guard(scope):
        step = make_program_step_fn(exe, infer, ppredict, _feed_builder)
        verify = make_program_verify_fn(exe, infer, ppredict,
                                        _feed_builder, k=2)
        cfg = ContinuousConfig(
            slots=SLOTS, max_len=L, bos_id=0, eos_id=1,
            context_spec={"src": ((TS,), np.int64)}, kv=_paged(**kv))
        lock, _ = lockstep_decode(
            step, [(sys_prompt, {"src": s}, n)
                   for s, n in zip(srcs, budgets)], cfg)
        for speculative in (None, SpeculativeConfig(step, verify, k=2)):
            eng = ContinuousBatchingEngine(step, cfg,
                                           speculative=speculative)
            try:
                got = [r.result(120) for r in
                       [eng.submit(sys_prompt, context={"src": s},
                                   max_new_tokens=n)
                        for s, n in zip(srcs, budgets)]]
                st = eng.stats()
                eng._store.pool.check_invariants()
            finally:
                eng.stop()
            for g, w, lk in zip(got, want, lock):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, lk)
            assert st["shape_signatures"] == 1
            assert st["kv"]["counters"]["prefix_hits"] >= 1
            assert st["kv"]["blocks_live"] == st["kv"]["blocks_cached"]
            if speculative is not None:
                assert st["speculative"]["accept_rate"] == 1.0
