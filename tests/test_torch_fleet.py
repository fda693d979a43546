"""The port's multi-replica serving tier (``serving/fleet/router.py``,
``replica.py``) and fault plans (``resilience/faults.py``), held to the
behaviours the JAX package's ``tests/test_fleet.py`` holds its own to:
least-outstanding-work dispatch, per-replica circuit-breaker health,
failover keeping SLA-high traffic lossless while a replica is dark,
half-open recovery, SLA-class admission, warmup-gated multi-model
hosting, the stats()-consistency regression and the FaultRule ``after``
extension.  ``test_fleet_wide_hot_swap_under_traffic`` is not run: it
needs the ServingEngine's warm weight reload, which the port does not
have yet (``swap_weights`` raises, tested here).  Also the JAX package's
``test_sampling.py::test_router_submit_decode_dispatch_and_validation``
and the FaultPlan-killed decode steps of ``test_paged_kv.py`` and
``test_sampling.py``.

Models run on the CPU (``AnalysisConfig.disable_gpu()``); every result
and join waits at most 30 s; every router, replica and engine stops in a
``finally``.
"""

import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name
from paddle_tpu_torch.observability import REGISTRY
from paddle_tpu_torch.resilience import FaultPlan as LazyFaultPlan
from paddle_tpu_torch.resilience.breaker import CircuitBreaker
from paddle_tpu_torch.resilience.faults import FaultPlan, FaultRule
from paddle_tpu_torch.serving import (MicroBatcher, ServerOverloaded,
                                      ServingConfig, ServingError,
                                      ServingMetrics)
from paddle_tpu_torch.serving.fleet import (AdmissionPolicy,
                                            ContinuousBatchingEngine,
                                            ContinuousConfig, FleetConfig,
                                            FleetRouter, ModelNotRoutable,
                                            NoReplicaAvailable,
                                            PagedKVConfig, Replica,
                                            ReplicaRemoved,
                                            SamplingConfigError, SlaClass)

WAIT_S = 30
V = 8
BOS, EOS = 2, 1


def _export_model(tmpdir, feat=8):
    """Save a small named-weight MLP inference model; returns dir.  Built
    under a fresh name generator, so the names later tests draw from the
    port's default one do not depend on this test having run."""
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[feat],
                                dtype="float32")
        h = fluid.layers.fc(img, size=16, act="relu",
                            param_attr=fluid.ParamAttr(name="fw"),
                            bias_attr=fluid.ParamAttr(name="fb"))
        pred = fluid.layers.fc(h, size=4, act=None,
                               param_attr=fluid.ParamAttr(name="pw"),
                               bias_attr=fluid.ParamAttr(name="pb"))
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        fluid.io.save_inference_model(tmpdir, ["img"], [pred], exe,
                                      main_program=main)
    return tmpdir


def _predictor(d):
    cfg = fluid.AnalysisConfig(d)
    cfg.disable_gpu()
    return fluid.create_paddle_predictor(cfg)


def _replica(name, d, plan=None, **cfg):
    cfg.setdefault("max_batch_size", 4)
    cfg.setdefault("max_wait_ms", 1.0)
    r = Replica(name, fault_plan=plan)
    r.add_model("mlp", _predictor(d), ServingConfig(**cfg))
    return r


def _fleet(d, n=3, plan_for=None, plan=None, **fc):
    fc.setdefault("max_outstanding", 256)
    fc.setdefault("breaker_failures", 2)
    fc.setdefault("breaker_reset_s", 0.3)
    router = FleetRouter(FleetConfig(**fc))
    try:
        for i in range(n):
            name = f"r{i}"
            router.add_replica(_replica(
                name, d, plan=plan if name == plan_for else None))
    except BaseException:
        router.stop()
        raise
    return router


def _clients(router, x, n, errs, lock, done=None):
    def client(_i):
        try:
            out = router.predict("mlp", {"img": x}, sla="high",
                                 result_timeout_s=WAIT_S)
            if done is not None:
                with lock:
                    done.append(out)
        except Exception as e:        # noqa: BLE001 — recorded
            with lock:
                errs.append(e)

    ts = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT_S)


# ---- admission policy / SLA classes ----

def test_admission_policy_shares_and_resolution():
    pol = AdmissionPolicy()
    high, batch = pol.resolve("high"), pol.resolve("batch")
    assert high.priority > batch.priority
    assert pol.names_by_priority()[0] == "high"
    budget = 100
    assert not pol.admit(batch, 75, budget)
    assert pol.admit(high, 75, budget)
    assert not pol.admit(high, 100, budget)
    with pytest.raises(KeyError, match="unknown SLA class"):
        pol.resolve("bogus")
    with pytest.raises(ValueError, match="share"):
        SlaClass("x", share=0.0)


def test_microbatcher_priority_queue_jump_and_preemption():
    """A higher-priority submit jumps the queue, and on a full queue
    sheds the newest lowest-priority entry instead of itself (FIFO
    preserved within a priority level)."""
    m = ServingMetrics()
    b = MicroBatcher(max_batch_size=1, max_wait_ms=0.0,
                     max_queue_size=3, metrics=m)
    feed = {"x": np.zeros((1, 2), np.float32)}
    lows = [b.submit(feed, "k", 1, priority=0) for _ in range(3)]
    hi = b.submit(feed, "k", 1, priority=10)
    assert lows[2].done()
    with pytest.raises(ServerOverloaded, match="shed for a priority"):
        lows[2].result(0)
    assert m.get("shed_preempted") == 1
    assert m.get("submitted") == 4
    order = [b.next_batch(0.05)[0] for _ in range(3)]
    assert order == [hi, lows[0], lows[1]]
    b2 = MicroBatcher(1, 0.0, 1, metrics=ServingMetrics())
    b2.submit(feed, "k", 1, priority=5)
    with pytest.raises(ServerOverloaded, match="queue full"):
        b2.submit(feed, "k", 1, priority=5)


# ---- router dispatch ----

def test_router_spreads_load_least_outstanding(tmp_path):
    """A concurrent burst lands on more than one replica and every
    request completes, with the accounting drained."""
    d = _export_model(str(tmp_path))
    router = _fleet(d, n=3)
    try:
        x = np.random.RandomState(0).rand(1, 8).astype(np.float32)
        errs, done = [], []
        _clients(router, x, 48, errs, threading.Lock(), done)
        assert not errs and len(done) == 48
        st = router.stats()
        assert st["classes"]["high"]["counters"]["completed"] == 48
        assert st["classes"]["high"]["counters"]["dropped"] == 0
        per_replica = [
            st["replicas"][r]["models"]["mlp"]["engine"]["counters"]
            ["completed"] for r in ("r0", "r1", "r2")]
        assert sum(per_replica) == 48
        assert sum(1 for c in per_replica if c > 0) >= 2, per_replica
        assert st["outstanding"] == 0
    finally:
        router.stop()


def test_unknown_model_and_class_are_typed(tmp_path):
    d = _export_model(str(tmp_path))
    router = _fleet(d, n=1)
    try:
        x = np.zeros((1, 8), np.float32)
        with pytest.raises(ModelNotRoutable, match="no replica serves"):
            router.submit("bogus_model", {"img": x})
        with pytest.raises(KeyError, match="unknown SLA class"):
            router.submit("mlp", {"img": x}, sla="gold")
    finally:
        router.stop()


def test_sla_budget_sheds_batch_before_high(tmp_path):
    """With the fleet's in-flight budget nearly full, batch-class submits
    shed at admission while high-class submits still land."""
    d = _export_model(str(tmp_path))
    router = _fleet(d, n=1, max_outstanding=8)
    eng = router._replicas["r0"]._models["mlp"].engine
    gate = threading.Event()
    real_call = eng._handle.call

    def gated(compiled, feeds):
        gate.wait(WAIT_S)
        return real_call(compiled, feeds)

    eng._handle.call = gated
    try:
        x = np.zeros((1, 8), np.float32)
        held = [router.submit("mlp", {"img": x}, sla="batch")
                for _ in range(6)]          # 6 >= 8 * batch share 0.75
        with pytest.raises(ServerOverloaded, match="class 'batch'"):
            router.submit("mlp", {"img": x}, sla="batch")
        hi = router.submit("mlp", {"img": x}, sla="high")
        gate.set()
        for r in held + [hi]:
            r.result(WAIT_S)
        st = router.stats()
        assert st["classes"]["batch"]["counters"]["shed_admission"] == 1
        assert st["classes"]["batch"]["counters"]["completed"] == 6
        assert st["classes"]["high"]["counters"]["dropped"] == 0
    finally:
        gate.set()
        router.stop()


# ---- replica death / degrade / recovery ----

@pytest.mark.chaos
def test_dead_replica_sheds_to_siblings_and_recovers(tmp_path):
    """FaultPlan kills replica r1 at its 2nd dispatch (dark for the next
    10): the breaker trips, zero high-class requests drop (failover),
    and after the reset window the half-open probe closes the circuit
    and r1 serves again."""
    d = _export_model(str(tmp_path))
    plan = FaultPlan(seed=3).error("replica:r1:*", after=1, times=10,
                                   message="replica r1 killed")
    router = _fleet(d, n=3, plan_for="r1", plan=plan,
                    breaker_failures=2, breaker_reset_s=0.25)
    try:
        x = np.random.RandomState(1).rand(1, 8).astype(np.float32)
        errs, lock = [], threading.Lock()
        _clients(router, x, 64, errs, lock)
        st = router.stats()
        assert not errs, errs
        assert st["classes"]["high"]["counters"]["dropped"] == 0
        assert st["classes"]["high"]["counters"]["completed"] == 64
        assert st["counters"]["dispatch_errors"] >= 2
        assert st["replicas"]["r1"]["breaker"]["trips"] >= 1
        assert st["counters"]["failovers"] >= 1
        deadline = time.time() + 15
        recovered = False
        while time.time() < deadline:
            time.sleep(0.1)
            router.predict("mlp", {"img": x}, sla="high",
                           result_timeout_s=WAIT_S)
            if router.stats()["replicas"]["r1"]["breaker"]["state"] \
                    == "closed":
                recovered = True
                break
        assert recovered, router.stats()["replicas"]["r1"]
        before = router.stats()["replicas"]["r1"]["models"]["mlp"][
            "engine"]["counters"]["completed"]
        _clients(router, x, 24, errs, lock)
        assert not errs, errs
        after = router.stats()["replicas"]["r1"]["models"]["mlp"][
            "engine"]["counters"]["completed"]
        assert after > before
    finally:
        router.stop()


def test_remove_replica_fails_orphans_typed(tmp_path):
    """remove_replica resolves every future still in flight on the
    removed replica with ReplicaRemoved; with every replica gone a
    submit is unroutable."""
    d = _export_model(str(tmp_path))
    router = _fleet(d, n=1)
    eng = router._replicas["r0"]._models["mlp"].engine
    gate = threading.Event()
    real_call = eng._handle.call

    def gated(compiled, feeds):
        gate.wait(WAIT_S)
        return real_call(compiled, feeds)

    eng._handle.call = gated
    r0 = router.get_replica("r0")
    try:
        x = np.zeros((1, 8), np.float32)
        reqs = [router.submit("mlp", {"img": x}) for _ in range(3)]
        assert router.remove_replica("r0") == 3
        for r in reqs:
            with pytest.raises(ReplicaRemoved):
                r.result(WAIT_S)
        assert router.replicas() == []
        with pytest.raises(ModelNotRoutable):
            router.submit("mlp", {"img": x})
    finally:
        gate.set()
        r0.stop()
        router.stop()


# ---- multi-model hosting ----

def test_multi_model_hosting_warmup_gate(tmp_path):
    d1 = _export_model(str(tmp_path / "m1"), feat=8)
    d2 = _export_model(str(tmp_path / "m2"), feat=6)
    r = Replica("r0")
    cfg = ServingConfig(max_batch_size=4, max_wait_ms=1.0)
    try:
        built = r.add_model("a", _predictor(d1), cfg)
        assert built == len(r._models["a"].engine._batch_buckets)
        r.add_model("b", _predictor(d2),
                    ServingConfig(max_batch_size=4, max_wait_ms=1.0))
        assert r.models() == ["a", "b"]
        (out_a,) = r.submit(
            "a", {"img": np.zeros((1, 8), np.float32)}).result(WAIT_S)
        (out_b,) = r.submit(
            "b", {"img": np.zeros((1, 6), np.float32)}).result(WAIT_S)
        assert out_a.shape == (1, 4) and out_b.shape == (1, 4)
        with pytest.raises(ModelNotRoutable):
            r.submit("c", {"img": np.zeros((1, 8), np.float32)})
        with pytest.raises(ValueError, match="already hosts"):
            r.add_model("a", _predictor(d1), cfg)
        st = r.stats()
        assert st["models"]["a"]["warmup_built"] == built
        assert st["models"]["a"]["engine"]["cache_size"] == built
    finally:
        r.stop()


def test_add_model_race_orphans_no_engine(tmp_path):
    """Two threads racing add_model on one name: exactly one wins, the
    losers get the typed ValueError before building an engine, so no
    orphaned worker thread survives stop()."""
    d = _export_model(str(tmp_path))
    r = Replica("r0")
    results = []
    lock = threading.Lock()
    preds = [_predictor(d) for _ in range(4)]

    def adder(p):
        try:
            r.add_model("m", p, ServingConfig(max_batch_size=4,
                                              max_wait_ms=1.0))
            with lock:
                results.append("ok")
        except ValueError as e:
            with lock:
                results.append(str(e))

    ts = [threading.Thread(target=adder, args=(p,)) for p in preds]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT_S)
        assert len(results) == 4 and results.count("ok") == 1, results
        assert all("already hosts" in x for x in results if x != "ok")
        (out,) = r.submit("m", {"img": np.zeros((1, 8), np.float32)}) \
            .result(WAIT_S)
        assert out.shape == (1, 4)
    finally:
        r.stop()
    assert not [t for t in threading.enumerate()
                if t.name == "serving-worker" and t.is_alive()]


def test_swap_weights_raises_until_warm_reload(tmp_path):
    """The reference's hot swap rides the engine's warm reload, which the
    port's ServingEngine does not have: Replica.swap_weights raises
    NotImplementedError naming it, and swap_model reports every replica
    that failed, without touching traffic."""
    d = _export_model(str(tmp_path))
    router = _fleet(d, n=2)
    try:
        x = np.ones((1, 8), np.float32)
        (before,) = router.predict("mlp", {"img": x},
                                   result_timeout_s=WAIT_S)
        with pytest.raises(NotImplementedError, match="reload_weights"):
            router.get_replica("r0").swap_weights("mlp", str(tmp_path))
        with pytest.raises(ServingError, match=r"\['r0', 'r1'\]"):
            router.swap_model("mlp", str(tmp_path))
        with pytest.raises(ModelNotRoutable):
            router.swap_model("nope", str(tmp_path))
        (after,) = router.predict("mlp", {"img": x},
                                  result_timeout_s=WAIT_S)
        np.testing.assert_array_equal(after, before)
        assert router.stats()["counters"]["model_swaps"] == 0
    finally:
        router.stop()


# ---- stats consistency, breaker export, FaultRule.after ----

def test_stats_consistent_under_concurrent_submit(tmp_path):
    """While submitters hammer the engine, every stats() snapshot must
    satisfy submitted >= completed + failed + expired + cancelled."""
    d = _export_model(str(tmp_path))
    eng = _replica("r0", d)._models["mlp"].engine
    stop = threading.Event()
    torn, errs = [], []

    def submitter():
        x = np.zeros((1, 8), np.float32)
        while not stop.is_set():
            try:
                eng.submit({"img": x}).result(WAIT_S)
            except ServerOverloaded:
                pass
            except Exception as e:        # noqa: BLE001 — recorded
                errs.append(e)
                return

    def reader():
        while not stop.is_set():
            c = eng.stats()["counters"]
            resolved = (c["completed"] + c["failed"] + c["expired"]
                        + c["cancelled"])
            if resolved > c["submitted"]:
                torn.append(c)
                return

    ts = [threading.Thread(target=submitter) for _ in range(4)] + \
         [threading.Thread(target=reader) for _ in range(2)]
    try:
        for t in ts:
            t.start()
        time.sleep(1.0)
    finally:
        stop.set()
        for t in ts:
            t.join(WAIT_S)
        eng.stop()
    assert not errs, errs
    assert not torn, f"torn stats export: {torn[:1]}"


def test_breaker_export_is_single_snapshot():
    clock = [0.0]
    b = CircuitBreaker(2, 1.0, clock=lambda: clock[0])
    assert b.export() == {"state": "closed", "failures": 0, "trips": 0}
    b.record_failure()
    b.record_failure()
    assert b.export() == {"state": "open", "failures": 2, "trips": 1}
    clock[0] = 1.5
    assert b.export()["state"] == "half-open"


def test_fault_rule_after_semantics_and_roundtrip():
    """`after=K` fires on every matching call from index K until the
    `times` budget runs out, and round-trips through to_spec and the
    environment."""
    assert LazyFaultPlan is FaultPlan
    plan = FaultPlan(seed=0).error("replica:r1:*", after=2, times=3,
                                   message="dark")
    outcomes = []
    for _ in range(8):
        try:
            plan.hook("replica:r1", {"method": "mlp"})
            outcomes.append("ok")
        except ConnectionError:
            outcomes.append("err")
    assert outcomes == ["ok", "ok", "err", "err", "err", "ok", "ok",
                        "ok"]
    p2 = FaultPlan.from_spec(plan.to_spec())
    r = p2.rules[0]
    assert (r.after, r.times, r.message) == (2, 3, "dark")
    assert FaultRule("error", "x", at=[1]).after is None
    env = plan.to_env({})
    assert FaultPlan.from_spec(
        __import__("json").loads(env["PADDLE_TPU_FAULTS"])).to_spec() == \
        plan.to_spec()


def test_fault_plan_transport_hook_delays_drops_and_errors():
    """Installed as the transport's fault hook, a plan's rules fire on
    their seam keys in call order (deterministic), and uninstall clears
    the hook."""
    from paddle_tpu_torch.distributed import transport

    plan = (FaultPlan(seed=1).drop("send:ping", at=[0])
            .error("send:ping", at=[2], message="boom")
            .delay("recv:*", ms=1.0, times=1))
    with plan:
        assert transport.get_fault_hook() == plan.hook
        assert plan.hook("send", {"method": "ping"}) == "drop"
        assert plan.hook("send", {"method": "ping"}) is None
        with pytest.raises(ConnectionError, match="boom"):
            plan.hook("send", {"method": "ping"})
        assert plan.hook("recv", None) is None
    assert transport.get_fault_hook() is None
    assert [(k, kind) for k, kind, _ in plan.log] == [
        ("send:ping", "drop"), ("send:ping", "error"),
        ("recv:*", "delay")]


# ---- decode through the router ----

def _cfg(**kw):
    kw.setdefault("slots", 4)
    kw.setdefault("max_len", 32)
    kw.setdefault("bos_id", BOS)
    kw.setdefault("eos_id", EOS)
    return ContinuousConfig(**kw)


def _chain_step_fn():
    """Deterministic markov toy: next = prev + 1 cycling over 2..V-1."""
    def step_fn(prefix, lengths, ctx):
        idx = (np.asarray(lengths) - 1).clip(0)
        prev = np.take_along_axis(np.asarray(prefix), idx[:, None],
                                  axis=1)[:, 0]
        nxt = np.where(prev + 1 >= V, BOS, prev + 1)
        logits = np.full((prefix.shape[0], V), -5.0, np.float32)
        logits[np.arange(prefix.shape[0]), nxt] = 2.0
        return logits
    return step_fn


def _noisy_step_fn(scale=1.5):
    """Pseudo-random logits that are a pure function of (last token,
    length)."""
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
        return logits
    return step_fn


def test_router_submit_decode_dispatch_and_validation():
    router = FleetRouter(FleetConfig())
    step = _chain_step_fn()
    try:
        for name in ("r1", "r2"):
            r = Replica(name)
            r.add_decode_model("lm", step, _cfg())
            router.add_replica(r)
        out = router.submit_decode("lm", [BOS],
                                   max_new_tokens=4).result(WAIT_S)
        want = [BOS] + [(BOS + 1 + j - 2) % (V - 2) + 2
                        for j in range(4)]
        assert list(out) == want
        with pytest.raises(SamplingConfigError):
            router.submit_decode("lm", [BOS], sampling={"top_p": 7})
        st = router.stats()
        assert st["counters"]["dispatch_errors"] == 0
        for n in ("r1", "r2"):
            assert st["replicas"][n]["breaker"]["state"] == "closed"
            assert st["replicas"][n]["models"]["lm"]["kind"] == "decode"
        with pytest.raises(ModelNotRoutable):
            router.submit("lm", {"x": np.zeros((1, 2), np.float32)})
    finally:
        router.stop()


def test_router_fails_over_dark_decode_replica():
    """A decode replica dark from its first dispatch: its breaker trips,
    every request completes on the sibling, and with both dark the
    fleet-level refusal is NoReplicaAvailable."""
    plan = FaultPlan(seed=0).error("replica:r1:*", after=0,
                                   message="dark")
    router = FleetRouter(FleetConfig(breaker_failures=2,
                                     breaker_reset_s=30.0))
    try:
        for name in ("r1", "r2"):
            r = Replica(name, fault_plan=plan if name == "r1" else None)
            r.add_decode_model("lm", _chain_step_fn(), _cfg())
            router.add_replica(r)
        outs = [router.submit_decode("lm", [BOS], max_new_tokens=2)
                .result(WAIT_S) for _ in range(4)]
        assert all(len(o) == 3 for o in outs)
        st = router.stats()
        assert st["replicas"]["r1"]["breaker"]["state"] == "open"
        assert st["counters"]["failovers"] >= 1
        router.get_replica("r2").set_fault_plan(
            FaultPlan(seed=0).error("replica:r2:*", after=0))
        with pytest.raises(NoReplicaAvailable):
            router.submit_decode("lm", [BOS], max_new_tokens=1)
    finally:
        router.stop()


def _kv_leak_checks(eng):
    snap = eng._store.pool.snapshot()
    assert snap["blocks_live"] == 0, snap
    assert snap["blocks_free"] == snap["blocks_total"]
    kv_silos = {k: v for k, v in REGISTRY.snapshot().items()
                if k.startswith("kv/")}
    assert kv_silos, "pool never attached to the registry"
    assert any(s["counters"]["frees"] == s["counters"]["allocs"]
               for s in kv_silos.values()
               if s["blocks_total"] == snap["blocks_total"])
    eng._store.pool.check_invariants()


@pytest.mark.chaos
def test_faultplan_killed_step_frees_blocks_no_leak():
    """A FaultPlan error rule kills the decode step mid-generation: the
    in-flight sequences resolve typed, every block they held goes back
    to the free list (through the registry's kv occupancy silo), and
    later traffic decodes."""
    plan = FaultPlan(seed=12).error("decode:step", after=3, times=1,
                                    message="decode step killed")
    step = plan.wrap_callable(_chain_step_fn(), "decode:step")
    eng = ContinuousBatchingEngine(step, _cfg(
        slots=4, kv=PagedKVConfig(block_size=4, num_blocks=17,
                                  cache_prefixes=False)))
    try:
        reqs = [eng.submit([BOS], max_new_tokens=12) for _ in range(4)]
        failed = 0
        for r in reqs:
            try:
                r.result(WAIT_S)
            except ServingError:
                failed += 1
        assert failed >= 1
        assert len(eng.decode([BOS], max_new_tokens=2,
                              result_timeout_s=WAIT_S)) == 3
        _kv_leak_checks(eng)
    finally:
        eng.stop()


@pytest.mark.chaos
def test_faultplan_killed_sampled_step_no_leak_and_replay_exact():
    """The sampling edition: the kill lands while seeded sampled
    sequences are mid-generation; waiters fail typed, every block
    returns, and a re-submitted request with the same seed reproduces
    the unfaulted run's tokens."""
    step = _noisy_step_fn()
    scfg = {"temperature": 1.0, "seed": 2718}
    kv = dict(block_size=4, num_blocks=17, cache_prefixes=False)
    ref_eng = ContinuousBatchingEngine(step, _cfg(
        slots=4, kv=PagedKVConfig(**kv)))
    try:
        ref = ref_eng.decode([BOS], max_new_tokens=12,
                             sampling=dict(scfg), result_timeout_s=WAIT_S)
    finally:
        ref_eng.stop()
    plan = FaultPlan(seed=17).error("decode:step", after=3, times=1,
                                    message="decode step killed")
    eng = ContinuousBatchingEngine(plan.wrap_callable(step, "decode:step"),
                                   _cfg(slots=4, kv=PagedKVConfig(**kv)))
    try:
        reqs = [eng.submit([BOS], max_new_tokens=12,
                           sampling={"temperature": 1.0,
                                     "seed": 2718 + i})
                for i in range(4)]
        failed = 0
        for r in reqs:
            try:
                r.result(WAIT_S)
            except ServingError:
                failed += 1
        assert failed >= 1
        _kv_leak_checks(eng)
        replay = eng.decode([BOS], max_new_tokens=12,
                            sampling=dict(scfg), result_timeout_s=WAIT_S)
        np.testing.assert_array_equal(replay, ref)
        assert eng.stats()["shape_signatures"] == 1
    finally:
        eng.stop()
