"""Disaggregated prefill/decode serving in the port (``serving/disagg``,
``distributed/rpc.py``'s ``kv_stream``), held to the behaviours the JAX
package's ``tests/test_disagg.py`` holds its own to, with decode on plain
``Replica`` objects (``ShardedReplica`` waits for the multi-device
slice): the wire contract, the pool export -> ingest -> commit round
trip, crc and block-size refusals, abort and the TTL reaper, int8 arenas at about a
quarter of the fp32 wire bytes, the split/short-prompt fallback with
prefix hits, one traced causal tree, and the prefill-dies-mid-stream
drill.  Across packages: a JAX ``stream_slot`` ingested by a port
``KVStreamServer`` and the reverse give byte-equal arenas.  The NMT
prefill: the port's ``prefill_fn`` planes equal the JAX program's K/V
from the same startup state (atol 1e-5, float32 through two layers in two
frameworks), the split path's greedy tokens equal co-located decode's,
and attention over the streamed arenas (K5's and K4's plain versions)
equals the program's own at the prompt's last position (int8 within 0.05,
the JAX package's bar; float32 within 1e-4).

Every server, engine and router stops in a ``finally``; every result and
join waits at most 30 s.
"""

import time
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.distributed.rpc import RPCClient as JaxRPCClient
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu.models import zoo
from paddle_tpu.serving import kv as jax_kv
from paddle_tpu.serving.disagg import KVStreamServer as JaxKVStreamServer
from paddle_tpu.serving.disagg import stream_slot as jax_stream_slot
from paddle_tpu_torch import flags as port_flags
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.distributed import transport
from paddle_tpu_torch.distributed.rpc import (DEFAULT_DEADLINES_MS,
                                              IDEMPOTENT_METHODS, RPCClient)
from paddle_tpu_torch.models import transformer as port_transformer
from paddle_tpu_torch.observability import TRACER
from paddle_tpu_torch.observability.trace import critical_path
from paddle_tpu_torch.ops import paged_kernels as pk
from paddle_tpu_torch.ops import quant_kernels as qk
from paddle_tpu_torch.resilience.faults import FaultPlan
from paddle_tpu_torch.serving.disagg import (DisaggConfig, DisaggRouter,
                                             KVStreamError, KVStreamServer,
                                             PrefillReplica, send_abort,
                                             stream_slot)
from paddle_tpu_torch.serving.disagg import kvstream as ks
from paddle_tpu_torch.serving.fleet import (ContinuousConfig, Replica,
                                            lockstep_decode,
                                            make_program_step_fn)
from paddle_tpu_torch.serving.kv import (KVBlockPool, PagedKVConfig,
                                         PoolExhausted)

V = 8
BOS, EOS = 2, 1
HEADS, HDIM = 2, 8
WAIT_S = 30


def _kv_cfg(dtype="int8", num_blocks=64, block_size=4, heads=HEADS,
            head_dim=HDIM, pkg=None):
    cfg_cls = pkg.PagedKVConfig if pkg is not None else PagedKVConfig
    spec = cfg_cls(block_size=block_size,
                   kv_dtype=dtype).kv_value_spec(heads, head_dim)
    return cfg_cls(block_size=block_size, num_blocks=num_blocks,
                   kv_dtype=dtype, value_spec=spec)


def _values(tokens, dtype="int8", heads=HEADS, head_dim=HDIM):
    """Deterministic per-token planes derived from the tokens, so a
    transferred arena is byte-checkable on the far side."""
    n = int(np.asarray(tokens).size)
    base = np.asarray(tokens, np.int64).reshape(-1, 1, 1)
    kv = np.broadcast_to(base % 5, (n, heads, head_dim))
    out = {"k": kv.astype(dtype), "v": (kv + 1).astype(dtype)}
    if dtype == "int8":
        out["k_scale"] = (base[:, 0, 0] * 0.5 + 1).astype(np.float32)
        out["v_scale"] = (base[:, 0, 0] * 0.25 + 1).astype(np.float32)
    return out


def _chain_step_fn():
    def step_fn(prefix, lengths, ctx):
        idx = (np.asarray(lengths) - 1).clip(0)
        prev = np.take_along_axis(np.asarray(prefix), idx[:, None],
                                  axis=1)[:, 0]
        nxt = np.where(prev + 1 >= V, BOS, prev + 1)
        logits = np.full((prefix.shape[0], V), -5.0, np.float32)
        logits[np.arange(prefix.shape[0]), nxt] = 2.0
        return logits
    return step_fn


def _planes(pool, plane):
    return pool.tokens_arena() if plane == "tokens" else pool.arena(plane)


@pytest.fixture
def traced():
    port_flags.set_flags({"trace_sample_rate": 1.0})
    TRACER.reset()
    try:
        yield TRACER
    finally:
        port_flags.set_flags({"trace_sample_rate": 0.0})
        TRACER.reset()


# ---- wire contract ----------------------------------------------------------

def test_kv_stream_wire_contract():
    """Method registration: code, tensor slots, per-chunk deadline, and
    idempotency (chunks are (xfer, seq)-keyed, so the retry path may
    re-send them)."""
    assert transport.METHODS["kv_stream"] == 23
    assert transport._TENSOR_SLOTS["kv_stream"] == ("meta", "value")
    assert "kv_stream" in IDEMPOTENT_METHODS
    assert DEFAULT_DEADLINES_MS["kv_stream"] >= 1000

    import socket
    a, b = socket.socketpair()
    a.settimeout(WAIT_S)
    b.settimeout(WAIT_S)
    try:
        transport.send_frame(a, {
            "method": "kv_stream", "name": "xfer-7", "extra": 42,
            "meta": np.frombuffer(b'{"kind":"commit"}', np.uint8),
            "value": np.frombuffer(b"\x01\x02", np.uint8),
            "trainer_id": 3})
        msg = transport.recv_frame(b)
    finally:
        a.close()
        b.close()
    assert msg["method"] == "kv_stream"
    assert msg["xfer"] == "xfer-7" and msg["seq"] == 42
    assert bytes(msg["value"]) == b"\x01\x02"


# ---- pool export / ingest ---------------------------------------------------

def test_export_ingest_commit_rehomes_prefix_cache():
    """The transfer round trip without sockets: every plane lands
    byte-identical, commit re-homes the chain into the decode pool's
    prefix cache, the decode-side admit of the SAME prompt prefix-hits
    every block, and COW keeps a forked writer isolated."""
    src = KVBlockPool(2, 16, _kv_cfg())
    dst = KVBlockPool(4, 16, _kv_cfg())
    toks = np.arange(10) + 2
    src.admit(0, toks, values=_values(toks))
    export = src.export_slot(0)
    assert export["n_blocks"] == 3

    assert dst.begin_ingest("x1", export["n_tokens"]) == 3
    assert dst.begin_ingest("x1", export["n_tokens"]) == 3  # re-begin
    for plane, arr in export["planes"].items():
        for i in range(arr.shape[0]):
            dst.ingest_block("x1", i, plane, arr[i])
    assert dst.commit_ingest("x1") == (3, 0)
    assert dst._c["ingests_committed"] == 1

    dst.admit(0, toks, values=_values(toks))
    assert dst._c["prefix_hits"] == 3
    sblocks = [int(src._table[0, j]) for j in range(3)]
    dblocks = [int(dst._table[0, j]) for j in range(3)]
    for plane in export["planes"]:
        np.testing.assert_array_equal(_planes(src, plane)[sblocks],
                                      _planes(dst, plane)[dblocks])

    dst.admit(1, toks, values=_values(toks))
    forks0 = dst._c["cow_forks"]
    dst.append(1, 99)
    assert dst._c["cow_forks"] == forks0 + 1
    assert 99 not in dst._tokens[int(dst._table[0, 2])]
    dst.check_invariants()


def test_ingest_invariants_abort_and_admission_gate():
    """A mid-ingest pool audits clean, an aborted stream returns EVERY
    reserved block, and a begin that cannot fit sheds exactly like local
    admission (reserving nothing)."""
    dst = KVBlockPool(2, 8, _kv_cfg(num_blocks=12))
    free0 = dst.snapshot()["blocks_free"]
    assert dst.begin_ingest("x1", 9) == 3
    snap = dst.snapshot()
    assert snap["blocks_ingesting"] == 3
    assert snap["blocks_free"] == free0 - 3
    dst.check_invariants()
    assert dst.abort_ingest("x1") == 3
    assert dst.abort_ingest("x1") == 0        # idempotent
    snap = dst.snapshot()
    assert snap["blocks_ingesting"] == 0
    assert snap["blocks_free"] == free0
    assert dst._c["ingest_abort_blocks_returned"] == 3
    dst.check_invariants()
    with pytest.raises(PoolExhausted):
        dst.begin_ingest("x2", 500)
    assert dst.snapshot()["blocks_free"] == free0
    dst.begin_ingest("x3", 4)
    with pytest.raises(KeyError):
        dst.ingest_block("x3", 0, "nope", np.zeros((4, HEADS, HDIM)))
    dst.abort_ingest("x3")


# ---- socket transfer --------------------------------------------------------

def _rpc():
    return RPCClient(deadlines={"kv_stream": 10000})


def test_stream_slot_over_socket_and_idempotent_redelivery():
    """stream_slot through a real FrameServer: manifest accounting, then a
    duplicate chunk (the retry path) is acked WITHOUT re-applying, and a
    retried commit re-serves the stored outcome."""
    src = KVBlockPool(2, 16, _kv_cfg())
    dst = KVBlockPool(4, 16, _kv_cfg())
    toks = np.arange(10) + 2
    src.admit(0, toks, values=_values(toks))
    with KVStreamServer(dst) as srv:
        rpc = _rpc()
        m = stream_slot(rpc, srv.endpoint, src, 0, "x1")
        assert m["n_blocks"] == 3 and m["registered"] == 3
        assert m["bytes"] == sum(m["bytes_by_plane"].values())
        r = ks._call(rpc, srv.endpoint, "x1", m["chunks"] - 1,
                     {"kind": "commit"})
        assert r["registered"] == 3
        assert dst._c["ingests_committed"] == 1
        assert srv.ingestor.counters()["dup_chunks"] == 1
        payload = b"\x00" * 4
        ks._call(rpc, srv.endpoint, "x1", 1,
                 {"kind": "block", "plane": "tokens", "start": 0,
                  "shape": [1, 4], "dtype": "int64",
                  "crc": zlib.crc32(payload)})
    dst.check_invariants()


def test_crc_mismatch_is_typed_and_retriable():
    dst = KVBlockPool(2, 16, _kv_cfg())
    with KVStreamServer(dst) as srv:
        rpc = _rpc()
        ks._call(rpc, srv.endpoint, "x1", 0,
                 {"kind": "begin", "n_tokens": 4, "block_size": 4,
                  "planes": {}})
        with pytest.raises(KVStreamError, match="crc mismatch"):
            ks._call(rpc, srv.endpoint, "x1", 1,
                     {"kind": "block", "plane": "tokens", "start": 0,
                      "shape": [1, 4], "dtype": "int64", "crc": 12345},
                     b"\x00" * 32)
        assert srv.ingestor.counters()["crc_errors"] == 1
        assert send_abort(rpc, srv.endpoint, "x1") == 1
    dst.check_invariants()


def test_block_size_mismatch_refused_at_begin():
    dst = KVBlockPool(2, 16, _kv_cfg(block_size=4))
    with KVStreamServer(dst) as srv:
        with pytest.raises(KVStreamError, match="block_size mismatch"):
            ks._call(_rpc(), srv.endpoint, "x1", 0,
                     {"kind": "begin", "n_tokens": 4, "block_size": 8,
                      "planes": {}})
    assert dst.snapshot()["blocks_ingesting"] == 0


def test_int8_transfer_bytes_quarter_of_fp32():
    """The same chain streams at < 0.35x the fp32 wire bytes when the
    pool runs int8 K/V (at heads 4 x dim 16 the exact ratio is
    (2hd + 8 + 8) / (8hd + 8))."""
    toks = np.arange(16) + 2
    sizes = {}
    for dtype in ("int8", "float32"):
        cfg = _kv_cfg(dtype, heads=4, head_dim=16)
        src = KVBlockPool(2, 16, cfg)
        dst = KVBlockPool(2, 16, cfg)
        src.admit(0, toks, values=_values(toks, dtype, heads=4,
                                          head_dim=16))
        with KVStreamServer(dst) as srv:
            m = stream_slot(_rpc(), srv.endpoint, src, 0, "x")
        sizes[dtype] = m["bytes"]
    hd = 4 * 16
    assert sizes["int8"] / sizes["float32"] == \
        pytest.approx((2 * hd + 16) / (8 * hd + 8))
    assert sizes["int8"] / sizes["float32"] < 0.35


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("sender", ["jax", "port"])
def test_kv_stream_interop_with_jax_package(sender, dtype):
    """A chain streamed by one package's stream_slot into the other's
    KVStreamServer commits whole, prefix-hits on the receiving side, and
    lands byte for byte."""
    sp, rp = (jax_kv, None) if sender == "jax" else (None, jax_kv)
    src_cls = jax_kv.KVBlockPool if sender == "jax" else KVBlockPool
    dst_cls = KVBlockPool if sender == "jax" else jax_kv.KVBlockPool
    server = KVStreamServer if sender == "jax" else JaxKVStreamServer
    send = jax_stream_slot if sender == "jax" else stream_slot
    rpc = JaxRPCClient(deadlines={"kv_stream": 10000}) \
        if sender == "jax" else _rpc()
    toks = np.arange(10) + 2
    src = src_cls(2, 16, _kv_cfg(dtype, pkg=sp))
    dst = dst_cls(4, 16, _kv_cfg(dtype, pkg=rp))
    src.admit(0, toks, values=_values(toks, dtype))
    with server(dst) as srv:
        m = send(rpc, srv.endpoint, src, 0, f"interop-{sender}")
    assert (m["n_blocks"], m["registered"], m["deduped"]) == (3, 3, 0)
    dst.admit(0, toks)
    assert dst.snapshot()["counters"]["prefix_hits"] == 3
    sblocks = [int(src._table[0, j]) for j in range(3)]
    dblocks = [int(dst._table[0, j]) for j in range(3)]
    for plane in ["tokens"] + sorted(_values(toks, dtype)):
        a, b = _planes(src, plane)[sblocks], _planes(dst, plane)[dblocks]
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes(), plane
    dst.check_invariants()


# ---- the disaggregated tier (chain model) -----------------------------------

def _disagg_fleet(threshold=8, decode_replicas=2, kv_dtype="int8"):
    """One prefill replica staging through a local pool, N decode
    replicas each with a paged continuous engine and a kv_stream
    listener on its pool."""
    rpc = _rpc()
    router = DisaggRouter(DisaggConfig(
        prefill_threshold=threshold, bos_id=BOS, breaker_failures=3,
        breaker_reset_s=0.3))
    servers = []
    try:
        for i in range(decode_replicas):
            r = Replica(f"d{i}")
            eng = r.add_decode_model(
                "m", _chain_step_fn(),
                config=ContinuousConfig(slots=4, max_len=32, bos_id=BOS,
                                        eos_id=EOS, kv=_kv_cfg(kv_dtype)))
            srv = KVStreamServer(eng.kv_pool())
            servers.append(srv)
            router.add_replica(r, kv_endpoint=srv.endpoint)
        pf = PrefillReplica("p0")
        pf.add_prefill_model(
            "m", lambda toks: _values(toks, kv_dtype), rpc,
            kv=_kv_cfg(kv_dtype), slots=2, max_blocks=16)
        router.add_replica(pf)
    except BaseException:
        _stop(router, servers)
        raise
    return router, servers


def _stop(router, servers):
    try:
        router.stop()
    finally:
        for s in servers:
            s.shutdown()


def test_disagg_split_and_short_prompt_fallback():
    """Long prompts take the split path (prefill leg + kv_stream + pinned
    decode with 100% prefix hits); short prompts go straight to
    co-located decode.  Both complete with the chain's tokens."""
    router, servers = _disagg_fleet()
    try:
        long_prompt = list(range(3, 15))          # 12 >= threshold 8
        out = router.submit_disagg("m", long_prompt,
                                   max_new_tokens=3).result(WAIT_S)
        assert len(out) == len(long_prompt) + 1 + 3   # bos + budget
        st = router.stats()
        assert st["disagg"]["split"] == 1
        assert st["disagg"]["fallback_short"] == 0
        hits = [s.ingestor.pool._c["prefix_hits"] for s in servers]
        committed = [s.ingestor.counters()["streams_committed"]
                     for s in servers]
        assert sum(committed) == 1
        assert max(hits) >= 3
        for s in servers:
            s.ingestor.pool.check_invariants()

        short = router.submit_disagg("m", [3, 4, 5], max_new_tokens=2)
        assert len(short.result(WAIT_S)) == 3 + 1 + 2
        st = router.stats()
        assert st["disagg"]["fallback_short"] == 1
        assert st["disagg"]["split"] == 1
    finally:
        _stop(router, servers)


def test_disagg_no_prefill_replica_degrades():
    router, servers = _disagg_fleet()
    try:
        router.remove_replica("p0")
        req = router.submit_disagg("m", list(range(3, 15)),
                                   max_new_tokens=2)
        assert len(req.result(WAIT_S)) == 12 + 1 + 2
        st = router.stats()
        assert st["disagg"]["fallback_no_prefill"] == 1
        assert st["disagg"]["split"] == 0
    finally:
        _stop(router, servers)


def test_disagg_trace_one_causal_tree(traced):
    """The split request is ONE trace: disagg/request parents the prefill
    dispatch, the engine's prefill/transfer spans, the rpc/kv_stream
    chunks and the decode leg; critical_path bills the transfer to the
    kv_transfer stage."""
    router, servers = _disagg_fleet()
    try:
        router.submit_disagg("m", list(range(3, 15)),
                             max_new_tokens=2).result(WAIT_S)
        tid = None
        deadline = time.time() + 5
        while time.time() < deadline and tid is None:
            for t in list(TRACER._traces):
                if any(s["name"] == "disagg/request"
                       for s in TRACER.spans_for(t)):
                    tid = t
                    break
            if tid is None:
                time.sleep(0.05)
        assert tid is not None
        spans = TRACER.spans_for(tid)
        names = [s["name"] for s in spans]
        for expect in ("disagg/request", "disagg/prefill",
                       "disagg/kv_transfer", "rpc/kv_stream"):
            assert expect in names, f"{expect} missing from {names}"
        ids = {s["span_id"] for s in spans}
        roots = [s for s in spans if s.get("parent_id") not in ids]
        assert len(roots) == 1 and roots[0]["name"] == "disagg/request"
        xfer = [s for s in spans if s["name"] == "disagg/kv_transfer"]
        assert xfer and xfer[0]["attrs"]["bytes"] > 0
        assert critical_path(spans)["stages"]["kv_transfer"] > 0
    finally:
        _stop(router, servers)


@pytest.mark.chaos
def test_chaos_prefill_dies_mid_stream_no_leak():
    """The transport kills a kv_stream chunk (and both its retries)
    mid-transfer: every reserved block provably returns, and the request
    still completes via co-located fallback."""
    router, servers = _disagg_fleet(decode_replicas=1)
    pool = servers[0].ingestor.pool
    try:
        base_free = pool.snapshot()["blocks_free"]
        plan = FaultPlan(seed=0).error("send:kv_stream", after=2, times=3)
        with plan:
            out = router.submit_disagg("m", list(range(3, 15)),
                                       max_new_tokens=2).result(WAIT_S)
        assert len(out) == 12 + 1 + 2
        st = router.stats()
        assert st["disagg"]["fallback_stream_failed"] == 1
        assert st["disagg"]["split"] == 0
        c = pool._c
        assert c["ingests_begun"] == 1
        assert c["ingests_aborted"] == 1
        assert c["ingest_abort_blocks_returned"] == \
            c["ingest_blocks_reserved"] > 0
        snap = pool.snapshot()
        assert snap["blocks_ingesting"] == 0
        assert base_free - snap["blocks_free"] == snap["blocks_live"]
        pool.check_invariants()
        assert servers[0].ingestor.counters()["streams_aborted"] == 1
    finally:
        _stop(router, servers)


@pytest.mark.chaos
def test_chaos_ingest_ttl_reaper_returns_blocks():
    """A sender that dies too hard to abort: the ingestor's TTL reaper
    returns the reservation on the next handled frame."""
    dst = KVBlockPool(2, 16, _kv_cfg())
    free0 = dst.snapshot()["blocks_free"]
    with KVStreamServer(dst, ttl_s=0.05) as srv:
        rpc = _rpc()
        ks._call(rpc, srv.endpoint, "dead", 0,
                 {"kind": "begin", "n_tokens": 8, "block_size": 4,
                  "planes": {}})
        assert dst.snapshot()["blocks_ingesting"] == 2
        time.sleep(0.1)
        ks._call(rpc, srv.endpoint, "live", 0,
                 {"kind": "begin", "n_tokens": 4, "block_size": 4,
                  "planes": {}})
        assert srv.ingestor.counters()["streams_reaped"] == 1
        send_abort(rpc, srv.endpoint, "live")
    assert dst.snapshot()["blocks_free"] == free0
    dst.check_invariants()


# ---- the NMT prefill --------------------------------------------------------

NV, NL, NH, ND, NTS, NLEN, NBS = 1000, 2, 4, 64, 6, 16, 4


def _nmt(pkg):
    fluid, tr, init, names = (
        (jfluid, jax_transformer, jax_init, jax_unique_name) if pkg == "jax"
        else (pfluid, port_transformer, port_init, port_unique_name))
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    with names.guard(), fluid.program_guard(main, startup):
        _cost, predict, _ = tr.transformer(
            NV, NV, NLEN + 1, NL, NH, ND // NH, ND // NH, ND, 2 * ND,
            dropout_rate=0.0)
    return main, startup, predict


@pytest.fixture(scope="module")
def nmt_state():
    with _jax_flags():
        jmain, jstart, _ = _nmt("jax")
        state = zoo.snapshot_startup(
            zoo.ZooProgram("nmt", jmain, jstart, {}, []))
        src = np.random.RandomState(5).randint(2, NV, (NTS,))
        tokens = np.concatenate([[0], np.random.RandomState(6).randint(
            2, NV, (2 * NBS - 1,))]).astype(np.int64)
        infer = jmain.clone(for_test=True)
        taps = port_transformer.self_attention_taps(infer)
        feed = port_transformer.prefill_feed(tokens, src, NH)
        feed.update(lbl_word=np.zeros((1, tokens.size, 1), np.int64),
                    lbl_weight=np.zeros((1, tokens.size, 1), np.float32))
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            for n, v in state.items():
                scope.set_var(n, np.array(v, copy=True))
            got = jfluid.Executor().run(
                infer, feed=feed, fetch_list=[n for t in taps for n in t])
    jax_taps = [{key: np.asarray(got[4 * i + j])[0].transpose(1, 0, 2)
                 for j, key in enumerate(("q", "k", "v", "out"))}
                for i in range(len(taps))]
    return state, src, tokens, jax_taps


class _jax_flags:
    """Composed attention and no persistent jit cache on the JAX side
    while the fixture runs."""

    def __enter__(self):
        jax_flags._overrides.update(force_attention_impl="composed",
                                    jit_cache=False)

    def __exit__(self, *exc):
        jax_flags._overrides.pop("force_attention_impl", None)
        jax_flags._overrides.pop("jit_cache", None)


def _port_nmt(state):
    main, _, predict = _nmt("port")
    scope = pfluid.io.state_from_numpy(state, scope=pfluid.Scope(),
                                       place=pfluid.CPUPlace(),
                                       main_program=main)
    infer = main.clone(for_test=True)._prune([predict])
    return pfluid.Executor(pfluid.CPUPlace()), scope, infer, predict


def test_nmt_prefill_planes_match_jax_program(nmt_state):
    """The port's prefill_fn (float32) gives, per decoder layer, the JAX
    program's self-attention K and V rows from the same startup state;
    the int8 planes are quantize_kv of them."""
    state, src, tokens, jax_taps = nmt_state
    exe, scope, infer, _ = _port_nmt(state)
    assert len(port_transformer.self_attention_taps(infer)) == NL
    planes = port_transformer.make_prefill_fn(exe, infer, src, NH,
                                              scope=scope)(tokens)
    qplanes = port_transformer.make_prefill_fn(
        exe, infer, src, NH, kv_dtype="int8", scope=scope)(tokens)
    spec = port_transformer.layer_value_spec(
        PagedKVConfig(block_size=NBS, kv_dtype="int8"), NL, NH, ND // NH)
    assert sorted(qplanes) == sorted(spec)
    for i, tap in enumerate(jax_taps):
        for name in ("k", "v"):
            got = planes[f"l{i}_{name}"]
            assert got.shape == (tokens.size, NH, ND // NH)
            np.testing.assert_allclose(got, tap[name], rtol=0, atol=1e-5)
            want_q, want_s = qk.quantize_kv(got)
            np.testing.assert_array_equal(qplanes[f"l{i}_{name}"], want_q)
            np.testing.assert_array_equal(
                qplanes[f"l{i}_{name}_scale"], want_s)


def _nmt_feed_builder(prefix, lengths, context):
    n = prefix.shape[0]
    sb, tb, cb = port_transformer.make_attn_biases(
        [NTS] * n, [int(t) for t in lengths], NH, NTS, NLEN)
    return {"src_word": context["src"],
            "src_pos": np.tile(np.arange(NTS), (n, 1)).astype(np.int64),
            "trg_word": np.asarray(prefix)[:, :NLEN],
            "trg_pos": np.tile(np.arange(NLEN), (n, 1)).astype(np.int64),
            "src_slf_attn_bias": sb, "trg_slf_attn_bias": tb,
            "trg_src_attn_bias": cb}


def test_nmt_split_tokens_equal_colocated_and_streamed_attention(
        nmt_state):
    """Two long prompts (block multiples) take the split path with int8
    K/V streamed to two decode replicas, two short ones fall back; the
    split tokens equal co-located decode's (lockstep_decode over the same
    step function); every streamed block is a
    prefix hit; attention over the decode pool's int8 arenas (K5's plain
    version) is within 0.05 of the program's own at the prompt's last
    position, and over a float32 pool (K4's) within 1e-4; no pool holds
    a block after the drain."""
    state, src, tokens, _ = nmt_state
    exe, scope, infer, predict = _port_nmt(state)
    rng = np.random.RandomState(7)
    longs = [tokens] + [np.concatenate([[0], rng.randint(
        2, NV, (3 * NBS - 1,))]).astype(np.int64)]
    shorts = [[0] + list(rng.randint(2, NV, (n,))) for n in (2, 3)]
    int8 = PagedKVConfig(block_size=NBS, kv_dtype="int8")
    spec = port_transformer.layer_value_spec(int8, NL, NH, ND // NH)
    kv = dict(block_size=NBS, num_blocks=48, kv_dtype="int8",
              value_spec=spec)
    cfg = ContinuousConfig(slots=4, max_len=NLEN, bos_id=0, eos_id=-1,
                           context_spec={"src": ((NTS,), np.int64)},
                           kv=PagedKVConfig(**kv))
    with pfluid.scope_guard(scope):
        step = make_program_step_fn(exe, infer, predict, _nmt_feed_builder)
        prefill = port_transformer.make_prefill_fn(exe, infer, src, NH,
                                                   kv_dtype="int8")
        router = DisaggRouter(DisaggConfig(prefill_threshold=NBS + 1,
                                           bos_id=0))
        servers, pools = [], []
        try:
            for i in range(2):
                r = Replica(f"d{i}")
                eng = r.add_decode_model("nmt", step, config=cfg)
                pools.append(eng.kv_pool())
                servers.append(KVStreamServer(pools[-1]))
                router.add_replica(r, kv_endpoint=servers[-1].endpoint)
            pf = PrefillReplica("p0")
            pf.add_prefill_model("nmt", prefill, _rpc(), kv=dict(kv),
                                 slots=2, max_blocks=NLEN // NBS)
            router.add_replica(pf)
            ctx = {"src": src}
            budget = 3
            split = [router.submit_disagg("nmt", p, context=ctx,
                                          max_new_tokens=budget)
                     for p in longs]
            fell = [router.submit_disagg("nmt", p, context=ctx,
                                         max_new_tokens=budget)
                    for p in shorts]
            split = [r.result(WAIT_S) for r in split]
            fell = [r.result(WAIT_S) for r in fell]
            st = router.stats()
        finally:
            _stop(router, servers)
        coloc, _ = lockstep_decode(step, [(p, ctx, budget) for p in longs],
                                   cfg)
    assert st["disagg"]["split"] == 2
    assert st["disagg"]["fallback_short"] == 2
    for a, b, p in zip(split, coloc, longs):
        assert len(a) == p.size + budget
        np.testing.assert_array_equal(a, b)
    assert all(len(f) == len(p) + budget for f, p in zip(fell, shorts))
    committed = sum(s.ingestor.counters()["streams_committed"]
                    for s in servers)
    assert committed == 2

    fp32 = KVBlockPool(2, NLEN // NBS, PagedKVConfig(
        block_size=NBS, num_blocks=16, value_spec=port_transformer.
        layer_value_spec(PagedKVConfig(block_size=NBS), NL, NH, ND // NH)))
    fp_prefill = port_transformer.make_prefill_fn(exe, infer, src, NH,
                                                  scope=scope)
    for p in longs:
        taps = port_transformer.attention_taps(exe, infer, p, src, NH,
                                               scope=scope)
        n_blocks = p.size // NBS
        # the decode pool holding this prompt's chain: admitting it on a
        # free slot hits the prefix cache for every block (a miss on the
        # other pool caches a chain without K/V there, never read)
        for pool in pools:
            hits = pool.snapshot()["counters"]["prefix_hits"]
            pool.admit(0, p)
            if pool.snapshot()["counters"]["prefix_hits"] - hits == \
                    n_blocks:
                break
            pool.release(0)
        else:
            raise AssertionError("no decode pool holds the streamed chain")
        fp32.admit(0, p, values=fp_prefill(p))
        try:
            lens = np.array([p.size], np.int32)
            for i, tap in enumerate(taps):
                q = torch.from_numpy(tap["q"][-1:])
                want = tap["out"][-1:]
                got8 = qk.paged_attention_quant(
                    q, pool.arena(f"l{i}_k"), pool.arena(f"l{i}_v"),
                    pool.arena(f"l{i}_k_scale"),
                    pool.arena(f"l{i}_v_scale"), pool.table_view()[:1],
                    lens).numpy()
                assert np.abs(got8 - want).max() < 0.05
                got32 = pk.paged_attention(
                    q, fp32.arena(f"l{i}_k"), fp32.arena(f"l{i}_v"),
                    fp32.table_view()[:1], lens).numpy()
                np.testing.assert_allclose(got32, want, rtol=0, atol=1e-4)
        finally:
            pool.release(0)
            fp32.release(0)
    for pool in pools + [fp32]:
        pool.check_invariants()
        snap = pool.snapshot()
        assert snap["blocks_live"] == snap["blocks_cached"]
