"""The port's sharded embedding engine (``paddle_tpu_torch.sparse``) and
the CTR slice against the JAX package on the CPU, on the same seeded
numpy inputs:

- ``RowPartition``, ``dedup_ids`` and ``pad_bucket`` give the reference's
  results;
- a frame encoded by either package's transport decodes in the other,
  and the two encodings are equal byte for byte;
- K11's plain version (``gather_rows`` on a CPU table) equals the JAX
  ``gather_rows`` through the Pallas kernel in interpret mode and
  through ``take``, exactly;
- ``SparseOptimizer`` (sgd, adagrad, lazy adam) within 1e-6 of the JAX
  one;
- client and shard servers over the port's RPC on 127.0.0.1: lookups
  equal the JAX client's on equal shard blocks (the JAX client also
  reads the port's servers), merged-SGD pushes with read-your-writes,
  the named errors, and the CPU-place device mirror tracking pushes;
- ``shard_program`` on the CTR builder and on ``wide_deep_sharded``
  gives the reference's trainer program and startup op for op;
- the slice: the CTR model (vocab 4096, dim 8, 26 slots, widths 32,
  batch 32) over 2 shards, one colocated and one over RPC, 5 SGD steps
  from the JAX run's initial state, within rtol 1e-5 of the JAX
  package's sharded run; ``wide_deep_sharded`` with Adagrad for 3 steps;
  and declared tables below ``sparse_shard_min_rows`` training on the
  dense SelectedRows path.

Every RPC deadline is a few seconds (the default tables are patched;
15 s where the JAX package's servers compile their updates), and every
test shuts its servers down in ``finally``.  Tolerances:
exact for ids, frames and gathers; 1e-6 for the optimizer rules and
rtol 1e-5 for losses (float32 on both sides, sums in other orders).
"""

import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.sparse as jsparse
import paddle_tpu_torch as pfluid
import paddle_tpu_torch.sparse as psparse
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu.core import framework as jax_framework
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.distributed import rpc as jrpc
from paddle_tpu.distributed import transport as jtransport
from paddle_tpu.models import zoo as jzoo
from paddle_tpu.sparse import engine as jengine
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch.core import framework as port_framework
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.distributed import rpc as prpc
from paddle_tpu_torch.distributed import transport as ptransport
from paddle_tpu_torch.models.ctr import (DEEP_TABLE, WIDE_TABLE, ctr_batch,
                                         ctr_dnn, wide_deep_sharded)
from paddle_tpu_torch.sparse import engine as pengine

RPC_MS = 3000
# the JAX package's shard servers compile their update at the first push
# of each row count, which takes seconds on a loaded CPU
JAX_RPC_MS = 15000


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # the JAX side compiles its steps afresh: the persistent jit cache is
    # shared by the test workers (ROADMAP queue 3)
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)
    for rpc, ms in ((jrpc, JAX_RPC_MS), (prpc, RPC_MS)):
        for m in ("sparse_lookup", "sparse_push", "ping", "complete"):
            monkeypatch.setitem(rpc.DEFAULT_DEADLINES_MS, m, ms)
    for sp in (jsparse, psparse):
        sp.clear_tables()
        sp.METRICS.reset()
    yield
    for sp in (jsparse, psparse):
        sp.clear_tables()


# ---------------------------------------------------------------------------
# partition, dedup, buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,shards", [(1000, 3), (4096, 2), (7, 7)])
def test_row_partition_matches_jax(vocab, shards):
    rows = np.random.RandomState(0).randint(0, vocab, 500)
    jp = jsparse.RowPartition(vocab, shards)
    pp = psparse.RowPartition(vocab, shards)
    for f in ("shard_of", "local_of"):
        np.testing.assert_array_equal(getattr(pp, f)(rows),
                                      getattr(jp, f)(rows))
    for s in range(shards):
        assert pp.shard_height(s) == jp.shard_height(s)
        np.testing.assert_array_equal(pp.shard_rows(s), jp.shard_rows(s))
        np.testing.assert_array_equal(pp.to_global(s, np.arange(3)),
                                      jp.to_global(s, np.arange(3)))
    with pytest.raises(IndexError, match="outside table"):
        pp.check_rows(np.array([vocab]))


def test_dedup_and_buckets_match_jax():
    ids = np.random.RandomState(1).randint(0, 300, (26, 40))
    for a, b in zip(psparse.dedup_ids(ids), jsparse.dedup_ids(ids)):
        np.testing.assert_array_equal(a, b)
    for n in (0, 1, 8, 9, 1000, 50_500, 65_536, 65_537):
        assert psparse.pad_bucket(n) == jsparse.pad_bucket(n)


# ---------------------------------------------------------------------------
# the frame codec
# ---------------------------------------------------------------------------

def _frames():
    rng = np.random.RandomState(2)
    return [
        {"method": "sparse_lookup", "name": "ctr_deep_table",
         "ids": rng.randint(0, 9, 16).astype(np.int64), "trainer_id": 3},
        {"method": "sparse_push", "name": "t",
         "rows": np.arange(4, dtype=np.int64),
         "values": rng.rand(4, 8).astype(np.float32)},
        {"method": "reply_value",
         "value": rng.rand(2, 3).astype(np.float32), "round": 7},
        {"method": "reply_error", "error": "IndexError: local index 9"},
        {"method": "reply_ok"},
        {"method": "complete", "trainer_id": 1},
    ]


def _wire(transport, msg, trace=None):
    hdr, tensors, tail = transport.encode(msg)
    if trace is not None:
        tail += transport.pack_trace(*trace)
    return hdr + b"".join(a.tobytes() for a in tensors) + tail


@pytest.mark.parametrize("i", range(len(_frames())))
@pytest.mark.parametrize("trace", [None, (11, 22, 1)])
def test_frames_equal_jax_byte_for_byte_and_cross_decode(i, trace):
    msg = _frames()[i]
    pw, jw = _wire(ptransport, msg, trace), _wire(jtransport, msg, trace)
    assert pw == jw
    for dec, wire in ((jtransport.decode, pw), (ptransport.decode, jw)):
        got = dec(wire)
        want = jtransport.decode(jw)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype
                np.testing.assert_array_equal(got[k], v)
            else:
                assert got[k] == v


# ---------------------------------------------------------------------------
# K11's plain version against the Pallas kernel (interpret) and take
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,d,n", [(64, 128, 16), (500, 16, 64), (33, 1, 40)])
def test_gather_plain_matches_jax_pallas_and_take(v, d, n):
    rng = np.random.RandomState(3)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.randint(0, v, n)
    psparse.gather_rows.launches = 0
    got = psparse.gather_rows(torch.from_numpy(table), idx).numpy()
    assert psparse.gather_rows.launches == 0      # the plain version ran
    for impl in ("pallas", "take"):
        np.testing.assert_array_equal(
            got, np.asarray(jsparse.gather_rows(table, idx, impl=impl)))
    np.testing.assert_array_equal(
        psparse.dedup_gather(torch.from_numpy(table), idx),
        jsparse.dedup_gather(table, idx, impl="take"))


def test_gather_wrapper_refuses_what_it_does_not_take():
    t = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="impl"):
        psparse.gather_rows(t, [0], impl="take")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        psparse.gather_rows(torch.zeros(4, 2, device="meta"), [0])


# ---------------------------------------------------------------------------
# the touched-rows optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,lr", [("sgd", 0.5), ("adagrad", 0.1),
                                     ("adam", 0.01)])
def test_sparse_optimizer_matches_jax(kind, lr):
    rng = np.random.RandomState(4)
    vals = rng.standard_normal((64, 8)).astype(np.float32)
    jopt = jsparse.SparseOptimizer(kind, lr, vals.shape)
    popt = psparse.SparseOptimizer(kind, lr, vals.shape)
    jv, pv = vals.copy(), vals.copy()
    for _ in range(3):
        rows = rng.randint(0, 64, 12)                 # duplicates too
        grads = rng.standard_normal((12, 8)).astype(np.float32)
        jv = np.asarray(jopt.apply(jv, rows, grads))
        assert popt.apply(pv, rows, grads) is pv      # in place
        np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-6)
    for name, arr in jopt.slot_arrays().items():
        np.testing.assert_allclose(popt.slots[name], arr, rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# client and shard servers over RPC
# ---------------------------------------------------------------------------

def _servers(sp, cfgs, n, **kw):
    """Start `n` shard servers of `cfgs` on OS-assigned ports and point
    the configs at them."""
    servers = []
    try:
        for i in range(n):
            servers.append(sp.SparseShardServer("127.0.0.1:0", i, cfgs,
                                                **kw).start())
    except BaseException:
        for s in servers:
            s.shutdown()
        raise
    for cfg in cfgs.values():
        cfg.endpoints = [s.endpoint for s in servers]
    return servers


def _shutdown(servers):
    for s in servers:
        s.shutdown()


def _declare(sp, name, vocab, dim, n, **kw):
    return sp.declare_sharded_table(name, vocab, dim, ["127.0.0.1:0"] * n,
                                    **kw)


def test_lookup_parity_with_jax_client_on_equal_blocks():
    rng = np.random.RandomState(5)
    dense = rng.standard_normal((1024, 16)).astype(np.float32)
    jcfg = _declare(jsparse, "t", 1024, 16, 2)
    pcfg = _declare(psparse, "t", 1024, 16, 2)
    jsv, psv = [], []
    try:
        jsv = _servers(jsparse, {"t": jcfg}, 2)
        psv = _servers(psparse, {"t": pcfg}, 2, device_table=True,
                       place=pfluid.CPUPlace())
        for i, s in enumerate(jsv):
            s.values["t"] = np.array(dense[jcfg.partition.shard_rows(i)])
        psparse.load_table(psv, "t", dense)
        psparse.bind_local_server("t", 0, psv[0])
        ids = rng.randint(0, 1024, 4096)
        want = jsparse.SparseTableClient(jcfg).lookup(ids)
        np.testing.assert_array_equal(want, dense[ids])
        got = psparse.SparseTableClient(pcfg).lookup(ids)
        np.testing.assert_array_equal(got, want)
        # the JAX client reads the port's servers over the wire
        cross = jsparse.ShardedTableConfig("t", 1024, 16, pcfg.endpoints)
        np.testing.assert_array_equal(
            jsparse.SparseTableClient(cross).lookup(ids), want)
        c = psparse.METRICS.snapshot()["counters"]
        assert c["ids_total"] == 4096 and c["rpc_calls"] == 1
        assert c["ids_unique"] == len(np.unique(ids))
        assert c["local_gather_rows"] + c["rpc_rows"] == c["ids_unique"]
    finally:
        _shutdown(jsv + psv)


def test_push_merges_duplicates_and_reads_your_writes():
    cfg = _declare(psparse, "t", 256, 8, 2, optimizer="sgd",
                   learning_rate=0.5)
    servers = []
    try:
        servers = _servers(psparse, {"t": cfg}, 2)
        dense = np.zeros((256, 8), np.float32)
        for i, s in enumerate(servers):
            dense[cfg.partition.shard_rows(i)] = s.values["t"]
        client = psparse.SparseTableClient(cfg)
        rows = np.array([3, 7, 3, 11, 7, 3], np.int64)
        grads = np.ones((6, 8), np.float32)
        client.push(rows, grads, wait=True)
        want = dense.copy()
        np.add.at(want, rows, -0.5 * grads)
        np.testing.assert_allclose(client.lookup(np.arange(256)), want,
                                   rtol=1e-6, atol=1e-7)
        # fire-and-forget pushes on the lanes, then a flush
        client.push(rows, grads)
        client.flush()
        np.add.at(want, rows, -0.5 * grads)
        np.testing.assert_allclose(client.lookup(rows), want[rows],
                                   rtol=1e-6, atol=1e-7)
    finally:
        _shutdown(servers)


def test_named_errors():
    lost = _declare(psparse, "lost", 64, 4, 2)
    lost.endpoints = ["127.0.0.1:1", "127.0.0.1:1"]
    client = psparse.SparseTableClient(
        lost, rpc=prpc.RPCClient(retry=prpc.RetryPolicy(max_retries=0)))
    with pytest.raises(psparse.TableShardLostError) as ei:
        client.lookup(np.array([0, 1, 2]))
    assert "lost" in str(ei.value) and "127.0.0.1:1" in str(ei.value)
    assert psparse.METRICS.get("shard_errors") >= 1

    cfg = _declare(psparse, "t", 64, 4, 2)
    servers = []
    try:
        servers = _servers(psparse, {"t": cfg}, 2)
        ghost = psparse.ShardedTableConfig("ghost", 64, 4, cfg.endpoints)
        with pytest.raises(RuntimeError, match="ghost.*not declared"):
            psparse.SparseTableClient(ghost).lookup(np.array([0]))
        h = servers[1].values["t"].shape[0]
        with pytest.raises(IndexError, match="partition mismatch"):
            servers[1].push_local("t", np.array([h + 5]),
                                  np.ones((1, 4), np.float32))
        with pytest.raises(RuntimeError, match="partition mismatch"):
            prpc.RPCClient().sparse_push(cfg.endpoints[1], "t",
                                         np.array([h]),
                                         np.ones((1, 4), np.float32))
        with pytest.raises(RuntimeError, match="sparse/checkpoint.py"):
            prpc.RPCClient()._call(cfg.endpoints[0],
                                   {"method": "checkpoint_notify",
                                    "name": "/nowhere", "step": 1},
                                   timeout_ms=RPC_MS)
        assert prpc.RPCClient().ping(cfg.endpoints[0])
    finally:
        _shutdown(servers)


def test_cpu_place_device_mirror_tracks_pushes():
    cfg = _declare(psparse, "dt", 64, 4, 1, optimizer="sgd",
                   learning_rate=1.0)
    srv = psparse.SparseShardServer("127.0.0.1:0", 0, {"dt": cfg},
                                    device_table=True,
                                    place=pfluid.CPUPlace())
    ids = np.arange(8)
    before = srv.lookup_local("dt", ids).copy()       # builds the mirror
    srv.push_local("dt", np.array([1, 3, 5]), np.ones((3, 4), np.float32))
    after = srv.lookup_local("dt", ids)
    mirror = srv._dev["dt"].numpy()
    np.testing.assert_array_equal(mirror, srv.values["dt"])
    assert mirror.ctypes.data != srv.values["dt"].ctypes.data   # a copy
    np.testing.assert_array_equal(after, srv.values["dt"][ids])
    np.testing.assert_array_equal(after[[0, 2, 4, 6, 7]],
                                  before[[0, 2, 4, 6, 7]])
    np.testing.assert_allclose(after[[1, 3, 5]], before[[1, 3, 5]] - 1.0,
                               rtol=0, atol=1e-7)


def test_concurrent_pushes_lose_no_update():
    """Pushes from many threads at once (the RPC server runs one thread
    per request) each apply under the table lock: none is lost, and the
    mirror ends equal to the host block."""
    cfg = _declare(psparse, "c", 64, 4, 1, optimizer="sgd",
                   learning_rate=1.0)
    srv = psparse.SparseShardServer("127.0.0.1:0", 0, {"c": cfg},
                                    device_table=True,
                                    place=pfluid.CPUPlace())
    srv.lookup_local("c", np.arange(8))               # builds the mirror
    start = srv.values["c"].copy()
    ones = np.ones((2, 4), np.float32)

    def pusher():
        for _ in range(20):
            srv.push_local("c", np.array([0, 5]), ones)

    threads = [threading.Thread(target=pusher) for _ in range(16)]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    np.testing.assert_allclose(srv.values["c"][[0, 5]],
                               start[[0, 5]] - 16 * 20, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(srv._dev["c"].numpy(), srv.values["c"])


def test_device_table_defaults_to_the_card(monkeypatch):
    cfg = _declare(psparse, "dt", 64, 4, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        psparse.SparseShardServer("127.0.0.1:0", 0, {"dt": cfg},
                                  device_table=True)
    host = psparse.SparseShardServer("127.0.0.1:0", 0, {"dt": cfg})
    assert host.device is None


def test_executor_refuses_feed_next_and_pserver_ops():
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        x = pfluid.layers.data(name="x", shape=[1], dtype="float32")
    exe = pfluid.Executor(pfluid.CPUPlace())
    with pytest.raises(NotImplementedError, match="feed_next"):
        exe.run(main, feed={"x": np.ones((2, 1), np.float32)},
                feed_next={"x": np.ones((2, 1), np.float32)})
    main.global_block().append_op(type="send", inputs={"X": [x]},
                                  outputs={}, attrs={"endpoint": "h:1"})
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        exe.run(main, feed={"x": np.ones((2, 1), np.float32)})


# ---------------------------------------------------------------------------
# programs: shard_program op for op, and the slice's training runs
# ---------------------------------------------------------------------------

def _pkg(pkg):
    return ((jfluid, jsparse, jengine, jax_init, jax_unique_name, jrpc)
            if pkg == "jax" else
            (pfluid, psparse, pengine, port_init, port_unique_name, prpc))


def build(pkg, name, **sizes):
    """(main, startup, loss) of the CTR model or wide_deep_sharded, built
    by the JAX package or the port under a fresh name generator."""
    fluid, _, _, init, names, _ = _pkg(pkg)
    init._auto_seed_counter[0] = 1
    with names.guard():
        if name == "wide_deep":
            if pkg == "jax":
                zp = jzoo.build("wide_deep_sharded")
                return zp.main, zp.startup, zp.main.global_block().var(
                    zp.fetch_names[0])
            return wide_deep_sharded(fluid)
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            loss = ctr_dnn(fluid, **sizes)
    return main, startup, loss


def _signature(prog, block_type):
    def attr(v):
        return ("block", v.idx) if isinstance(v, block_type) else v

    return [([(op.type, {k: list(v) for k, v in op.inputs.items()},
               {k: list(v) for k, v in op.outputs.items()},
               {k: attr(v) for k, v in op.attrs.items()})
              for op in blk.ops],
             {n: (v.shape, v.dtype) for n, v in blk.vars.items()})
            for blk in prog.blocks]


CTR = dict(vocab=4096, dim=8, n_slots=26, widths=(32, 32, 32))
TABLES = {"ctr": ((DEEP_TABLE, "dim"), (WIDE_TABLE, 1)),
          "wide_deep": (("wd_table", 16),)}


def _declare_all(pkg, name, sizes, endpoints, **kw):
    sp = _pkg(pkg)[1]
    out = {}
    for tname, dim in TABLES[name]:
        dim = sizes["dim"] if dim == "dim" else dim
        out[tname] = sp.declare_sharded_table(
            tname, sizes.get("vocab", 2048), dim, list(endpoints), **kw)
    return out


@pytest.mark.parametrize("name,sizes", [("ctr", CTR), ("wide_deep", {})])
def test_shard_program_equals_jax(name, sizes):
    progs = {}
    for pkg in ("jax", "port"):
        main, startup, _ = build(pkg, "ctr" if name == "ctr" else name,
                                 **sizes)
        _declare_all(pkg, name, sizes, ["h0:1", "h1:1"])
        progs[pkg] = _pkg(pkg)[1].shard_program(main, startup)
    (jtp, jts), (ptp, pts) = progs["jax"], progs["port"]
    assert ptp._sparse_tables == jtp._sparse_tables
    types = [op.type for op in ptp.global_block().ops]
    assert "sharded_lookup_table" in types and "lookup_table" not in types
    for jp, pp in ((jtp, ptp), (jts, pts)):
        assert _signature(pp, port_framework.Block) == \
            _signature(jp, jax_framework.Block)


def _jax_state(main, startup):
    exe = jfluid.Executor()
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
    return {n: np.array(np.asarray(v), copy=True)
            for n, v in scope.vars.items() if v is not None}


def _sharded_losses(pkg, name, sizes, state, feeds, optimizer, lr):
    """Losses of the sharded run of one package: 2 shard servers (shard 0
    colocated, shard 1 over RPC) holding the state's tables, the trainer
    program from shard_program, the state's dense parameters."""
    fluid, sp, engine, _, _, rpc = _pkg(pkg)
    main, startup, loss = build(pkg, name, **sizes)
    cfgs = _declare_all(pkg, name, sizes, ["127.0.0.1:0"] * 2,
                        optimizer=optimizer, learning_rate=lr)
    kw = dict(device_table=True, place=fluid.CPUPlace()) \
        if pkg == "port" else {}
    servers = []
    try:
        servers = _servers(sp, cfgs, 2, **kw)
        for tname, cfg in cfgs.items():
            if pkg == "port":
                sp.load_table(servers, tname, state[tname])
            else:
                for i, s in enumerate(servers):
                    s.values[tname] = np.array(
                        state[tname][cfg.partition.shard_rows(i)])
            sp.bind_local_server(tname, 0, servers[0])
            ms = JAX_RPC_MS if pkg == "jax" else RPC_MS
            engine.install_client(sp.SparseTableClient(
                cfg, rpc=rpc.RPCClient(deadlines={"sparse_lookup": ms,
                                                  "sparse_push": ms})))
        tp, _ = sp.shard_program(main, startup)
        dense = {n: v for n, v in state.items() if n not in cfgs}
        if pkg == "jax":
            exe, scope = fluid.Executor(), fluid.Scope()
            with fluid.scope_guard(scope):
                for n, v in dense.items():
                    scope.set_var(n, np.array(v, copy=True))
                got = [float(np.asarray(exe.run(
                    tp, feed=f, fetch_list=[loss.name])[0])) for f in feeds]
                exe.close()
        else:
            exe = fluid.Executor(fluid.CPUPlace())
            scope = fluid.io.state_from_numpy(
                dense, scope=fluid.Scope(), place=fluid.CPUPlace(),
                main_program=tp)
            got = [float(exe.run(tp, feed=f, fetch_list=[loss.name],
                                 scope=scope)[0]) for f in feeds]
            exe.close()
            for tname in cfgs:         # the mirrors track the host blocks
                for s in servers:
                    np.testing.assert_array_equal(s._dev[tname].numpy(),
                                                  s.values[tname])
        return got
    finally:
        _shutdown(servers)


def _wide_deep_feed(seed):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, 2048, (8, 1)).astype(np.int64),
            "wide_ids": rng.randint(0, 2048, (8, 1)).astype(np.int64),
            "dense": rng.randn(8, 13).astype(np.float32),
            "y": rng.randint(0, 2, (8, 1)).astype(np.float32)}


@pytest.mark.parametrize("name", ["ctr", "wide_deep"])
def test_sharded_training_matches_jax_sharded_run(name):
    if name == "ctr":
        sizes, steps, opt, lr = CTR, 5, "sgd", 1e-3
        feeds = [ctr_batch(np.random.RandomState(10 + s), 32,
                           CTR["vocab"], CTR["n_slots"])
                 for s in range(steps)]
    else:
        # one batch three times: the JAX package compiles its sparse
        # adagrad once per pushed row count, so new batches cost seconds
        sizes, steps, opt, lr = {}, 3, "adagrad", 0.05
        feeds = [_wide_deep_feed(20)] * steps
    state = _jax_state(*build("jax", name, **sizes)[:2])
    want = _sharded_losses("jax", name, sizes, state, feeds, opt, lr)
    jsparse.clear_tables()
    psparse.METRICS.reset()
    got = _sharded_losses("port", name, sizes, state, feeds, opt, lr)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert len(set(got)) == steps                # every update moved it
    c = psparse.METRICS.snapshot()["counters"]
    lookups = len(TABLES[name]) * (2 if name == "wide_deep" else 1)
    assert c["lookups"] == lookups * steps
    assert c["rpc_calls"] == c["lookups"]        # one RPC: the remote shard


def test_small_tables_train_on_the_dense_selected_rows_path(capsys):
    sizes = dict(CTR, vocab=256)
    feeds = [ctr_batch(np.random.RandomState(30 + s), 16, 256, 26)
             for s in range(3)]
    jmain, jstart, jloss = build("jax", "ctr", **sizes)
    state = _jax_state(jmain, jstart)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    with jfluid.scope_guard(scope):
        for n, v in state.items():
            scope.set_var(n, np.array(v, copy=True))
        want = [float(np.asarray(exe.run(jmain, feed=f,
                                         fetch_list=[jloss])[0]))
                for f in feeds]
    main, startup, loss = build("port", "ctr", **sizes)
    _declare_all("port", "ctr", sizes, ["h0:1", "h1:1"])
    tp, ts = psparse.shard_program(main, startup)
    assert tp is main and ts is startup          # identity: dense kept
    assert "dense path" in capsys.readouterr().err
    grads = [op for op in main.global_block().ops
             if op.type == "lookup_table_grad"]
    assert len(grads) == 2 and all(
        op.attrs["fw_attrs"]["is_sparse"] for op in grads)
    scope = pfluid.io.state_from_numpy(state, scope=pfluid.Scope(),
                                       place=pfluid.CPUPlace(),
                                       main_program=main)
    pexe = pfluid.Executor(pfluid.CPUPlace())
    got = [float(pexe.run(main, feed=f, fetch_list=[loss],
                          scope=scope)[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
