"""The port's mixed host/device runner on the CPU (``core/executor.py``:
``segment_breakers``, ``_host_program_segments``, ``_SegmentRunner``,
``_SegmentedProgram``).

The CPU has no CUDA graph, so the segmented runner runs its uncaptured
arm here: every device segment over its static buffers, op by op at every
run, with the staging of host reads and the Scope's in-place write-back.
The graphs themselves are held on the card by ``chip_smoke.py``'s
``segments_phase``.

- The partition equals the reference ``_host_program_segments``'s, kind
  for kind and name for name, on an MLP training program with a ``print``
  host op between its layers and on the CTR trainer program after
  ``sparse.shard_program`` (its shard addresses are never dialled).
- The segmented run of the print-MLP matches the JAX package's
  ``Executor.run`` (its ``_run_eager``) from one startup state over 3 SGD
  steps: losses and parameters within 1e-5.
- It equals the port's op-by-op interpreter bit for bit on the
  print-MLP, on a tiny seq2seq-style ``dynamic_rnn`` net with dropout 0.3
  and a ``print`` between its forward and its loss, and on the ``While``
  decode of the book's machine translation (ids, scores, ``loop_counts``).
- ``segment_breakers`` names the port's own breakers: the startup's
  generator draws, wide&deep's ``is_sparse`` lookups, a ``range`` op.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu import sparse as jsparse
from paddle_tpu.core import executor as jexec
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch import sparse as psparse
from paddle_tpu_torch.core import executor as pexec
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.models import machine_translation as mt
from paddle_tpu_torch.models.ctr import (DEEP_TABLE, WIDE_TABLE, ctr_dnn,
                                         wide_deep_sharded)

RTOL = 1e-5
STEPS = 3
B = 8


@pytest.fixture(autouse=True)
def fresh_jax_steps(monkeypatch):
    # the JAX side compiles its steps afresh: the persistent jit cache is
    # shared by the test workers
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)


def pkg(name):
    return (jfluid, jax_init, jax_unique_name) if name == "jax" else \
        (pfluid, port_init, port_unique_name)


def build(name, net, seed=0):
    """(main, startup, outs) of `net(fluid)` built by one package under a
    fresh name generator and seed counter."""
    fluid, init, names = pkg(name)
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with names.guard(), fluid.program_guard(main, startup):
        outs = net(fluid)
    return main, startup, outs


def print_mlp(fluid):
    """fc -> print -> fc -> square error, SGD(0.1): the host op cuts the
    forward, and its input's grad crosses the cut back."""
    layers = fluid.layers
    x = layers.data(name="x", shape=[6], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(input=x, size=12, act="tanh")
    h = layers.Print(h, message="hidden")
    out = layers.fc(input=h, size=1)
    loss = layers.mean(layers.square_error_cost(input=out, label=y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss]


def mlp_feeds():
    rng = np.random.RandomState(3)
    return [{"x": rng.randn(B, 6).astype(np.float32),
             "y": rng.randn(B, 1).astype(np.float32)}
            for _ in range(STEPS)]


def alias_net(fluid):
    """A view of a parameter taken before a print and read behind the
    print after the SGD update: the update lands in the parameter's own
    tensor, and the view must keep the values from before it, as in the
    interpreter."""
    layers = fluid.layers
    x = layers.data(name="x", shape=[6], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    out = layers.fc(input=x, size=1, param_attr=fluid.ParamAttr(name="w"))
    w = fluid.default_main_program().global_block().var("w")
    before = layers.reshape(w, shape=[6])
    layers.Print(x, message="x")
    loss = layers.mean(layers.square_error_cost(input=out, label=y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    layers.Print(x, message="x")
    return [loss, layers.scale(before, scale=1.0)]


def drnn_net(fluid):
    """A seq2seq-style step: embedding -> dynamic_rnn whose step block
    drops out its hidden state (p 0.3) -> last step -> print -> softmax
    cross entropy, Adam."""
    layers = fluid.layers
    src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
    label = layers.data(name="label", shape=[1], dtype="int64")
    emb = layers.embedding(input=src, size=[20, 8], dtype="float32")
    rnn = layers.DynamicRNN()
    with rnn.block():
        word = rnn.step_input(emb)
        mem = rnn.memory(shape=[8], value=0.0)
        h = layers.fc(input=[word, mem], size=8, act="tanh")
        h = layers.dropout(h, dropout_prob=0.3)
        rnn.update_memory(mem, h)
        rnn.output(h)
    last = layers.sequence_last_step(input=rnn())
    last = layers.Print(last, message="last")
    pred = layers.fc(input=last, size=20, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=pred, label=label))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return [loss]


def drnn_feeds():
    rng = np.random.RandomState(5)
    return [{"src": [rng.randint(0, 20, (n,)).astype(np.int64)
                     for n in rng.randint(2, 7, B)],
             "label": rng.randint(0, 20, (B, 1)).astype(np.int64)}
            for _ in range(STEPS)]


def port_state(startup):
    scope = pfluid.Scope()
    pfluid.Executor(pfluid.CPUPlace()).run(startup, scope=scope)
    return {n: v.numpy().copy() for n, v in scope.vars.items()
            if v is not None}


def port_scope(state, main):
    return pfluid.io.state_from_numpy(state, scope=pfluid.Scope(),
                                      place=pfluid.CPUPlace(),
                                      main_program=main)


def segmented(main, feeds, fetch, scope):
    """Each feed through the segmented runner's uncaptured arm (an
    Executor on the CPU never captures, so its segmented run is that
    arm); returns (fetches per feed, the executor)."""
    exe = pfluid.Executor(pfluid.CPUPlace())
    names = [f if isinstance(f, str) else f.name for f in fetch]
    got = []
    for f in feeds:
        feed = pexec._normalize_feed(main, dict(f))
        prog = exe._at_seams(main, sorted(feed), names)
        got.append(exe._run_segmented(prog, feed, names, scope, True))
    return got, exe


def interpreted(main, feeds, fetch, scope):
    exe = pfluid.Executor(pfluid.CPUPlace())
    return [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]


def assert_bitwise(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def partition(segments):
    """What both packages' partitions must agree on."""
    return [(kind, [op.type for op in p[0]], list(p[1]), list(p[2]),
             list(p[3])) if kind == "device" else (kind, p.type)
            for kind, p in segments]


def ctr_trainer(name):
    fluid, init, names = pkg(name)
    sp = jsparse if name == "jax" else psparse
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    with names.guard(), fluid.program_guard(main, startup):
        loss = ctr_dnn(fluid, 4096, 8, 26, (32, 32, 32))
    sp.clear_tables()
    for table, dim in ((DEEP_TABLE, 8), (WIDE_TABLE, 1)):
        sp.declare_sharded_table(table, 4096, dim, ["h0:1", "h1:1"])
    tp, _ = sp.shard_program(main, startup)
    return tp, [loss.name]


@pytest.mark.parametrize("program", ["print_mlp", "ctr_sharded"])
def test_partition_equals_the_reference(program):
    if program == "print_mlp":
        (jp, _, jouts), (pp, _, pouts) = (build(n, print_mlp)
                                          for n in ("jax", "port"))
        jf, pf = [jouts[0].name], [pouts[0].name]
    else:
        (jp, jf), (pp, pf) = ctr_trainer("jax"), ctr_trainer("port")
    assert pexec.segment_breakers(pp.global_block()) == sorted(
        {op.type for op in pp.global_block().ops
         if op.type in ("print", "sharded_lookup_table",
                        "sharded_push_grad")})
    want = partition(jexec._host_program_segments(jp, jf))
    got = partition(pexec._host_program_segments(pp, pf))
    assert got == want
    kinds = [k for k, *_ in got]
    assert "host" in kinds and kinds.count("device") >= 2
    if program == "ctr_sharded":
        # the pushes read the first segment's grads on the host
        assert any(p[3] for k, *p in got if k == "device")


def test_segmented_print_mlp_matches_jax():
    jmain, jstart, jouts = build("jax", print_mlp)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(jstart)
        state = {n: np.array(np.asarray(v), copy=True)
                 for n, v in scope.vars.items() if v is not None}
        want = [float(np.asarray(exe.run(jmain, feed=f,
                                         fetch_list=jouts)[0]))
                for f in mlp_feeds()]
        jparams = {p.name: np.asarray(scope.find_var(p.name))
                   for p in jmain.all_parameters()}

    pmain, _, pouts = build("port", print_mlp)
    pscope = port_scope(state, pmain)
    got, _ = segmented(pmain, mlp_feeds(), pouts, pscope)
    np.testing.assert_allclose([float(g[0]) for g in got], want,
                               rtol=RTOL, atol=0)
    for name, w in jparams.items():
        np.testing.assert_allclose(pscope.find_var(name).numpy(), w,
                                   rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("net,feeds", [(print_mlp, mlp_feeds),
                                       (drnn_net, drnn_feeds),
                                       (alias_net, mlp_feeds)],
                         ids=["print_mlp", "dynamic_rnn_dropout",
                              "view_of_an_updated_parameter"])
def test_segmented_equals_the_interpreter_bit_for_bit(net, feeds):
    main, startup, outs = build("port", net, seed=11)
    state = port_state(startup)
    want_scope, got_scope = port_scope(state, main), port_scope(state, main)
    want = interpreted(main, feeds(), outs, want_scope)
    got, exe = segmented(main, feeds(), outs, got_scope)
    for k in range(len(outs)):
        assert_bitwise([w[k] for w in want], [g[k] for g in got])
    for p in main.all_parameters():
        assert_bitwise([want_scope.find_var(p.name).numpy()],
                       [got_scope.find_var(p.name).numpy()])
    stats = exe.segment_stats()
    assert stats["segments"] >= 2 and stats["uncaptured"] == []
    # the uncaptured arm sets each signature up once, and steps 2-3 reuse
    assert stats["captured"] == stats["segments"]


def test_segmented_while_decode_equals_the_interpreter():
    cfg = dict(mt.BOOK, dict_size=30)
    train, startup, _ = build("port", lambda f: mt.train_net(f, **cfg),
                              seed=17)
    dec, _, outs = build("port", lambda f: mt.decode_net(f, **cfg),
                         seed=17)
    state = port_state(startup)
    rng = np.random.default_rng(9)
    srcs = mt.train_batch(rng, 6, cfg["dict_size"])["src_word_id"]
    dfeed = mt.decode_feed(srcs, cfg["beam_size"])
    fetch = list(outs)
    pexec.loop_counts.update(loops=0, iterations=0, condition_reads=0)
    want = interpreted(dec, [dfeed] * 2, fetch, port_scope(state, dec))
    want_counts = dict(pexec.loop_counts)
    pexec.loop_counts.update(loops=0, iterations=0, condition_reads=0)
    got, exe = segmented(dec, [dfeed] * 2, fetch, port_scope(state, dec))
    for w, g in zip(want, got):
        assert_bitwise(w, g)
    assert dict(pexec.loop_counts) == want_counts
    assert want_counts["iterations"] == 2 * cfg["max_length"]
    (seg,) = exe._cache.values()
    assert [k for k, _ in seg.segments] == ["device", "while", "device"]
    # the body is one segment of its own
    assert exe.segment_stats()["segments"] == 3


def test_segment_breakers_name_the_ports_own():
    from paddle_tpu_torch.models import zoo as port_zoo

    port_init._auto_seed_counter[0] = 1
    with port_unique_name.guard():
        bert = port_zoo.build("bert_pretrain")
    draws = pexec.segment_breakers(bert.startup.global_block())
    assert draws and all(pexec.registry.draws_from_generator(t)
                         for t in draws)
    main, _, _ = wide_deep_sharded(pfluid)
    assert "lookup_table" in pexec.segment_breakers(main.global_block())
    assert pexec.segment_breakers(bert.main.global_block()) == []

    def ranged(fluid):
        layers = fluid.layers
        x = layers.data(name="x", shape=[4], dtype="float32")
        r = layers.tensor.range(0, 4, 1, "float32")
        return [layers.elementwise_add(layers.scale(x, scale=2.0), r)]

    main, _, outs = build("port", ranged)
    assert pexec.segment_breakers(main.global_block()) == ["range"]
    segs = pexec._host_program_segments(main, [outs[0].name])
    runners = [p[4] for k, p in segs if k == "device"]
    assert [r.reason is not None for r in runners] == [False, True, False]
    feed = {"x": np.arange(8, dtype=np.float32).reshape(2, 4)}
    want = interpreted(main, [feed], outs, pfluid.Scope())
    got, exe = segmented(main, [feed], outs, pfluid.Scope())
    assert_bitwise(want[0], got[0])
    assert [u["reason"] for u in exe.segment_stats()["uncaptured"]] == [
        "range: reads its inputs on the host"]
