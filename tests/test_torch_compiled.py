"""The port's compiled step on the CPU (``core/executor.py``:
``_CompiledBlock``, ``_ProgramCache``, ``capturable``) and the device-step
form of the random ops' key (``ops/registry.py``: ``DeviceSeed``).

The CPU has no CUDA graph, so the tests drive ``_CompiledBlock`` with
``use_graph=False``: the same bookkeeping a capture runs (static feed
buffers, state bound to adopted buffers and written back in place, fetch
copies, the device step word), op by op at every run.  The graph itself
is held on the card by ``chip_smoke.py``'s ``compiled_step_phase``.

- The state sets equal the reference ``_CompiledBlock``'s (``use_jit=
  False``) for the zoo's bert_pretrain, transformer and resnet_cifar10.
- Four Adam steps of a 2-layer bert_pretrain (dropout 0) through the
  block give ``Executor.run``'s losses bit for bit, and the JAX
  package's within ``test_torch_training.py``'s 1e-4; the Scope keeps
  its tensors, and a tensor swapped in between steps is read.
- ``op_seed``'s device-step form draws the host int's bits.
- Which programs are captured, and how signatures are counted.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu.core import executor as jexec
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.models import bert as jax_bert
from paddle_tpu.models import zoo as jax_zoo
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch.core import executor as pexec
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.models import zoo as port_zoo
from paddle_tpu_torch.ops import attention_kernels as ak
from paddle_tpu_torch.ops import dropout_kernels as dk
from paddle_tpu_torch.ops import registry

CPU = torch.device("cpu")
B, T, M = 2, 16, 3
BERT2 = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position=32, type_vocab_size=2,
             dropout=0.0)
BERT_FEEDS = {
    "src_ids": ((B, T), "int64"), "pos_ids": ((B, T), "int64"),
    "sent_ids": ((B, T), "int64"),
    "attn_bias": ((B, 1, 1, T), "float32"),
    "mask_pos": ((B * M, 1), "int64"),
    "mlm_label": ((B * M, 1), "int64"),
    "mlm_weight": ((B * M, 1), "float32"),
    "nsp_label": ((B, 1), "int64"),
}
STEPS = 4


@pytest.fixture(autouse=True)
def composed_jax_attention(monkeypatch):
    # as test_torch_training.py: the JAX side's attention in its plain
    # composed form, compiled afresh
    monkeypatch.setitem(jax_flags._overrides, "force_attention_impl",
                        "composed")
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)


def build_zoo(name, pkg):
    zoo, init, names = (jax_zoo, jax_init, jax_unique_name) if pkg == "jax" \
        else (port_zoo, port_init, port_unique_name)
    init._auto_seed_counter[0] = 1
    with names.guard():
        return zoo.build(name)


@pytest.mark.parametrize("name", ["bert_pretrain", "transformer",
                                  "resnet_cifar10"])
def test_state_sets_equal_the_reference(name):
    j, p = build_zoo(name, "jax"), build_zoo(name, "port")
    feeds = sorted(j.feeds)
    ref = jexec._CompiledBlock(j.main, feeds, j.fetch_names, use_jit=False)
    got = pexec._CompiledBlock(p.main, feeds, p.fetch_names, device=CPU,
                               use_graph=False)
    for attr in ("state_in", "state_out", "donated_in", "readonly_in"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    assert got.donated_in and got.readonly_in


def build_bert(pkg):
    fluid, bert, init, names = (
        (jfluid, jax_bert, jax_init, jax_unique_name) if pkg == "jax"
        else (pfluid, port_bert, port_init, port_unique_name))
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    with names.guard(), fluid.program_guard(main, startup):
        loss, _ = bert.bert_pretrain(bert.BertConfig(**BERT2), max_seq_len=T)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return main, startup, loss


@pytest.fixture(scope="module")
def jax_bert_run():
    """The JAX package's startup state, feed and 4 losses."""
    main, startup, loss = build_bert("jax")
    zp = jax_zoo.ZooProgram("bert2", main, startup, BERT_FEEDS, [loss.name])
    state = jax_zoo.snapshot_startup(zp)
    losses = jax_zoo.run_steps(zp, steps=STEPS, init_state=state)
    return state, jax_zoo.example_feed_arrays(zp), losses


def port_scope(state, main):
    return pfluid.io.state_from_numpy(
        {n: np.array(v) for n, v in state.items()}, scope=pfluid.Scope(),
        place=pfluid.CPUPlace(), main_program=main)


def halve(scope, name):
    """Swap a new tensor (the value halved) into the Scope."""
    scope.set_var(name, scope.find_var(name) * 0.5)


def test_uncaptured_block_equals_the_interpreter_and_jax(jax_bert_run):
    state, feed, want = jax_bert_run
    main, _, loss = build_bert("port")
    fetch = [loss.name]
    program = pexec.Executor._at_seams(main, sorted(feed), fetch)
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = port_scope(state, main)
    plain = [float(exe.run(main, feed=feed, fetch_list=fetch,
                           scope=scope)[0]) for _ in range(STEPS)]
    assert exe.compile_count == 0 and len(exe._cache) == 0

    block = pexec._CompiledBlock(program, sorted(feed), fetch, device=CPU,
                                 use_graph=False)
    scope = port_scope(state, main)
    got, ids = [], None
    for step in range(STEPS):
        (value,) = block.run(feed, scope, step)
        got.append(float(value))
        held = {n: id(scope.find_var(n)) for n in block.state_out}
        assert ids is None or held == ids      # the Scope keeps its tensors
        ids = held
    assert got == plain
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert got[-1] < got[0]
    assert block.compile_count == 1

    # a tensor swapped into the Scope between steps is read by the next
    param = main.all_parameters()[0].name
    runs = []
    for arm in ("interpreter", "block"):
        scope = port_scope(state, main)
        exe = pfluid.Executor(pfluid.CPUPlace())
        block = pexec._CompiledBlock(program, sorted(feed), fetch,
                                     device=CPU, use_graph=False)
        out = []
        for step in range(3):
            if step == 2:
                halve(scope, param)
            out.append(float((exe.run(main, feed=feed, fetch_list=fetch,
                                      scope=scope) if arm == "interpreter"
                              else block.run(feed, scope, step))[0]))
        runs.append(out)
    assert runs[0] == runs[1]
    assert runs[0][2] != plain[2]


@pytest.mark.parametrize("step", [0, 1, 12345, 2**20])
def test_device_step_keys_draw_the_host_bits(step):
    word = torch.tensor([step], dtype=torch.int64)
    attrs = {"seed": 0, "op_seed": 11}
    seeds = {}
    for form in ("host", "device"):
        ctx = registry.ExecContext(seed=5, step=step, step_word=(
            word if form == "device" else None))
        with registry.exec_context(ctx):
            seeds[form] = registry.op_seed(attrs)
    host, dev = seeds["host"], seeds["device"]
    assert isinstance(host, int) and isinstance(dev, registry.DeviceSeed)
    k0, k1 = registry.seed_key(dev)
    assert (int(k0), int(k1)) == registry.seed_key(host)
    assert registry.launch_key(dev, CPU) == \
        registry.seed_key(dev.base) + (word.data_ptr(),)
    assert registry.launch_key(host, CPU) == registry.seed_key(host) + (None,)
    for shape, p in (((7, 33), 0.1), ((3, 5, 17), 0.5)):
        assert torch.equal(registry.dropout_keep(dev, shape, p, CPU),
                           registry.dropout_keep(host, shape, p, CPU))
        x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
        assert torch.equal(dk.fused_dropout_reference(x, p, dev),
                           dk.fused_dropout_reference(x, p, host))
        assert torch.equal(dk.fused_dropout_fwd(x, p, dev),
                           dk.fused_dropout_fwd(x, p, host))
    assert torch.equal(ak.philox_keep_mask(dev, 6, 9, 13, 0.1),
                       ak.philox_keep_mask(host, 6, 9, 13, 0.1))
    q, k, v = (torch.randn(1, 2, 9, 8, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3))
    assert torch.equal(
        ak.flash_attention(q, k, v, dropout_p=0.1, seed=dev),
        ak.flash_attention(q, k, v, dropout_p=0.1, seed=host))


def test_launch_key_refuses_a_step_word_off_the_kernels_device():
    seed = registry.DeviceSeed(3, torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="step word"):
        registry.launch_key(seed, torch.device("cuda", 0))


def test_capture_eligibility():
    from paddle_tpu_torch import sparse
    from paddle_tpu_torch.compiler import CompiledProgram
    from paddle_tpu_torch.distributed.host_ops import is_host_op
    from paddle_tpu_torch.models.ctr import wide_deep_sharded
    from paddle_tpu_torch.models.rnn import seq_to_seq_net

    bert = build_zoo("bert_pretrain", "port")
    assert pexec.capturable(bert.main)
    assert not pexec.capturable(bert.startup)      # generator draws
    main, startup, _ = wide_deep_sharded(pfluid)
    assert not pexec.capturable(main)              # is_sparse lookups
    sparse.declare_sharded_table("wd_table", 2048, 16, ["127.0.0.1:1"])
    sharded, _ = sparse.shard_program(main, startup)
    assert any(is_host_op(op.type) for op in sharded.global_block().ops)
    assert not pexec.capturable(sharded)
    rnn, rnn_startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(rnn, rnn_startup):
        seq_to_seq_net(pfluid, 50, 8, 8)
    assert any(op.type == "dynamic_rnn" for op in rnn.global_block().ops)
    # dynamic_rnn loops the feed's padded length and reads nothing on the
    # host: captured whole; the sharded program's refusals are host ops
    assert pexec.capturable(rnn)
    assert pexec.capture_refusals(sharded) and all(
        is_host_op(t) for t in pexec.capture_refusals(sharded))

    # the CPU interprets every program, a CompiledProgram too
    exe = pfluid.Executor(pfluid.CPUPlace())
    assert not exe._captured(bert.main)
    exe.device = torch.device("cuda", 0)    # the decision alone, no card
    assert exe._captured(bert.main)
    # a CUDA place runs every program on the segmented runner: a
    # capturable one is one segment, captured whole
    assert exe._captured(rnn) and exe._captured(sharded)
    (seg,) = pexec._host_program_segments(rnn, [])
    assert seg[0] == "device" and seg[1][4].reason is None
    assert len(pexec._host_program_segments(sharded, [])) > 1
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = pfluid.Scope()
    exe.run(bert.startup, scope=scope)
    feed = port_zoo.example_feed_arrays(bert)
    compiled = CompiledProgram(bert.main).with_data_parallel(
        places=[pfluid.CPUPlace()])
    exe.run(compiled, feed=feed, fetch_list=bert.fetch_names, scope=scope)
    exe.precompile(compiled, feed=feed, fetch_list=bert.fetch_names,
                   scope=scope)
    exe.run(bert.main, feed=feed, fetch_list=bert.fetch_names, scope=scope)
    exe.precompile(bert.main, feed=feed, fetch_list=bert.fetch_names,
                   scope=scope)
    assert exe.compile_count == 0 and len(exe._cache) == 0


def zoo_block(zp, state):
    program = pexec.Executor._at_seams(zp.main, sorted(zp.feeds),
                                       zp.fetch_names)
    block = pexec._CompiledBlock(program, sorted(zp.feeds), zp.fetch_names,
                                 device=CPU, use_graph=False)
    return block, port_scope(state, zp.main)


def batch_of(feed, b):
    """The bert_pretrain feed at batch b (rows repeated)."""
    out = {}
    for n, v in feed.items():
        rows = B * M if n in ("mask_pos", "mlm_label", "mlm_weight") else B
        reps = -(-b // B)
        out[n] = np.concatenate([v] * reps)[:rows // B * b]
    return out


def test_signatures_are_counted_and_the_cache_keeps_evicted_counts():
    zp = build_zoo("bert_pretrain", "port")
    state = port_zoo.snapshot_startup(zp, place=pfluid.CPUPlace())
    feed = port_zoo.example_feed_arrays(zp)
    block, scope = zoo_block(zp, state)
    for step, b in enumerate((2, 2, 4, 2, 4)):
        block.run(batch_of(feed, b), scope, step)
    assert block.compile_count == 2          # one per new signature
    with registry.test_mode():               # test mode is a signature
        block.run(feed, scope, 5)
    assert block.compile_count == 3

    # precompile: counted once, the Scope left as it is
    block, scope = zoo_block(zp, state)
    before = {n: (t, t.clone()) for n, t in scope.vars.items()}
    block.precompile(feed, scope, 0)
    assert block.compile_count == 1
    assert {n: t for n, (t, _) in before.items()} == scope.vars
    assert all(torch.equal(t, c) for t, c in before.values())
    block.precompile(feed, scope, 0)
    block.run(feed, scope, 0)
    assert block.compile_count == 1

    cache = pexec._ProgramCache(2)
    blocks = []
    for i in range(3):
        blk, sc = zoo_block(zp, state)
        for b in (2, 4)[:i + 1]:
            blk.run(batch_of(feed, b), sc, 0)
        cache.put(i, blk)
        blocks.append(blk)
    assert len(cache) == 2 and cache.get(0) is None
    assert cache.evicted_compiles == 1       # the evicted block's count
    assert blocks[0]._steps == {}            # and its buffers freed
    total = cache.evicted_compiles + sum(c.compile_count
                                         for c in cache.values())
    assert total == 1 + 2 + 2
    cache.clear()
    assert cache.evicted_compiles == 5 and len(cache) == 0
