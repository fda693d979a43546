"""The port's training slice against the JAX package at small size: the
training programs (forward, ``append_backward``'s grad ops and the
optimizer's update ops) equal the JAX package's op for op, and from the
JAX package's startup state the port's loss lists match the JAX
package's (``models/zoo.py::run_steps(init_state=)``) on the same feeds.

fit_a_line: 5 SGD steps, relative 1e-5 (float32 through one fc).
bert_pretrain at zoo size (1 layer, hidden 32, 2 heads, seq 16) with
dropout 0: 3 Adam steps, relative 1e-4 (float32 through softmax, layer
norm and Adam's sqrt in two frameworks).  With dropout the two packages
draw different bits by design, so dropout is held to determinism instead.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.models import bert as jax_bert
from paddle_tpu.models import zoo
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.models import bert as port_bert

B, T, M = 2, 16, 3
BERT = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
            intermediate_size=64, max_position=32, type_vocab_size=2)
BERT_FEEDS = {
    "src_ids": ((B, T), "int64"), "pos_ids": ((B, T), "int64"),
    "sent_ids": ((B, T), "int64"),
    "attn_bias": ((B, 1, 1, T), "float32"),
    "mask_pos": ((B * M, 1), "int64"),
    "mlm_label": ((B * M, 1), "int64"),
    "mlm_weight": ((B * M, 1), "float32"),
    "nsp_label": ((B, 1), "int64"),
}


@pytest.fixture(autouse=True)
def composed_jax_attention(monkeypatch):
    # the JAX side's attention runs its plain composed form, not the
    # measured kernel selection (which would time candidates on the CPU)
    monkeypatch.setitem(jax_flags._overrides, "force_attention_impl",
                        "composed")
    # and compiles its steps afresh: the persistent jit cache is shared by
    # the test workers, and one compiled under the 8-device test mesh
    # fails when another worker reads it back (ROADMAP queue 3)
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)


def _fit_a_line(fluid):
    x = fluid.layers.data(name="x", shape=[13], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1, act=None)
    loss = fluid.layers.mean(
        fluid.layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return loss, {"x": ((8, 13), "float32"), "y": ((8, 1), "float32")}


def _bert_pretrain(fluid, bert, dropout):
    cfg = bert.BertConfig(dropout=dropout, **BERT)
    loss, _ = bert.bert_pretrain(cfg, max_seq_len=T)
    fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return loss, BERT_FEEDS


def build(pkg, name, dropout=0.1):
    """(main, startup, loss, feeds) of a training program built by the
    JAX package (pkg "jax") or the port, under a fresh name generator and
    seed counter, as ``models/zoo.py`` builds it."""
    fluid, bert, init, names = (
        (jfluid, jax_bert, jax_init, jax_unique_name) if pkg == "jax"
        else (pfluid, port_bert, port_init, port_unique_name))
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    with names.guard(), fluid.program_guard(main, startup):
        if name == "fit_a_line":
            loss, feeds = _fit_a_line(fluid)
        else:
            loss, feeds = _bert_pretrain(fluid, bert, dropout)
    return main, startup, loss, feeds


def _signature(prog):
    blocks = []
    for blk in prog.blocks:
        ops = [(op.type, {k: list(v) for k, v in op.inputs.items()},
                {k: list(v) for k, v in op.outputs.items()}, op.attrs)
               for op in blk.ops]
        vs = {n: (v.shape, v.dtype, v.persistable)
              for n, v in blk.vars.items()}
        blocks.append((ops, vs))
    return blocks


@pytest.mark.parametrize("name", ["fit_a_line", "bert_pretrain"])
def test_training_program_equals_jax_program(name):
    jmain, jstart, jloss, _ = build("jax", name)
    pmain, pstart, ploss, _ = build("port", name)
    assert ploss.name == jloss.name
    types = {op.type for op in pmain.global_block().ops}
    assert "generic_grad" in types
    assert ("adam" if name == "bert_pretrain" else "sgd") in types
    for jp, pp in ((jmain, pmain), (jstart, pstart)):
        js, ps = _signature(jp), _signature(pp)
        assert len(js) == len(ps)
        for (jops, jvars), (pops, pvars) in zip(js, ps):
            assert pvars == jvars
            assert len(pops) == len(jops)
            for jo, po in zip(jops, pops):
                assert po == jo


def _jax_state_and_losses(name, steps, dropout=0.0):
    """The JAX package's startup state (zoo.snapshot_startup) and its
    loss list over `steps` from that state (zoo.run_steps)."""
    main, startup, loss, feeds = build("jax", name, dropout)
    zp = zoo.ZooProgram(name, main, startup, feeds, [loss.name])
    state = zoo.snapshot_startup(zp)
    return state, zoo.run_steps(zp, steps=steps, init_state=state), \
        zoo.example_feed_arrays(zp)


def port_losses(name, state, feed, steps, dropout=0.0, seed=0,
                save_to=None):
    main, _, loss, _ = build("port", name, dropout)
    main.random_seed = seed
    scope = pfluid.io.state_from_numpy(state, scope=pfluid.Scope(),
                                       place=pfluid.CPUPlace(),
                                       main_program=main)
    exe = pfluid.Executor(pfluid.CPUPlace())
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    if save_to is not None:
        with pfluid.scope_guard(scope):
            pfluid.io.save_persistables(exe, save_to, main_program=main)
    return losses


@pytest.mark.parametrize("name,steps,rtol", [("fit_a_line", 5, 1e-5),
                                             ("bert_pretrain", 3, 1e-4)])
def test_port_losses_match_jax_from_its_startup_state(name, steps, rtol):
    state, want, feed = _jax_state_and_losses(name, steps)
    got = port_losses(name, state, feed, steps)
    assert len(got) == steps and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    assert got[-1] < got[0]


def test_port_bert_dropout_is_deterministic_per_seed():
    state, _, feed = _jax_state_and_losses("bert_pretrain", 0)
    plain = port_losses("bert_pretrain", state, feed, 2)
    first = port_losses("bert_pretrain", state, feed, 2, dropout=0.1)
    again = port_losses("bert_pretrain", state, feed, 2, dropout=0.1)
    other = port_losses("bert_pretrain", state, feed, 2, dropout=0.1,
                        seed=7)
    assert first == again
    assert first[0] != plain[0] and first != other
    assert np.all(np.isfinite(first + other))


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """save_persistables after two port steps loads in the JAX package,
    whose next step gives the port's third loss (relative 1e-4)."""
    state, _, feed = _jax_state_and_losses("bert_pretrain", 0)
    want = port_losses("bert_pretrain", state, feed, 3)
    port_losses("bert_pretrain", state, feed, 2, save_to=str(tmp_path))
    main, startup, loss, _ = build("jax", "bert_pretrain", 0.0)
    exe = jfluid.Executor()
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.io.load_persistables(exe, str(tmp_path), main_program=main)
        (got,) = exe.run(main, feed=feed, fetch_list=[loss])
    np.testing.assert_allclose(float(np.asarray(got)), want[2], rtol=1e-4)
