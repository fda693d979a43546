"""The port's RNN slice against the JAX package on the CPU, on the same
seeded numpy inputs:

- the plain versions of K8 (LSTM cell), K9 (GRU output gate) and K7
  (masked softmax), through the port's wrappers and their autograd
  backward, against the Pallas kernels in interpret mode and their
  ``jax.vjp``, at the kernels' own domain (B = 8, D = 128; T = 128);
- the ops of the slice (``lstm``, ``lstmp``, ``gru``, ``gru_unit``,
  ``lstm_unit``, ``sequence_pool``, ``sequence_softmax``,
  ``cross_entropy``, ``mean``, ``concat``, ``fill_constant_batch_size_like``,
  ``sequence_mask``, ``sequence_expand``, ``dynamic_rnn``) against the JAX
  registry's kernels;
- the seq2seq model of Paddle's book (bi-LSTM encoder, DynamicRNN decoder):
  its training and startup programs equal the JAX package's op for op,
  and from the JAX package's startup state 3 Adam steps give the JAX
  package's losses (relative 1e-5 at step 1, 1e-4 at step 3), at hidden
  128 where the JAX side runs K8 in interpret mode;
- the GRU and sequence-softmax programs (``paddle_tpu_torch/models/
  rnn.py``, which chip_smoke.py runs on the card), 3 SGD steps against
  the JAX package's.

Tolerances: atol 1e-5 for kernels and ops (float32 on both sides; the
frameworks take transcendentals and sums in different orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu.core import framework as jax_framework
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch.core import framework as port_framework
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.ops import registry as port_registry
from paddle_tpu_torch.ops import rnn_kernels, sequence_kernels

# the port's builders of the programs chip_smoke.py runs on the card; they
# take the fluid module as an argument, so both packages build them here
from paddle_tpu_torch.models.rnn import (gru_net, seq2seq_batch,
                                         seq_softmax_net, seq_to_seq_net)

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_jax_steps(monkeypatch):
    # the JAX side compiles its steps afresh: the persistent jit cache is
    # shared by the test workers (ROADMAP queue 3)
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)


def f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# K8, K9, K7: plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _kernel_case(name):
    """(port fn, jax fn, numpy inputs) of one kernel at its own domain."""
    rng = np.random.RandomState(11)
    b, d = 8, 128
    if name == "lstm_cell":
        return (rnn_kernels.fused_lstm_cell,
                lambda g, c: pk.fused_lstm_cell(g, c, interpret=True),
                [f32(rng, b, 4 * d, scale=2.0), f32(rng, b, d)])
    if name.startswith("gru_output"):
        mode = name.endswith("origin")
        return (lambda u, c, h: rnn_kernels.fused_gru_output(u, c, h, mode),
                lambda u, c, h: pk.fused_gru_output(u, c, h, mode,
                                                    interpret=True),
                [f32(rng, b, d, scale=2.0) for _ in range(3)])
    lens = np.array([128, 0, 1, 64, 127, 100, 3, 128], np.int32)
    mask = (np.arange(128)[None, :] < lens[:, None]).astype(np.float32)
    return (lambda x: sequence_kernels.masked_softmax(
                x, torch.from_numpy(lens)),
            lambda x: pk.masked_softmax(x, jnp.asarray(mask),
                                        interpret=True),
            [f32(rng, b, 128, scale=3.0)])


@pytest.mark.parametrize("name", ["lstm_cell", "gru_output",
                                  "gru_output_origin", "masked_softmax"])
def test_kernel_plain_matches_pallas_interpret(name):
    port_fn, jax_fn, arrays = _kernel_case(name)
    want, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in arrays])
    want = want if isinstance(want, tuple) else (want,)
    rng = np.random.RandomState(5)
    cots = [f32(rng, *np.shape(w)) for w in want]
    want_grads = vjp(tuple(jnp.asarray(c) for c in cots)
                     if len(cots) > 1 else jnp.asarray(cots[0]))

    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = port_fn(*leaves)
    got = got if isinstance(got, tuple) else (got,)
    grads = torch.autograd.grad(got, leaves,
                                [torch.from_numpy(c) for c in cots])
    for g, w in zip(got + grads, want + tuple(want_grads)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=RTOL)
    if name == "masked_softmax":          # the zero-length row is all 0
        assert not got[0][1].detach().any()


def test_kernel_wrappers_refuse_what_the_kernel_does_not_take():
    g = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="not \\[B, 4D\\]"):
        rnn_kernels.fused_lstm_cell(g, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="all \\[B, D\\]"):
        rnn_kernels.fused_gru_output(g, g, torch.zeros(3, 8))
    with pytest.raises(ValueError, match="lengths"):
        sequence_kernels.masked_softmax(g, torch.zeros(3, dtype=torch.int32))
    # no launch happens for a CPU tensor
    assert rnn_kernels.fused_lstm_cell.launches == 0
    assert sequence_kernels.masked_softmax.launches == 0


# ---------------------------------------------------------------------------
# ops against the JAX registry's kernels
# ---------------------------------------------------------------------------

def _op_cases():
    rng = np.random.RandomState(7)
    b, t, d = 3, 6, 8
    lens = np.array([6, 2, 4], np.int32)
    lens0 = np.array([6, 0, 4], np.int32)
    h0, c0 = f32(rng, b, d), f32(rng, b, d)

    def lstm_ins(peep, proj=None):
        ins = {"Input": [f32(rng, b, t, 4 * d)],
               "Weight": [f32(rng, proj or d, 4 * d, scale=0.3)],
               "Bias": [f32(rng, 1, 7 * d if peep else 4 * d)],
               "SeqLen": [lens]}
        if proj:
            ins["ProjWeight"] = [f32(rng, d, proj, scale=0.3)]
        return ins

    def gru_ins():
        return {"Input": [f32(rng, b, t, 3 * d)],
                "Weight": [f32(rng, d, 3 * d, scale=0.3)],
                "Bias": [f32(rng, 1, 3 * d)], "SeqLen": [lens]}

    probs = np.abs(f32(rng, b, t, 5)) + 0.05
    probs /= probs.sum(-1, keepdims=True)
    label = rng.randint(0, 5, (b, t, 1)).astype(np.int64)
    label[0, 1, 0] = -100                        # ignore_index
    lod2 = f32(rng, 2, 3, 4, 5)
    cases = [
        ("lstm", lstm_ins(False), {"use_peepholes": False}),
        ("lstm", lstm_ins(False), {"use_peepholes": False,
                                   "is_reverse": True}),
        ("lstm", lstm_ins(True), {"use_peepholes": True}),
        ("lstm", dict(lstm_ins(True), H0=[h0], C0=[c0]),
         {"use_peepholes": True, "is_reverse": True,
          "gate_activation": "sigmoid", "cell_activation": "relu"}),
        ("lstmp", lstm_ins(False, proj=4), {"use_peepholes": False,
                                            "is_reverse": True}),
        ("gru", gru_ins(), {}),
        ("gru", dict(gru_ins(), H0=[h0]), {"origin_mode": True,
                                           "is_reverse": True}),
        ("gru", gru_ins(), {"activation": "relu"}),
        ("gru_unit", {"Input": [f32(rng, b, 3 * d)], "HiddenPrev": [h0],
                      "Weight": [f32(rng, d, 3 * d)],
                      "Bias": [f32(rng, 1, 3 * d)]},
         {"activation": 2, "gate_activation": 1, "origin_mode": True}),
        ("lstm_unit", {"X": [f32(rng, b, 4 * d)], "C_prev": [c0]},
         {"forget_bias": 0.5}),
        ("cross_entropy", {"X": [probs], "Label": [label],
                           "SeqLen": [lens0]}, {}),
        ("cross_entropy", {"X": [probs], "Label": [probs]},
         {"soft_label": True}),
        ("mean", {"X": [f32(rng, b, t, 2)], "SeqLen": [lens0]}, {}),
        ("sigmoid", {"X": [f32(rng, b, d, scale=3.0)]}, {}),
        ("concat", {"X": [f32(rng, b, 2), f32(rng, b, 5)]}, {"axis": 1}),
        ("fill_constant_batch_size_like", {"Input": [f32(rng, b, d)]},
         {"shape": [-1, 4], "value": 0.5, "dtype": "float32",
          "input_dim_idx": 0, "output_dim_idx": 0}),
        ("sequence_mask", {"X": [lens]}, {"maxlen": t,
                                          "out_dtype": "float32"}),
        ("sequence_expand", {"X": [f32(rng, b, d)],
                             "Y": [f32(rng, b, t, 2)],
                             "YSeqLen": [lens0]}, {}),
        ("sequence_expand_as", {"X": [f32(rng, b, d)],
                                "Y": [f32(rng, b, t, 2)],
                                "YSeqLen": [lens]}, {}),
        ("sequence_softmax", {"X": [f32(rng, b, t, 1, scale=3.0)],
                              "SeqLen": [lens0]}, {}),
        ("sequence_softmax", {"X": [f32(rng, b, 128)],
                              "SeqLen": [np.array([128, 0, 77],
                                                  np.int32)]}, {}),
        ("sequence_pool", {"X": [lod2],
                           "SeqLen": [np.array([3, 2], np.int32)],
                           "SeqLen2": [np.array([[4, 1, 2], [3, 0, 0]],
                                                np.int32)]},
         {"pooltype": "MAX"}),
    ]
    x = f32(rng, b, t, d)
    for ptype in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"):
        cases.append(("sequence_pool", {"X": [x], "SeqLen": [lens0]},
                      {"pooltype": ptype}))
    return cases


OP_CASES = _op_cases()


@pytest.mark.parametrize("op_type,ins,attrs", OP_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(OP_CASES)])
def test_port_op_matches_jax(op_type, ins, attrs, monkeypatch):
    # the JAX side's sequence_softmax takes its composed form, not the
    # measured kernel selection (which would time candidates on the CPU)
    monkeypatch.setitem(jax_flags._overrides, "use_pallas",
                        op_type != "sequence_softmax")
    want = jax_registry.run_op(
        op_type, {s: [jnp.asarray(v) for v in vs] for s, vs in ins.items()},
        dict(attrs))
    got = port_registry.run_op(
        op_type, {s: [torch.from_numpy(np.array(v)) for v in vs]
                  for s, vs in ins.items()}, dict(attrs))
    assert set(want) <= set(got)
    for slot, wv in want.items():
        for w, g in zip(wv, got[slot]):
            w, g = np.asarray(w), g.detach().numpy()
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{op_type}:{slot}")


def test_reverse_lstm_holds_h0_c0_over_a_short_rows_pad():
    """A short row's reverse scan starts on pad positions: its h and c stay
    at h0 and c0 until its real last token, and its outputs there are 0."""
    rng = np.random.RandomState(3)
    d = 4
    h0, c0 = f32(rng, 2, d), f32(rng, 2, d)
    ins = {"Input": [torch.from_numpy(f32(rng, 2, 5, 4 * d))],
           "Weight": [torch.from_numpy(f32(rng, d, 4 * d))],
           "Bias": [torch.from_numpy(f32(rng, 1, 4 * d))],
           "SeqLen": [torch.tensor([5, 2], dtype=torch.int32)],
           "H0": [torch.from_numpy(h0)], "C0": [torch.from_numpy(c0)]}
    attrs = {"use_peepholes": False, "is_reverse": True}
    out = port_registry.run_op("lstm", ins, attrs)
    assert not out["Hidden"][0][1, 2:].any()
    # the short row alone, unpadded, gives the same first two steps
    short = {k: [v[0][1:2]] for k, v in ins.items() if k != "Weight"
             and k != "Bias"}
    short["Input"] = [ins["Input"][0][1:2, :2]]
    short.update(Weight=ins["Weight"], Bias=ins["Bias"],
                 SeqLen=[torch.tensor([2], dtype=torch.int32)])
    alone = port_registry.run_op("lstm", short, attrs)
    np.testing.assert_allclose(out["Hidden"][0][1, :2].numpy(),
                               alone["Hidden"][0][0].numpy(), atol=1e-6)


def _drnn_program(fluid, names):
    """A two-memory DynamicRNN over a lod input with a Static context and
    an fc: (program, dynamic_rnn op)."""
    main, startup = fluid.Program(), fluid.Program()
    with names.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32",
                              lod_level=1)
        ctx = fluid.layers.data(name="ctx", shape=[2], dtype="float32")
        boot = fluid.layers.data(name="boot", shape=[4], dtype="float32")
        rnn = fluid.layers.DynamicRNN()
        with rnn.block():
            xt = rnn.step_input(x)
            c = rnn.static_input(ctx)
            h = rnn.memory(init=boot)
            s = rnn.memory(shape=[4], value=0.5)
            nh = fluid.layers.fc(input=[xt, h, c], size=4, act="tanh")
            ns = fluid.layers.sums(input=[s, nh])
            rnn.update_memory(h, nh)
            rnn.update_memory(s, ns)
            rnn.output(nh, ns)
        rnn()
    op = next(o for o in main.global_block().ops if o.type == "dynamic_rnn")
    return main, op


def test_dynamic_rnn_op_matches_jax():
    jmain, jop = _drnn_program(jfluid, jax_unique_name)
    pmain, pop = _drnn_program(pfluid, port_unique_name)
    rng = np.random.RandomState(9)
    vals = {"x": f32(rng, 3, 5, 3), "x@SEQ_LEN": np.array([5, 1, 3],
                                                          np.int32),
            "ctx": f32(rng, 3, 2), "boot": f32(rng, 3, 4)}
    for op in (jop, pop):
        for n in op.input_arg_names:
            if n not in vals:              # fc weights and biases, the
                shape = op.block._find_var_recursive(n).shape   # mem init
                vals[n] = f32(rng, *[3 if s == -1 else s for s in shape])
    assert pop.inputs == jop.inputs
    want = jax_registry.run_op(
        "dynamic_rnn", {s: [jnp.asarray(vals[n]) for n in ns]
                        for s, ns in jop.inputs.items()}, jop.attrs)
    got = port_registry.run_op(
        "dynamic_rnn", {s: [torch.from_numpy(vals[n]) for n in ns]
                        for s, ns in pop.inputs.items()}, pop.attrs)
    for w, g in zip(want["Out"], got["Out"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)
    assert not got["Out"][0][1, 1:].any()         # past row 1's length


# ---------------------------------------------------------------------------
# seq2seq (tests/book/test_rnn_encoder_decoder.py), the GRU and the
# sequence-softmax programs: program equality and losses
# ---------------------------------------------------------------------------

S2S = dict(dict_size=40, emb=16, hidden=128)


def build(pkg, name, **sizes):
    """(main, startup, loss) of a training program built by the JAX
    package (pkg "jax") or the port, under a fresh name generator and
    seed counter."""
    fluid, init, names = (
        (jfluid, jax_init, jax_unique_name) if pkg == "jax"
        else (pfluid, port_init, port_unique_name))
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    with names.guard(), fluid.program_guard(main, startup):
        if name == "seq2seq":
            loss, _ = seq_to_seq_net(fluid, **sizes)
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        else:
            loss = gru_net(fluid, **sizes) if name == "gru" \
                else seq_softmax_net(fluid, **sizes)
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss


def _signature(prog, block_type):
    """Per block: ops as (type, inputs, outputs, attrs) with each Block
    attr as its index, and vars as (shape, dtype, lod_level)."""
    def attr(v):
        return ("block", v.idx) if isinstance(v, block_type) else v

    return [([(op.type, {k: list(v) for k, v in op.inputs.items()},
               {k: list(v) for k, v in op.outputs.items()},
               {k: attr(v) for k, v in op.attrs.items()})
              for op in blk.ops],
             {n: (v.shape, v.dtype, v.lod_level) for n, v in blk.vars.items()})
            for blk in prog.blocks]


@pytest.mark.parametrize("name,sizes", [
    ("seq2seq", S2S), ("gru", dict(dict_size=30, hidden=8,
                                   origin_mode=True)),
    ("seq_softmax", dict(width=6))])
def test_program_equals_jax_program(name, sizes):
    jmain, jstart, jloss = build("jax", name, **sizes)
    pmain, pstart, ploss = build("port", name, **sizes)
    assert ploss.name == jloss.name
    for jp, pp in ((jmain, pmain), (jstart, pstart)):
        js = _signature(jp, jax_framework.Block)
        ps = _signature(pp, port_framework.Block)
        assert len(ps) == len(js)
        for (jops, jvars), (pops, pvars) in zip(js, ps):
            assert pvars == jvars
            assert len(pops) == len(jops)
            for jo, po in zip(jops, pops):
                assert po == jo


def _feed(name, seed):
    rng = np.random.RandomState(seed)
    if name == "seq2seq":
        return seq2seq_batch(rng, 4, S2S["dict_size"], 2, 6)
    if name == "gru":
        return {"words": [rng.randint(0, 30, (n,)).astype(np.int64)
                          for n in (5, 1, 3)]}
    return {"x": [f32(rng, n, 6) for n in (7, 2, 4)]}


def _jax_losses(name, sizes, feeds):
    """The JAX package's startup state and its losses over `feeds`."""
    main, startup, loss = build("jax", name, **sizes)
    exe = jfluid.Executor()
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        state = {n: np.array(np.asarray(v), copy=True)
                 for n, v in scope.vars.items() if v is not None}
        losses = [float(np.asarray(exe.run(main, feed=f,
                                           fetch_list=[loss])[0]))
                  for f in feeds]
    return state, losses


@pytest.mark.parametrize("name,sizes,rtol", [
    ("seq2seq", S2S, {1: 1e-5, 3: 1e-4}),
    ("gru", dict(dict_size=30, hidden=128, origin_mode=False),
     {1: 1e-5, 3: 1e-4}),
    ("gru", dict(dict_size=30, hidden=8, origin_mode=True),
     {1: 1e-5, 3: 1e-4}),
    ("seq_softmax", dict(width=6), {1: 1e-5, 3: 1e-4})])
def test_port_losses_match_jax_from_its_startup_state(name, sizes, rtol):
    feeds = [_feed(name, s) for s in range(3)]
    state, want = _jax_losses(name, sizes, feeds)
    main, _, loss = build("port", name, **sizes)
    scope = pfluid.io.state_from_numpy(state, scope=pfluid.Scope(),
                                       place=pfluid.CPUPlace(),
                                       main_program=main)
    exe = pfluid.Executor(pfluid.CPUPlace())
    got = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
           for f in feeds]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[0], want[0], rtol=rtol[1], atol=0)
    np.testing.assert_allclose(got, want, rtol=rtol[3], atol=0)
