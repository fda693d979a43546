"""The book's sequence-labelling flows on the port against the JAX package
on the CPU, each from the JAX package's start state on the same seeded
numpy batches:

- the semantic-role labeller (``models/label_semantic_roles.py`` at the
  repo test's sizes: dictionaries 40/10/9, hidden 64, depth 4, with its
  frozen pretrained ``emb`` made from a seed): 3 Adam steps under
  ``exponential_decay``, losses within 1e-5 relative; ``emb`` unchanged
  by them; then ``crf_decoding``'s paths in the decode program: equal;
- the recommender (``models/recommender_system.py`` at the repo test's
  sizes): 3 SGD steps, losses within 1e-5 relative;
- the hierarchical-text flow over level-3 LoD (corpus -> document ->
  sentence -> token, the repo's ``tests/book/test_hierarchical_text.py``):
  3 Adam steps within 1e-5 relative, then saved, loaded and inferred
  through each package's io: probabilities within 1e-5;
- K8's activation arms through the plain version: the ``lstm`` op under
  every (gate, cell, candidate) set of the ``_ACT`` activations, with
  peepholes, forward and reverse, against the JAX package's composed
  ``_lstm_scan``: Hidden and Cell within 1e-5 (absolute and relative),
  each step taken through ``rnn_kernels.lstm_step``; the SRL's set
  (sigmoid gates, sigmoid cell, relu candidate) also without peepholes
  and through the generic grad, within 1e-5 relative (atol 1e-6).
"""

import itertools
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.models import label_semantic_roles as srl
from paddle_tpu_torch.models import recommender_system as rec
from paddle_tpu_torch.ops import registry as port_registry
from paddle_tpu_torch.ops import rnn_kernels

RTOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_jax_steps(monkeypatch):
    # the JAX side compiles its steps afresh: the persistent jit cache is
    # shared by the test workers (ROADMAP queue 3)
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)


def pkg(name):
    return (jfluid, jax_init, jax_unique_name) if name == "jax" else \
        (pfluid, port_init, port_unique_name)


def build(name, net, seed=11):
    fluid, init, names = pkg(name)
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with names.guard(), fluid.program_guard(main, startup):
        outs = net(fluid)
    return main, startup, outs


def jax_run(net, feeds, overrides=None):
    """`net`'s program in the JAX package from its startup state (with
    `overrides` set after it): (start state, losses, exe, scope)."""
    main, startup, outs = build("jax", net)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for n, v in (overrides or {}).items():
            scope.set_var(n, v)
        state = {n: np.array(np.asarray(v), copy=True)
                 for n, v in scope.vars.items() if v is not None}
        losses = [float(np.asarray(exe.run(main, feed=f,
                                           fetch_list=[outs[0]])[0]))
                  for f in feeds]
    return state, losses, exe, scope


def port_run(net, feeds, state):
    main, _, outs = build("port", net)
    scope = pfluid.io.state_from_numpy(state, scope=pfluid.Scope(),
                                       place=pfluid.CPUPlace(),
                                       main_program=main)
    exe = pfluid.Executor(pfluid.CPUPlace())
    losses = [float(exe.run(main, feed=f, fetch_list=[outs[0]],
                            scope=scope)[0]) for f in feeds]
    return losses, exe, scope


def test_semantic_role_labeller_matches_jax():
    sizes = srl.TEST
    rng = np.random.default_rng(5)
    feeds = [srl.train_batch(rng, 10, **sizes) for _ in range(3)]
    dfeed = srl.decode_feed(srl.train_batch(rng, 4, **sizes))
    emb = srl.pretrained_embedding(3, **sizes)

    def train(fluid):
        return srl.train_net(fluid, **sizes)

    def decode(fluid):
        return srl.decode_net(fluid, **sizes)

    state, want, jexe, jscope = jax_run(train, feeds,
                                        {srl.EMBEDDING_NAME: emb})
    with jfluid.scope_guard(jscope):
        jdec, _, jpath = build("jax", decode)
        want_path = np.asarray(jexe.run(jdec, feed=dfeed,
                                        fetch_list=[jpath])[0])
    got, exe, scope = port_run(train, feeds, state)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert np.isfinite(got).all() and got[-1] != got[0]
    # trainable=False keeps the pretrained table out of Adam's update
    np.testing.assert_array_equal(
        scope.vars[srl.EMBEDDING_NAME].numpy(), emb)
    pdec, _, ppath = build("port", decode)
    path = exe.run(pdec, feed=dfeed, fetch_list=[ppath], scope=scope)[0]
    assert path.shape == want_path.shape
    np.testing.assert_array_equal(path, want_path.astype(path.dtype))
    lens = [len(w) for w in dfeed["word_data"]]
    for row, n in zip(path[..., 0], lens):
        assert not row[n:].any() and (row[:n] < sizes["label_dict_len"]).all()


def test_recommender_matches_jax():
    rng = np.random.default_rng(0)
    feeds = [rec.train_batch(rng, 16, **rec.TEST) for _ in range(3)]

    def train(fluid):
        return rec.train_net(fluid, rec.TEST_LR, **rec.TEST)

    state, want, _, _ = jax_run(train, feeds)
    got, _, _ = port_run(train, feeds, state)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert np.isfinite(got).all()


# the repo's hierarchical-text flow (tests/book/test_hierarchical_text.py)
HT_VOCAB, HT_CLASSES, HT_EMB = 30, 3, 8


def ht_net(fluid):
    layers = fluid.layers
    docs = layers.data(name="docs", shape=[1], dtype="int64", lod_level=3)
    emb = layers.embedding(docs, size=[HT_VOCAB, HT_EMB])
    sent = layers.sequence_pool(emb, "sum")            # tokens -> sentence
    doc = layers.sequence_pool(sent, "average")        # sentences -> doc
    corpus = layers.sequence_pool(doc, "max")          # docs -> sample
    logits = layers.fc(corpus, size=HT_CLASSES)
    pred = layers.softmax(logits)
    label = layers.data(name="lbl", shape=[1], dtype="int64")
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return loss, pred


def ht_batch(rng, n=16):
    ds, ys = [], []
    for _ in range(n):
        y = int(rng.integers(0, HT_CLASSES))
        ds.append([[np.full((int(rng.integers(1, 4)),), 10 * y + 1, np.int64)
                    for _ in range(int(rng.integers(1, 3)))]
                   for _ in range(int(rng.integers(1, 3)))])
        ys.append([y])
    return {"docs": ds, "lbl": np.array(ys, np.int64)}


def test_hierarchical_text_flow_matches_jax():
    rng = np.random.default_rng(0)
    feeds = [ht_batch(rng) for _ in range(3)]
    infer = {"docs": ht_batch(rng, 8)["docs"]}
    state, want, jexe, jscope = jax_run(ht_net, feeds)
    got, exe, scope = port_run(ht_net, feeds, state)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)

    def save_load_infer(fluid, exe, scope, main, pred):
        d = tempfile.mkdtemp()
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, ["docs"], [pred], exe,
                                          main_program=main)
        with fluid.scope_guard(fluid.Scope()):
            prog, feed_names, fetches = fluid.io.load_inference_model(d, exe)
            return np.asarray(exe.run(prog, feed={feed_names[0]:
                                                  infer["docs"]},
                                      fetch_list=fetches)[0])

    jmain, _, (_, jpred) = build("jax", ht_net)
    pmain, _, (_, ppred) = build("port", ht_net)
    want_p = save_load_infer(jfluid, jexe, jscope, jmain, jpred)
    got_p = save_load_infer(pfluid, exe, scope, pmain, ppred)
    assert got_p.shape == want_p.shape == (8, HT_CLASSES)
    np.testing.assert_allclose(got_p, want_p, rtol=RTOL, atol=RTOL)


# ---------------------------------------------------------------------------
# K8's activation arms through the plain version
# ---------------------------------------------------------------------------

ACTS = ("sigmoid", "tanh", "relu", "identity")
SRL_ACTS = ("sigmoid", "sigmoid", "relu")       # gate, cell, candidate
B, T, D = 3, 4, 8


def lstm_case(peep, seed=0):
    """Pre-activations of order 1, so that even the unbounded sets (an
    identity gate and candidate) keep the state of order 1 over T steps
    (at three times this scale they reach 1e4, where float32's own
    rounding over the steps passes 1e-5)."""
    rng = np.random.RandomState(seed)
    return {"Input": [(rng.standard_normal((B, T, 4 * D)) * 0.5
                       ).astype(np.float32)],
            "Weight": [(rng.standard_normal((D, 4 * D)) * 0.2
                        ).astype(np.float32)],
            "Bias": [(rng.standard_normal((1, (7 if peep else 4) * D))
                      * 0.3).astype(np.float32)],
            "SeqLen": [np.array([4, 0, 2], np.int32)]}


def lstm_attrs(acts, peep, reverse):
    return {"gate_activation": acts[0], "cell_activation": acts[1],
            "candidate_activation": acts[2], "use_peepholes": peep,
            "is_reverse": reverse}


@pytest.mark.parametrize("acts", list(itertools.product(ACTS, repeat=3)),
                         ids="-".join)
def test_lstm_activation_arms_match_jax_composed_scan(acts, monkeypatch):
    steps = []
    step = rnn_kernels.lstm_step

    def counted(*args, **kw):
        steps.append(args[-1] if len(args) > 7 else kw.get("acts"))
        return step(*args, **kw)

    monkeypatch.setattr(rnn_kernels, "lstm_step", counted)
    reverse = sum(map(ACTS.index, acts)) % 2 == 1
    ins = lstm_case(True)
    attrs = lstm_attrs(acts, True, reverse)
    want = jax_registry.run_op(
        "lstm", {s: [jnp.asarray(v) for v in vs] for s, vs in ins.items()},
        dict(attrs))
    got = port_registry.run_op(
        "lstm", {s: [torch.from_numpy(v) for v in vs]
                 for s, vs in ins.items()}, dict(attrs))
    assert steps == [acts] * T
    for slot in ("Hidden", "Cell"):
        np.testing.assert_allclose(got[slot][0].numpy(),
                                   np.asarray(want[slot][0]), rtol=RTOL,
                                   atol=RTOL, err_msg=slot)


@pytest.mark.parametrize("peep", [True, False], ids=["peep", "no_peep"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_srl_lstm_grads_match_jax(peep, reverse):
    ins = lstm_case(peep, seed=4)
    attrs = lstm_attrs(SRL_ACTS, peep, reverse)
    outs = jax_registry.run_op(
        "lstm", {s: [jnp.asarray(v) for v in vs] for s, vs in ins.items()},
        dict(attrs))
    rng = np.random.RandomState(9)
    cots = {s: rng.standard_normal(np.shape(outs[s][0])).astype(np.float32)
            for s in ("Hidden", "Cell")}
    gattrs = {"fw_type": "lstm", "fw_attrs": dict(attrs),
              "fw_in_slots": [(s, len(v)) for s, v in ins.items()],
              "fw_out_slots": [(s, len(v)) for s, v in outs.items()],
              "needs_input_grad": [("Input", 0), ("Weight", 0),
                                   ("Bias", 0)],
              "has_out_grad": [("Hidden", 0), ("Cell", 0)]}
    gins = dict(ins, **{f"{s}@GRAD_OUT": [c] for s, c in cots.items()})
    want = jax_registry.run_op(
        "generic_grad", {s: [jnp.asarray(v) for v in vs]
                         for s, vs in gins.items()}, gattrs)
    got = port_registry.run_op(
        "generic_grad", {s: [torch.from_numpy(v) for v in vs]
                         for s, vs in gins.items()}, gattrs)
    assert set(want) == set(got) == {"Input@GRAD", "Weight@GRAD",
                                     "Bias@GRAD"}
    for slot in want:
        np.testing.assert_allclose(got[slot][0].numpy(),
                                   np.asarray(want[slot][0]), rtol=RTOL,
                                   atol=1e-6, err_msg=slot)


def test_lstm_refuses_an_unknown_activation():
    ins = {s: [torch.from_numpy(v) for v in vs]
           for s, vs in lstm_case(True).items()}
    with pytest.raises(KeyError, match="softplus"):
        port_registry.run_op("lstm", ins, lstm_attrs(
            ("sigmoid", "softplus", "tanh"), True, False))
