"""The port's linear-chain CRF, CTC and tie orders against the JAX package
on the CPU, on the same seeded numpy inputs:

- ``linear_chain_crf``: the loss at ragged lengths (a full row, a
  1-token row, a zero-length row) and at T = 1, within 1e-5 relative
  (atol 1e-6); its generic grad (the Emission's and the Transition's)
  against the JAX package's vjp, within 1e-5 relative (atol 1e-6);
- ``crf_decoding`` on integer-valued emissions and transitions, so the
  Viterbi maxima tie exactly and often: paths equal, with and without a
  ``Label`` (the 0/1 match mask), 0 past each length;
- ``warpctc``: the loss and the Logits' grad with repeated labels, a
  label as long as its input allows (T = L, and T = L + repeats), an
  empty label, a zero-length input, and with ``norm_by_times``, within
  1e-5 relative (atol 1e-6);
- ``ctc_align`` (merging repeats or not) and the ``ctc_greedy_decoder``
  program through each package's Executor: ids and lengths exact;
- ``top_k`` on tie-heavy rows (the lower index first among equal values,
  as ``lax.top_k``), and ``arg_max``/``arg_min``, which take the first
  extreme: values and indices exact.
"""

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
from paddle_tpu_torch.ops import registry as port_registry

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def fresh_jax_steps(monkeypatch):
    # the JAX side compiles its steps afresh: the persistent jit cache is
    # shared by the test workers (ROADMAP queue 3)
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)


def f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def run_both(op_type, ins, attrs):
    want = jax_registry.run_op(
        op_type, {s: [jnp.asarray(v) for v in vs] for s, vs in ins.items()},
        dict(attrs))
    got = port_registry.run_op(
        op_type, {s: [torch.from_numpy(np.array(v)) for v in vs]
                  for s, vs in ins.items()}, dict(attrs))
    return ({s: [np.asarray(v) for v in vs] for s, vs in want.items()},
            {s: [v.detach().numpy() for v in vs] for s, vs in got.items()})


def assert_exact(want, got):
    assert set(want) == set(got), (sorted(want), sorted(got))
    for slot in want:
        for w, g in zip(want[slot], got[slot]):
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=slot)


def grads_both(op_type, ins, attrs, needs, out_slot, seed=5):
    """Each package's generic grad of `op_type` w.r.t. the input slots
    `needs`, under one random cotangent of output `out_slot`."""
    outs = jax_registry.run_op(
        op_type, {s: [jnp.asarray(v) for v in vs] for s, vs in ins.items()},
        dict(attrs))
    cot = f32(np.random.RandomState(seed), *np.shape(outs[out_slot][0]))
    gattrs = {"fw_type": op_type, "fw_attrs": dict(attrs),
              "fw_in_slots": [(s, len(v)) for s, v in ins.items()],
              "fw_out_slots": [(s, len(v)) for s, v in outs.items()],
              "needs_input_grad": [(s, 0) for s in needs],
              "has_out_grad": [(out_slot, 0)]}
    gins = dict(ins, **{f"{out_slot}@GRAD_OUT": [cot]})
    return run_both("generic_grad", gins, gattrs)


def assert_close(want, got):
    assert set(want) == set(got) and want
    for slot in want:
        for w, g in zip(want[slot], got[slot]):
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=slot)


# ---------------------------------------------------------------------------
# linear_chain_crf and crf_decoding
# ---------------------------------------------------------------------------

def crf_case(t, lens, k=4, seed=0, integer=False):
    rng = np.random.RandomState(seed)
    b = len(lens)
    if integer:
        em = rng.randint(0, 3, (b, t, k)).astype(np.float32)
        w = rng.randint(0, 2, (k + 2, k)).astype(np.float32)
    else:
        em, w = f32(rng, b, t, k), f32(rng, k + 2, k, scale=0.5)
    label = rng.randint(0, k, (b, t, 1)).astype(np.int64)
    return {"Emission": [em], "Transition": [w], "Label": [label],
            "SeqLen": [np.asarray(lens, np.int32)]}


CRF_CASES = {"ragged": (6, [6, 1, 0, 3, 6]), "t1": (1, [1, 0, 1]),
             "k9": (5, [5, 4, 2])}


@pytest.mark.parametrize("name", sorted(CRF_CASES))
def test_linear_chain_crf_loss_and_grads_match_jax(name):
    t, lens = CRF_CASES[name]
    ins = crf_case(t, lens, k=9 if name == "k9" else 4)
    want, got = run_both("linear_chain_crf", ins, {})
    assert got["LogLikelihood"][0].shape == (len(lens), 1)
    assert_close(want, got)
    assert_close(*grads_both("linear_chain_crf", ins, {},
                             ["Emission", "Transition"], "LogLikelihood"))


@pytest.mark.parametrize("with_label", [False, True],
                         ids=["path", "label_mask"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crf_decoding_breaks_planted_ties_as_jax(seed, with_label):
    ins = crf_case(7, [7, 0, 1, 4, 7, 2], k=5, seed=seed, integer=True)
    if not with_label:
        del ins["Label"]
    want, got = run_both("crf_decoding", ins, {})
    assert_exact(want, got)
    path = got["ViterbiPath"][0][..., 0]
    assert not path[1].any() and not path[2, 1:].any() and \
        not path[5, 2:].any()


def test_crf_decoding_ties_are_real():
    """The integer case does tie: some step's best previous tag has an
    equal rival, so a last-maximum rule would give other paths."""
    ins = crf_case(7, [7, 0, 1, 4, 7, 2], k=5, seed=0, integer=True)
    em, w = ins["Emission"][0], ins["Transition"][0]
    delta = em[:, 0] + w[0]
    scores = delta[:, :, None] + w[2:][None]
    assert ((scores == scores.max(axis=1, keepdims=True)).sum(axis=1)
            > 1).any()


# ---------------------------------------------------------------------------
# warpctc, ctc_align, ctc_greedy_decoder
# ---------------------------------------------------------------------------

def ctc_case(seed=0):
    rng = np.random.RandomState(seed)
    b, t, c, l = 6, 8, 5, 4
    labels = np.zeros((b, l), np.int64)
    labels[0] = [1, 1, 2, 3]                   # a repeat: needs T >= 5
    labels[1] = [4, 3, 2, 1]                   # as long as its input (4)
    labels[2] = [2, 2, 2, 0]                   # three repeats: T >= 5 = 5
    labels[3] = [1, 4, 0, 0]
    labels[4] = [3, 0, 0, 0]                   # empty label
    labels[5] = [2, 1, 0, 0]                   # zero-length input
    return {"Logits": [f32(rng, b, t, c, scale=2.0)],
            "Label": [labels[..., None]],
            "LogitsLen": [np.array([8, 4, 5, 6, 3, 0], np.int32)],
            "LabelLen": [np.array([4, 4, 3, 2, 0, 2], np.int32)]}


@pytest.mark.parametrize("norm", [False, True], ids=["raw", "norm_by_times"])
def test_warpctc_loss_and_grad_match_jax(norm):
    ins = ctc_case()
    attrs = {"blank": 0, "norm_by_times": norm}
    want, got = run_both("warpctc", ins, attrs)
    assert_close(want, got)
    assert np.isfinite(got["Loss"][0]).all()
    want_g, got_g = grads_both("warpctc", ins, attrs, ["Logits"], "Loss")
    assert np.isfinite(got_g["Logits@GRAD"][0]).all()
    assert_close(want_g, got_g)


def test_warpctc_nonzero_blank_matches_jax():
    ins = ctc_case(seed=3)
    labels = ins["Label"][0].copy()
    labels[labels == 4] = 0                    # 4 is the blank now
    ins["Label"] = [labels]
    want, got = run_both("warpctc", ins, {"blank": 4})
    assert_close(want, got)


@pytest.mark.parametrize("merge", [True, False])
def test_ctc_align_matches_jax(merge):
    x = np.array([[0, 1, 1, 0, 1, 2, 2, 0], [3, 3, 3, 3, 3, 3, 3, 3],
                  [0, 0, 0, 0, 0, 0, 0, 0], [1, 2, 3, 4, 1, 2, 3, 4],
                  [2, 0, 2, 0, 2, 2, 0, 1]], np.int64)
    ins = {"Input": [x[..., None]],
           "SeqLen": [np.array([8, 8, 5, 8, 6], np.int32)]}
    want, got = run_both("ctc_align", ins, {"blank": 0,
                                            "merge_repeated": merge})
    assert_exact(want, got)


def _greedy(fluid, init, names):
    init._auto_seed_counter[0] = 1
    main = fluid.Program()
    with names.guard(), fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.data(name="x", shape=[5], dtype="float32",
                              lod_level=1)
        out = fluid.layers.ctc_greedy_decoder(input=x, blank=0)
    return main, out


def test_ctc_greedy_decoder_program_matches_jax():
    rng = np.random.RandomState(8)
    feed = {"x": [f32(rng, n, 5) for n in (7, 1, 4, 6)]}
    jmain, jout = _greedy(jfluid, jax_init, jax_unique_name)
    with jfluid.scope_guard(jfluid.Scope()):
        want = np.asarray(jfluid.Executor().run(jmain, feed=feed,
                                                fetch_list=[jout])[0])
    pmain, pout = _greedy(pfluid, port_init, port_unique_name)
    got = pfluid.Executor(pfluid.CPUPlace()).run(
        pmain, feed=feed, fetch_list=[pout], scope=pfluid.Scope())[0]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(got.dtype))


# ---------------------------------------------------------------------------
# tie orders: top_k (repaired: torch.topk promises no order among ties),
# arg_max and arg_min
# ---------------------------------------------------------------------------

def _tie_rows():
    every7 = np.zeros((1, 3000), np.float32)
    every7[0, ::7] = 1.0
    return [("mostly_threes", np.array([[1, 3, 3, 2, 3, 0, 3, 3] + [3] * 40],
                                       np.float32), 5),
            ("one_every_7th", every7, 6),
            ("seeded_ints", np.random.RandomState(2).randint(
                0, 4, (16, 300)).astype(np.float32), 12)]


@pytest.mark.parametrize("name,x,k", _tie_rows(),
                         ids=[r[0] for r in _tie_rows()])
def test_top_k_orders_ties_as_lax_top_k(name, x, k):
    want, got = run_both("top_k", {"X": [x]}, {"k": k})
    assert_exact(want, got)
    if name == "mostly_threes":
        assert got["Indices"][0].tolist() == [[1, 2, 4, 6, 7]]
    if name == "one_every_7th":
        assert got["Indices"][0].tolist() == [[0, 7, 14, 21, 28, 35]]


@pytest.mark.parametrize("op_type", ["arg_max", "arg_min"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_arg_extremes_take_the_first_as_jax(op_type, axis):
    x = np.random.RandomState(6).randint(0, 3, (9, 40)).astype(np.float32)
    want, got = run_both(op_type, {"X": [x]}, {"axis": axis})
    assert_exact(want, got)
