"""The port's host decoding (``models/decoding.py``: greedy search and beam
search with the GNMT length penalty) against the JAX package's on the CPU:

- on fixed logits functions (a seeded Markov table, a garden path that
  greedy search walks into, and finished beams): the same sequences and
  scores, bit for bit (both are numpy);
- over a 1-layer transformer's test program from the JAX package's start
  state (``models/transformer.py`` at width 16, vocabulary 12), the
  prefix fed padded to a fixed length as the JAX package's decode test
  does: the same greedy and beam ids, and next-token log-probabilities
  within 1e-5 of the JAX package's at every step.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.models import decoding as jax_decoding
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.models import decoding as port_decoding
from paddle_tpu_torch.models import transformer as port_transformer

BOS, EOS = 0, 1


@pytest.fixture(autouse=True)
def fresh_jax_steps(monkeypatch):
    # the JAX side compiles its steps afresh and takes its plain attention
    # (the persistent jit cache is shared by the test workers; ROADMAP
    # queue 3)
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)
    monkeypatch.setitem(jax_flags._overrides, "force_attention_impl",
                        "composed")


def markov(trans):
    """Logits that depend only on the previous token."""
    def fn(prefix, t):
        return trans[prefix[:, t - 1]]
    return fn


def _tables():
    rng = np.random.RandomState(0)
    garden = np.full((6, 6), -9.0, np.float32)
    garden[BOS, 2], garden[BOS, 3] = 3.0, 2.8
    garden[2, EOS], garden[2, 4], garden[4, EOS] = -2.0, -1.9, 0.0
    garden[3, EOS] = 3.0
    eos_heavy = rng.randn(7, 7).astype(np.float32)
    eos_heavy[:, EOS] += 1.5          # beams finish at different steps
    return [("random", rng.randn(9, 9).astype(np.float32)),
            ("garden", garden), ("eos_heavy", eos_heavy)]


@pytest.mark.parametrize("name,trans", _tables(),
                         ids=[n for n, _ in _tables()])
@pytest.mark.parametrize("beam,penalty", [(1, 0.6), (3, 0.0), (4, 0.6)])
def test_decoding_matches_jax_on_fixed_logits(name, trans, beam, penalty):
    fn = markov(trans)
    for batch in (1, 3):
        np.testing.assert_array_equal(
            port_decoding.greedy_search(fn, batch, BOS, EOS, 7),
            jax_decoding.greedy_search(fn, batch, BOS, EOS, 7))
        got = port_decoding.beam_search(fn, batch, beam, BOS, EOS, 7,
                                        length_penalty=penalty)
        want = jax_decoding.beam_search(fn, batch, beam, BOS, EOS, 7,
                                        length_penalty=penalty)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


V, TS, TT, H = 12, 6, 6, 2


def _infer_program(name):
    fluid, tr, init, names = (
        (jfluid, jax_transformer, jax_init, jax_unique_name)
        if name == "jax" else
        (pfluid, port_transformer, port_init, port_unique_name))
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with names.guard(), fluid.program_guard(main, startup):
        _, predict, _ = tr.transformer(
            src_vocab_size=V, trg_vocab_size=V, max_length=16, n_layer=1,
            n_head=H, d_key=8, d_value=8, d_model=16, d_inner_hid=32,
            dropout_rate=0.0)
        infer = main.clone(for_test=True)
    return startup, infer, predict


def _logits_fn(run, infer, predict, src, make_biases, log):
    b = src.shape[0]

    def fn(prefix, t):
        n = prefix.shape[0]
        sb, tb, cb = make_biases([TS] * n, [t] * n, H, TS, TT - 1)
        feed = {
            "src_word": np.repeat(src, n // b, axis=0),
            "src_pos": np.tile(np.arange(TS), (n, 1)).astype(np.int64),
            "trg_word": prefix[:, :TT - 1],
            "trg_pos": np.tile(np.arange(TT - 1), (n, 1)).astype(np.int64),
            "src_slf_attn_bias": sb, "trg_slf_attn_bias": tb,
            "trg_src_attn_bias": cb,
            "lbl_word": np.zeros((n, TT - 1, 1), np.int64),
            "lbl_weight": np.zeros((n, TT - 1, 1), np.float32)}
        (probs,) = run(infer, feed, [predict])
        out = np.log(np.maximum(np.asarray(probs)[:, t - 1], 1e-9))
        log.append(out)
        return out
    return fn


def test_transformer_decode_matches_jax_from_its_start_state():
    src = np.random.RandomState(1).randint(2, V, (2, TS)).astype(np.int64)
    jstart, jinfer, jpredict = _infer_program("jax")
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    state = {n: np.array(np.asarray(v), copy=True)
             for n, v in jscope.vars.items() if v is not None}

    def jrun(prog, feed, fetch):
        with jfluid.scope_guard(jscope):
            return jexe.run(prog, feed=feed, fetch_list=fetch)

    _, pinfer, ppredict = _infer_program("port")
    pscope = pfluid.io.state_from_numpy(state, scope=pfluid.Scope(),
                                        place=pfluid.CPUPlace(),
                                        main_program=pinfer)
    pexe = pfluid.Executor(pfluid.CPUPlace())

    def prun(prog, feed, fetch):
        return pexe.run(prog, feed=feed, fetch_list=fetch, scope=pscope)

    jlog, plog = [], []
    jfn = _logits_fn(jrun, jinfer, jpredict, src,
                     jax_transformer.make_attn_biases, jlog)
    pfn = _logits_fn(prun, pinfer, ppredict, src,
                     port_transformer.make_attn_biases, plog)
    np.testing.assert_array_equal(
        port_decoding.greedy_search(pfn, 2, BOS, EOS, TT - 1),
        jax_decoding.greedy_search(jfn, 2, BOS, EOS, TT - 1))
    got = port_decoding.beam_search(pfn, 2, 3, BOS, EOS, TT - 1)
    want = jax_decoding.beam_search(jfn, 2, 3, BOS, EOS, TT - 1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    assert len(plog) == len(jlog) > 0
    for p, j in zip(plog, jlog):
        np.testing.assert_allclose(p, j, rtol=0, atol=1e-5)
