"""The port's int8 serving path against the JAX package at small size.

- K6: the port's plain version equals the JAX package's Pallas kernel in
  interpret mode bit for bit, on the same int8 operands, at aligned and
  ragged shapes and N = 2.
- ``quant_matmul``: the same int8 activation codes as the reference, and
  outputs within rtol 1e-6 (both sides run the same codes through an exact
  int32 product, so they agree to the last bit in practice).
- ``make_quant_kernel`` through the registry, ``apply_to_scope`` against the
  reference's weights and scales, and the quantize pass's behaviour.
- Slice parity: a 2-layer, narrow ``bert_classifier`` saved once, served by
  the port's quantized CPU Predictor and by the JAX package's quantized
  Predictor on the same batch: atol 1e-3 on the probabilities (the two
  frameworks' fp32 activations differ in the last bits, and one activation
  code rounding the other way moves an output by up to one quantization
  step); and within 0.05 of the port's own fp32 answers, the reference's
  bar (tests/test_quantize_pass.py:319).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import flags as jax_flags
from paddle_tpu.ops import quant_kernels as jqk
from paddle_tpu.ops import registry as jreg
from paddle_tpu.passes import quantize as jqz
from paddle_tpu_torch import flags as port_flags
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.core.framework import Operator, Program, Variable
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.ops import quant_kernels as pqk
from paddle_tpu_torch.ops import registry as preg
from paddle_tpu_torch.passes import PassContext, quantize as pqz
from paddle_tpu_torch.passes.manager import PassManager

SLICE_ATOL = 1e-3
FP32_BAR = 0.05
T, B = 16, 6
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, max_position=32, type_vocab_size=2,
           dropout=0.1)


@pytest.fixture(autouse=True)
def jax_side(monkeypatch):
    # the reference's int8 matmul runs its Pallas kernel (interpret mode
    # on the CPU) instead of timing both arms; its attention runs the
    # composed form; and it compiles afresh (the persistent jit cache is
    # shared by the test workers, ROADMAP queue 3)
    monkeypatch.setitem(jax_flags._overrides, "quant_matmul_impl", "pallas")
    monkeypatch.setitem(jax_flags._overrides, "force_attention_impl",
                        "composed")
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)


def _operands(m, k, n, seed):
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (m, k)).astype(np.int8)
    wq = rng.randint(-127, 128, (k, n)).astype(np.int8)
    cs = (rng.uniform(1e-3, 0.1, n) * rng.uniform(1e-3, 0.05)).astype(
        np.float32)
    return xq, wq, cs


# ---------------------------------------------------------------------------
# K6 and quant_matmul
# ---------------------------------------------------------------------------

K6_SHAPES = [(32, 128, 128), (33, 130, 70), (16, 64, 2), (4, 3072, 8),
             (1, 768, 3)]


@pytest.mark.parametrize("m,k,n", K6_SHAPES)
def test_k6_plain_equals_jax_kernel_interpret(m, k, n):
    xq, wq, cs = _operands(m, k, n, seed=m + k + n)
    want = np.asarray(jqk._quant_matmul_call(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(cs), interpret=True))
    got = pqk.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                          torch.from_numpy(cs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert pqk.int8_matmul.launches == 0       # the plain version ran


def _reference_codes(x):
    """The reference's activation quantization (quant_kernels.py:154-155)."""
    xs = jnp.maximum(jnp.max(jnp.abs(x)) / 127.0, 1e-12)
    return np.asarray(jnp.clip(jnp.round(x / xs), -127, 127)
                      .astype(jnp.int8)), float(xs)


@pytest.mark.parametrize("m,k,n,zero", [(24, 64, 48, False),
                                        (7, 33, 5, False),
                                        (8, 16, 4, True)])
def test_quant_matmul_matches_reference(m, k, n, zero):
    rng = np.random.RandomState(m * k)
    x = np.zeros((m, k), np.float32) if zero else \
        (rng.randn(m, k) * 3).astype(np.float32)
    _, wq, ws = _operands(m, k, n, seed=n)
    want_q, want_xs = _reference_codes(jnp.asarray(x))
    got_q, got_xs = pqk.quantize_activation(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    assert float(got_xs) == want_xs
    want = np.asarray(jqk.quant_matmul(jnp.asarray(x), jnp.asarray(wq),
                                       jnp.asarray(ws)))
    got = pqk.quant_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                           torch.from_numpy(ws)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if zero:
        assert want_xs == np.float32(1e-12) and not got.any()


@pytest.mark.parametrize("op", ["mul", "matmul"])
def test_make_quant_kernel_through_registry(op):
    rng = np.random.RandomState(3)
    if op == "mul":
        x = rng.randn(2, 3, 8).astype(np.float32)
        attrs = {"x_num_col_dims": 2, "y_num_col_dims": 1}
    else:
        x = rng.randn(8, 5).astype(np.float32)
        attrs = {"transpose_X": True, "alpha": 0.5}
    _, wq, sc = _operands(1, 8, 4, seed=4)
    attrs["__quant__"] = {"w": "w", "w_slot": "Y", "scale": "w@QSCALE",
                          "cols": 4, "bits": 8, "dtype": "int8"}
    want = jreg.get_kernel(op, attrs)(
        {"X": [jnp.asarray(x)], "Y": [jnp.asarray(wq)],
         "Scale": [jnp.asarray(sc)]}, attrs)["Out"][0]
    got = preg.run_op(op, {"X": [torch.from_numpy(x)],
                           "Y": [torch.from_numpy(wq)],
                           "Scale": [torch.from_numpy(sc)]}, attrs)["Out"][0]
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    with pytest.raises(KeyError, match="Scale operand"):
        preg.run_op(op, {"X": [torch.from_numpy(x)],
                         "Y": [torch.from_numpy(wq)]}, attrs)


# ---------------------------------------------------------------------------
# apply_to_scope
# ---------------------------------------------------------------------------

def _mlp(fluid):
    # a fresh name generator: the comparison below keys by parameter name,
    # so the names must not depend on what an earlier test drew
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        out = fluid.layers.fc(input=h, size=4, act="softmax")
    return main.clone(for_test=True), startup, out


def test_apply_to_scope_matches_reference():
    from paddle_tpu import passes as jpasses
    from paddle_tpu_torch import passes as ppasses

    pinfer, pstart, pout = _mlp(pfluid)
    jinfer, _, jout = _mlp(jfluid)
    pscope = pfluid.Scope()
    pfluid.Executor(pfluid.CPUPlace()).run(pstart, scope=pscope)
    state = {n: t.numpy() for n, t in pscope.vars.items() if t is not None}
    jscope = jfluid.Scope()
    for n, v in state.items():
        jscope.set_var(n, v)
    for prog in (pinfer, jinfer):
        prog._quant = True
        prog._version += 1
    pq = ppasses.apply_at_seam(pinfer, feed_names=["x"],
                               fetch_names=[pout.name])
    jq = jpasses.apply_at_seam(jinfer, feed_names=["x"],
                               fetch_names=[jout.name])
    assert pqz.quant_plan(pq) == jqz.quant_plan(jq)
    assert pqz.apply_to_scope(pq, pscope) == 2
    assert jqz.apply_to_scope(jq, jscope) == 2
    assert pqz.apply_to_scope(pq, pscope) == 0      # idempotent
    for w, spec in pqz.quant_plan(pq).items():
        for name in (w, spec["scale"]):
            got, want = pscope.find_var(name), np.asarray(
                jscope.find_var(name))
            assert isinstance(got, torch.Tensor)
            assert got.device == torch.device("cpu")
            assert str(got.dtype) == f"torch.{want.dtype}", name
            np.testing.assert_array_equal(got.numpy(), want)
    snap = pfluid.observability.REGISTRY.snapshot()["quant"]
    assert snap["counters"]["tables_quantized"] >= 2
    assert set(snap["scale_ranges"]) >= set(pqz.quant_plan(pq))


# ---------------------------------------------------------------------------
# The quantize pass (ports of tests/test_quantize_pass.py:73-134)
# ---------------------------------------------------------------------------

def _var(block, name, shape=(4, 4), dtype="float32", **kw):
    v = Variable(block, name=name, shape=shape, dtype=dtype, **kw)
    block.vars[name] = v
    return v


def _op(block, type, inputs=None, outputs=None, attrs=None):
    op = Operator(block, type=type, inputs=inputs, outputs=outputs,
                  attrs=attrs)
    block.ops.append(op)
    return op


def _fc_chain(quant=True):
    p = Program()
    if quant:
        p._quant = True
    b = p.global_block()
    _var(b, "x", (4, 8), is_data=True)
    _var(b, "w1", (8, 4), persistable=True)
    _var(b, "h", (4, 4))
    _var(b, "out", (4, 4))
    _op(b, "mul", {"X": ["x"], "Y": ["w1"]}, {"Out": ["h"]})
    _op(b, "relu", {"X": ["h"]}, {"Out": ["out"]})
    return p


def _run_pass(p, feeds=("x",), fetches=("out",)):
    ctx = PassContext(feed_names=feeds, fetch_names=fetches)
    return PassManager(["quantize_weights"]).run(p, ctx)


def test_pass_identity_without_quant_bit():
    p = _fc_chain(quant=False)
    out, rep = _run_pass(p)
    assert out is p and not rep.changed


def test_pass_annotates_and_is_idempotent():
    p = _fc_chain()
    out, rep = _run_pass(p)
    assert rep.changed and out is not p
    mul = out.global_block().ops[0]
    assert mul.attrs["__quant__"]["w"] == "w1"
    assert mul.input("Scale") == ["w1@QSCALE"]
    assert str(out.global_block().vars["w1"].dtype) == "int8"
    assert "w1@QSCALE" in out.global_block().vars
    assert "__quant__" not in p.global_block().ops[0].attrs
    assert str(p.global_block().vars["w1"].dtype) == "float32"
    out2, rep2 = _run_pass(out)
    assert out2 is out and not rep2.changed


def test_pass_skips_training_weights():
    p = _fc_chain()
    b = p.global_block()
    _var(b, "w1@GRAD", (8, 4))
    _var(b, "lr", (1,), persistable=True)
    _op(b, "sgd", {"Param": ["w1"], "Grad": ["w1@GRAD"],
                   "LearningRate": ["lr"]}, {"ParamOut": ["w1"]})
    out, rep = _run_pass(p)
    assert out is p and not rep.changed


def test_pass_skips_fetched_weights():
    out, rep = _run_pass(_fc_chain(), fetches=("out", "w1"))
    assert not rep.changed


def test_pass_skips_attr_referenced_weights():
    p = _fc_chain()
    _op(p.global_block(), "gpipe", {"X": ["out"]}, {"Out": ["out"]},
        {"param_inner_names": ["w1"]})
    out, rep = _run_pass(p)
    assert out is p and not rep.changed


def test_fp8_is_not_ported(monkeypatch):
    monkeypatch.setitem(port_flags._overrides, "quant_dtype", "fp8")
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        _run_pass(_fc_chain())


# ---------------------------------------------------------------------------
# Slice parity: the quantized Predictor of both packages
# ---------------------------------------------------------------------------

def _feeds(n=B, seed=0):
    rng = np.random.RandomState(seed)
    bias = np.zeros((n, 1, 1, T), np.float32)
    for i, length in enumerate(rng.randint(T // 4, T + 1, n)):
        bias[i, ..., length:] = -10000.0
    return {"src_ids": rng.randint(0, CFG["vocab_size"], (n, T)),
            "pos_ids": np.tile(np.arange(T), (n, 1)),
            "sent_ids": rng.randint(0, 2, (n, T)),
            "attn_bias": bias}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A 2-layer narrow bert_classifier, saved once by the port."""
    d = str(tmp_path_factory.mktemp("bert_q"))
    port_init._auto_seed_counter[0] = 1
    main, startup = pfluid.Program(), pfluid.Program()
    with port_unique_name.guard(), pfluid.program_guard(main, startup):
        probs, feeds = port_bert.bert_classifier(
            port_bert.BertConfig(**CFG), T)
    exe = pfluid.Executor(pfluid.CPUPlace())
    with pfluid.scope_guard(pfluid.Scope()):
        exe.run(startup)
        pfluid.io.save_inference_model(d, feeds, [probs], exe,
                                       main_program=main)
    return d


def _port_predictor(d, quant):
    cfg = pfluid.AnalysisConfig(d)
    cfg.disable_gpu()
    if quant:
        cfg.enable_quantize()
    return pfluid.create_paddle_predictor(cfg)


def test_quantized_predictor_matches_jax(model_dir, capfd):
    capfd.readouterr()
    pred = _port_predictor(model_dir, quant=True)
    assert capfd.readouterr().err == ""       # the verifier found nothing
    quant_ops = [op for op in pred._program.global_block().ops
                 if "__quant__" in op.attrs]
    # q, k, v, out, FFN1, FFN2 per layer, the pooler and the logits head
    assert len(quant_ops) == 6 * CFG["num_layers"] + 2
    cfg = jfluid.AnalysisConfig(model_dir)
    cfg.enable_quantize()
    jpred = jfluid.create_paddle_predictor(cfg)
    feed = _feeds()
    (want,) = jpred.run(feed)
    launches = pqk.int8_matmul.launches
    (got,) = pred.run(feed)
    assert pqk.int8_matmul.launches == launches   # CPU: the plain version
    assert got.shape == want.shape == (B, 2)
    np.testing.assert_allclose(got, want, atol=SLICE_ATOL, rtol=0)
    (fp32,) = _port_predictor(model_dir, quant=False).run(feed)
    assert np.abs(got - fp32).max() < FP32_BAR
    assert not np.array_equal(got, fp32)


def test_quantized_scope_stays_int8_across_runs(model_dir):
    pred = _port_predictor(model_dir, quant=True)
    plan = pqz.quant_plan(pred._program)
    feed = _feeds(n=2, seed=1)
    first = pred.run(feed)[0]
    again = pred.run(feed)[0]
    np.testing.assert_array_equal(first, again)
    for w, spec in plan.items():
        wt, st = pred._scope.find_var(w), pred._scope.find_var(spec["scale"])
        assert wt.dtype == torch.int8 and st.dtype == torch.float32
        assert wt.device == st.device == torch.device("cpu")


def test_quantized_serving_engine_matches_predictor_run(model_dir):
    """The engine's padded batches run the same program: rows served one
    by one through a batch of four equal the Predictor's answers on that
    padded batch (the activation scale is per batch)."""
    pred = _port_predictor(model_dir, quant=True)
    feed = _feeds(n=4, seed=2)
    (want,) = pred.run(feed)
    engine = pfluid.serving.ServingEngine(
        pred, pfluid.serving.ServingConfig(max_batch_size=4,
                                           max_wait_ms=200.0))
    try:
        futures = [engine.submit({n: a[i:i + 1] for n, a in feed.items()})
                   for i in range(4)]
        rows = [f.result(60)[0] for f in futures]
        batches = engine.stats()["counters"]["batches_executed"]
    finally:
        engine.stop()
    if batches == 1:
        np.testing.assert_array_equal(np.concatenate(rows), want)
    else:       # a slow worker split the burst: each batch has its own scale
        np.testing.assert_allclose(np.concatenate(rows), want, atol=SLICE_ATOL)
