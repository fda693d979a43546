"""The Predictor's zero-copy and AOT paths on the port against the JAX
package, on the CPU, over a 2-layer BERT classifier at narrow width saved
by the JAX package from its startup state:

- cross-loads: the JAX package's model dir served by the port, and the
  port's save of the same model served by the JAX package, both within
  1e-6 of the JAX package's own Predictor;
- zero-copy: ``copy_from_cpu`` / ``zero_copy_run`` / ``copy_to_cpu``
  equal ``run()`` bit for bit and the JAX Predictor's zero-copy outputs
  within 1e-6; the outputs stay tensors until ``copy_to_cpu``; mixing
  ``run()`` with the zero-copy API keeps the output views coherent;
- ``export_serialized`` on a program-mode Predictor, then a fresh
  Predictor over the directory: it loads ``__serialized__.pt2`` and never
  rebuilds the Program, its outputs within 1e-6 of the JAX program-mode
  Predictor's; the graph holds one K1 custom op a layer (and one K6 a
  quantized matmul, its answers those of the quantized program mode);
  the meta has the reference's keys; ``enable_bf16`` on the artifact
  warns once per directory; the refusals: the JAX package's
  ``__serialized__.bin``, a program with a host op or a generator op,
  an artifact exported on another device kind, a kernel wrapper with no
  custom op under ``torch.export``;
- ``ServingEngine`` over the AOT handle: one batch bucket (the exported
  rows), single-row requests answered as ``run()`` answers them.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.models import bert as jax_bert
from paddle_tpu_torch import inference as pinf
from paddle_tpu_torch.ops import attention_kernels as ak
from paddle_tpu_torch.ops import cuda_build
from paddle_tpu_torch.ops import sequence_kernels

TOL = 1e-6
T, B = 8, 3
CFG = dict(vocab_size=50, hidden_size=16, num_layers=2, num_heads=2,
           intermediate_size=32, max_position=16, type_vocab_size=2,
           dropout=0.1)
FEEDS = ["src_ids", "pos_ids", "sent_ids", "attn_bias"]


@pytest.fixture(autouse=True)
def fresh_jax(monkeypatch):
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)
    monkeypatch.setitem(jax_flags._overrides, "force_attention_impl",
                        "composed")


def feed_of(rows, seed=0):
    rng = np.random.RandomState(seed)
    bias = np.zeros((rows, 1, 1, T), np.float32)
    bias[0, ..., T - 2:] = -10000.0
    return {"src_ids": rng.randint(0, 50, (rows, T)).astype(np.int64),
            "pos_ids": np.tile(np.arange(T, dtype=np.int64), (rows, 1)),
            "sent_ids": (rng.rand(rows, T) > 0.5).astype(np.int64),
            "attn_bias": bias}


def jax_bert_classifier(cfg):
    """The JAX package's counterpart of the port's ``bert_classifier``:
    ``bert_encoder`` plus the NSP head of ``bert_pretrain``."""
    fl = jfluid.layers
    src, pos, sent = (fl.data(name=n, shape=[T], dtype="int64")
                      for n in FEEDS[:3])
    bias = fl.data(name="attn_bias", shape=[1, 1, T], dtype="float32")
    seq_out = jax_bert.bert_encoder(src, pos, sent, bias, cfg)
    first = fl.slice(seq_out, axes=[1], starts=[0], ends=[1])
    pooled = fl.fc(input=fl.reshape(first, [-1, cfg.hidden_size]),
                   size=cfg.hidden_size, act="tanh")
    return fl.softmax(fl.fc(input=pooled, size=2)), list(FEEDS)


def save_jax_model(d):
    jax_init._auto_seed_counter[0] = 1
    main, startup = jfluid.Program(), jfluid.Program()
    with jax_unique_name.guard(), jfluid.program_guard(main, startup):
        probs, feeds = jax_bert_classifier(jax_bert.BertConfig(**CFG))
    exe, scope = jfluid.Executor(), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(d, feeds, [probs], exe,
                                       main_program=main)


def port_pred(d, quant=False, bf16=False):
    cfg = pfluid.AnalysisConfig(d)
    cfg.disable_gpu()
    if quant:
        cfg.enable_quantize()
    if bf16:
        cfg.enable_bf16()
    return pfluid.create_paddle_predictor(cfg)


def jax_pred(d):
    return jfluid.create_paddle_predictor(jfluid.AnalysisConfig(d))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A JAX-saved model dir, its JAX Predictor's answers, a port-saved
    copy, and a port-exported artifact of each precision."""
    root = tmp_path_factory.mktemp("aot")
    jdir = str(root / "jax_saved")
    save_jax_model(jdir)
    feed = feed_of(B)
    jp = jax_pred(jdir)
    want = np.asarray(jp.run(feed)[0])
    for n in FEEDS:
        jp.get_input_tensor(n).copy_from_cpu(feed[n])
    jp.zero_copy_run()
    jzc = np.asarray(jp.get_output_tensor(jp.get_output_names()[0])
                     .copy_to_cpu())
    # the port's save of the same model (program mode, both packages read)
    pdir = str(root / "port_saved")
    p = port_pred(jdir)
    exe = pfluid.Executor(pfluid.CPUPlace())
    with pfluid.scope_guard(p._scope):
        pfluid.io.save_inference_model(pdir, p.get_input_names(),
                                       [p._program.global_block().var(
                                           p.get_output_names()[0])],
                                       exe, main_program=p._program)
    artifacts = {}
    for kind in ("fp32", "quant"):
        adir = str(root / f"aot_{kind}")
        shutil.copytree(jdir, adir)
        src = port_pred(adir, quant=kind == "quant")
        program_out = src.run(feed)[0]
        src.export_serialized(feed)
        artifacts[kind] = (adir, program_out)
    return dict(jdir=jdir, pdir=pdir, feed=feed, want=want, jzc=jzc,
                artifacts=artifacts)


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_cross_loads_both_ways(model):
    close(port_pred(model["jdir"]).run(model["feed"])[0], model["want"])
    close(np.asarray(jax_pred(model["pdir"]).run(model["feed"])[0]),
          model["want"])


def test_zero_copy_equals_run_and_jax(model):
    p = port_pred(model["jdir"])
    feed = model["feed"]
    for n in FEEDS:
        p.get_input_tensor(n).copy_from_cpu(feed[n])
    assert isinstance(p.get_input_tensor("src_ids")._buf, torch.Tensor)
    p.zero_copy_run()
    out = p.get_output_tensor(p.get_output_names()[0])
    assert isinstance(out._buf, torch.Tensor)      # on the device until read
    staged = out.copy_to_cpu()
    ran = p.run(feed)[0]
    assert np.array_equal(staged, ran)
    close(staged, model["jzc"])
    # after run() the output view holds run()'s answer
    assert np.array_equal(out.copy_to_cpu(), ran)
    # a new staging and zero_copy_run replace it again
    other = feed_of(B, seed=4)
    for n in FEEDS:
        p.get_input_tensor(n).copy_from_cpu(other[n])
    p.zero_copy_run()
    assert np.array_equal(out.copy_to_cpu(), p.run(other)[0])
    with pytest.raises(RuntimeError, match="never staged"):
        fresh = port_pred(model["jdir"])
        fresh.zero_copy_run()


def test_aot_predictor_loads_the_artifact_without_the_program(model,
                                                              monkeypatch):
    adir, program_out = model["artifacts"]["fp32"]

    def no_program(*a, **k):
        raise AssertionError("the AOT predictor loaded the Program")

    monkeypatch.setattr(pfluid.io, "load_inference_model", no_program)
    p = port_pred(adir)
    assert p._program is None and p._aot is not None
    got = p.run(model["feed"])[0]
    assert np.array_equal(got, program_out)
    close(got, model["want"])
    nodes = [str(n.target) for n in p._aot.ep.graph.nodes
             if n.op == "call_function"]
    assert nodes.count(pinf.CUSTOM_OPS["K1"]) == CFG["num_layers"]
    # zero-copy on the artifact
    for n in FEEDS:
        p.get_input_tensor(n).copy_from_cpu(model["feed"][n])
    p.zero_copy_run()
    assert np.array_equal(
        p.get_output_tensor(p.get_output_names()[0]).copy_to_cpu(), got)


def test_quantized_artifact_holds_k6_nodes(model):
    adir, program_out = model["artifacts"]["quant"]
    p = port_pred(adir)
    got = p.run(model["feed"])[0]
    assert np.array_equal(got, program_out)
    nodes = [str(n.target) for n in p._aot.ep.graph.nodes
             if n.op == "call_function"]
    # every fc and matmul of the encoder and the head: 6 a layer + pooler
    # + classifier
    assert nodes.count(pinf.CUSTOM_OPS["K6"]) == 6 * CFG["num_layers"] + 2
    assert nodes.count(pinf.CUSTOM_OPS["K1"]) == CFG["num_layers"]
    meta = json.load(open(os.path.join(adir, pinf.SERIALIZED_META)))
    assert meta["quant"] is True and meta["custom_ops"] == {
        "K1": CFG["num_layers"], "K6": 6 * CFG["num_layers"] + 2}


def test_meta_and_manifest(model):
    adir, _ = model["artifacts"]["fp32"]
    meta = json.load(open(os.path.join(adir, pinf.SERIALIZED_META)))
    for key in ("feed_names", "feed_order", "feed_dtypes", "fetch_names",
                "fetch_dtypes", "amp", "quant"):
        assert key in meta, key
    assert meta["format"] == "torch.export" and meta["device"] == "cpu"
    assert meta["feed_names"] == FEEDS
    assert meta["feed_order"] == sorted(FEEDS)
    assert meta["feed_dtypes"] == ["float32", "int64", "int64", "int64"]
    assert meta["fetch_dtypes"] == ["float32"]
    assert meta["amp"] is False and meta["quant"] is False
    lines = open(os.path.join(adir, pinf.MANIFEST)).read().splitlines()
    assert lines[0] == "4" and lines[1] == f"attn_bias float32 4 {B} 1 1 {T}"
    assert lines[5] == "1" and lines[6].endswith(f"float32 2 {B} 2")
    assert not os.path.exists(os.path.join(adir, "__stablehlo__.bin"))


def test_bf16_on_an_artifact_warns_once_per_directory(model, capsys):
    adir, _ = model["artifacts"]["quant"]
    pinf._BF16_AOT_WARNED.discard(adir)
    port_pred(adir, bf16=True)
    port_pred(adir, bf16=True)
    err = capsys.readouterr().err
    assert err.count("WARNING: enable_bf16() has no effect") == 1
    assert "float32" in err and "int8-quantized weights" in err


def test_refusals(model, tmp_path):
    # the JAX package's executable
    jdir = str(tmp_path / "jax_artifact")
    shutil.copytree(model["jdir"], jdir)
    open(os.path.join(jdir, pinf.JAX_SERIALIZED), "wb").close()
    with pytest.raises(pinf.AOTArtifactError, match="JAX package"):
        port_pred(jdir)
    # an artifact exported on another device kind
    cdir = str(tmp_path / "card_artifact")
    shutil.copytree(model["artifacts"]["fp32"][0], cdir)
    path = os.path.join(cdir, pinf.SERIALIZED_META)
    meta = json.load(open(path))
    meta.update(device="cuda", device_name="NVIDIA H100 80GB HBM3")
    json.dump(meta, open(path, "w"))
    with pytest.raises(pinf.AOTArtifactError, match="'cuda'.*'cpu'"):
        port_pred(cdir)
    # a host op, and a generator op, in the program
    p = port_pred(model["jdir"])
    block = p._program.global_block()
    block.prepend_op(type="print", inputs={"In": ["src_ids"]}, outputs={},
                     attrs={"message": "ids"})
    with pytest.raises(pinf.AOTArtifactError, match="print"):
        p.export_serialized(model["feed"], dirname=str(tmp_path / "x"))
    p = port_pred(model["jdir"])
    p._program.global_block().prepend_op(
        type="uniform_random", inputs={}, outputs={"Out": ["noise"]},
        attrs={"shape": [2], "seed": 1})
    with pytest.raises(pinf.AOTArtifactError, match="uniform_random"):
        p.export_serialized(model["feed"], dirname=str(tmp_path / "y"))
    # an AOT predictor exports nothing again
    with pytest.raises(pinf.AOTArtifactError, match="already"):
        port_pred(model["artifacts"]["fp32"][0]).export_serialized(
            model["feed"])


def test_kernels_without_a_custom_op_refuse_an_export():
    class Softmax(torch.nn.Module):
        def forward(self, x, lens):
            return sequence_kernels.masked_softmax(x, lens)

    class Attention(torch.nn.Module):
        def forward(self, q):
            return ak.flash_attention(q, q, q)

    x = torch.randn(2, 5)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    with pytest.raises(cuda_build.KernelNotExportable, match="K7"):
        torch.export.export(Softmax(), (x, lens), strict=False)
    ep = torch.export.export(Attention(), (torch.randn(1, 2, 4, 8),),
                             strict=False)
    # the whole graph is the one K1 node (and the getitems of its
    # (out, lse) pair): no trace of the plain version
    assert [str(n.target) for n in ep.graph.nodes
            if n.op == "call_function" and "getitem" not in str(n.target)
            ] == [pinf.CUSTOM_OPS["K1"]]


def test_serving_engine_over_the_aot_handle(model):
    adir, _ = model["artifacts"]["fp32"]
    p = port_pred(adir)
    handle = p.serving_handle()
    assert handle.fixed_shapes[0][0] == B
    with pytest.raises(RuntimeError, match="program-mode"):
        handle.check_reloadable()
    engine = pfluid.serving.ServingEngine(
        p, pfluid.serving.ServingConfig(max_batch_size=16, max_wait_ms=1.0))
    try:
        assert engine.warmup() == 1
        rows = feed_of(5, seed=9)
        futures = [engine.submit({n: rows[n][i:i + 1] for n in FEEDS})
                   for i in range(5)]
        served = np.concatenate([f.result(30)[0] for f in futures])
    finally:
        engine.stop()
    direct = np.concatenate([
        p.run({n: np.concatenate([rows[n][i:i + 1]] * B) for n in FEEDS})[0][:1]
        for i in range(5)])
    np.testing.assert_allclose(served, direct, rtol=TOL, atol=TOL)
    assert engine.stats()["batch_buckets"] == [B]
