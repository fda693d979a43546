"""The port's pass pipeline and verifier against the JAX package's.

Every program the port builds is built in both packages under a fresh name
generator and seed counter — fit_a_line, the zoo's bert_pretrain and
transformer (training programs), and bert_classifier (the serving program)
with and without ``_quant`` — and run through each package's "default"
pipeline: the two outputs are equal op for op (type, inputs, outputs,
attrs) and var for var (shape, dtype, persistable).  The verifier gives
the same findings as the reference on the reference's corpus of corrupted
programs, rebuilt in the port's IR.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import initializer as jax_init
from paddle_tpu import passes as jpasses
from paddle_tpu.analysis import corpus
from paddle_tpu.analysis import verify_program as jax_verify
from paddle_tpu.core import framework as jfw
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.models import bert as jax_bert
from paddle_tpu.models import transformer as jax_tr
from paddle_tpu_torch import flags as port_flags
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch import passes as ppasses
from paddle_tpu_torch.analysis import verify_program as port_verify
from paddle_tpu_torch.core import framework as pfw
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.models import transformer as port_tr

BERT_ZOO = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
                intermediate_size=64, max_position=32, type_vocab_size=2,
                dropout=0.1)
SEQ = 16


def _fit_a_line(fluid, _):
    x = fluid.layers.data(name="x", shape=[13], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1, act=None)
    loss = fluid.layers.mean(
        fluid.layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return loss, ["x", "y"]


def _bert_pretrain(fluid, pkg):
    bert = jax_bert if pkg == "jax" else port_bert
    loss, feeds = bert.bert_pretrain(bert.BertConfig(**BERT_ZOO),
                                     max_seq_len=SEQ)
    fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return loss, feeds


def _transformer(fluid, pkg):
    tr = jax_tr if pkg == "jax" else port_tr
    loss, _, feeds = tr.transformer(
        src_vocab_size=32, trg_vocab_size=32, max_length=16, n_layer=1,
        n_head=2, d_key=8, d_value=8, d_model=16, d_inner_hid=32,
        dropout_rate=0.1)
    fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss, feeds


def _bert_classifier(fluid, pkg):
    cfg = dict(BERT_ZOO, num_layers=2)
    if pkg == "port":
        return port_bert.bert_classifier(port_bert.BertConfig(**cfg), SEQ)
    # the JAX package's counterpart: bert_encoder plus the NSP head
    fl = jfluid.layers
    src, pos, sent = (fl.data(name=n, shape=[SEQ], dtype="int64")
                      for n in ("src_ids", "pos_ids", "sent_ids"))
    bias = fl.data(name="attn_bias", shape=[1, 1, SEQ], dtype="float32")
    seq_out = jax_bert.bert_encoder(src, pos, sent, bias,
                                    jax_bert.BertConfig(**cfg))
    first = fl.slice(seq_out, axes=[1], starts=[0], ends=[1])
    pooled = fl.fc(input=fl.reshape(first, [-1, cfg["hidden_size"]]),
                   size=cfg["hidden_size"], act="tanh")
    return fl.softmax(fl.fc(input=pooled, size=2)), \
        ["src_ids", "pos_ids", "sent_ids", "attn_bias"]


PROGRAMS = {"fit_a_line": _fit_a_line, "bert_pretrain": _bert_pretrain,
            "transformer": _transformer,
            "bert_classifier": _bert_classifier,
            "bert_classifier_quant": _bert_classifier}


def build(pkg, name):
    fluid, init, names = (
        (jfluid, jax_init, jax_unique_name) if pkg == "jax"
        else (pfluid, port_init, port_unique_name))
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    with names.guard(), fluid.program_guard(main, startup):
        out, feeds = PROGRAMS[name](fluid, pkg)
    if name.startswith("bert_classifier"):
        main = main.clone(for_test=True)
        if name.endswith("_quant"):
            main._quant = True
            main._version += 1
    return main, sorted(feeds), [out.name]


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


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_default_pipeline_equals_jax_op_for_op(name):
    jmain, jfeeds, jfetch = build("jax", name)
    pmain, pfeeds, pfetch = build("port", name)
    assert (pfeeds, pfetch) == (jfeeds, jfetch)
    jout, jrep = jpasses.PassManager(
        jpasses.resolve_pipeline("default")).run(
        jmain, jpasses.PassContext(feed_names=jfeeds, fetch_names=jfetch))
    pout, prep = ppasses.PassManager(
        ppasses.resolve_pipeline("default")).run(
        pmain, ppasses.PassContext(feed_names=pfeeds, fetch_names=pfetch))
    assert [(r.name, r.changed, r.op_delta, r.var_delta)
            for r in prep.records] == \
        [(r.name, r.changed, r.op_delta, r.var_delta) for r in jrep.records]
    js, ps = _signature(jout), _signature(pout)
    assert len(ps) == len(js)
    for (jops, jvars), (pops, pvars) in zip(js, ps):
        assert pvars == jvars
        assert len(pops) == len(jops)
        for jo, po in zip(jops, pops):
            assert po == jo
    n_quant = sum("__quant__" in op.attrs for op in pout.global_block().ops)
    assert n_quant == (2 * 6 + 2 if name == "bert_classifier_quant" else 0)
    # the pipeline is its own fixpoint
    again, rep = ppasses.PassManager(
        ppasses.resolve_pipeline("default")).run(
        pout, ppasses.PassContext(feed_names=pfeeds, fetch_names=pfetch))
    assert again is pout and not rep.changed


def _to_port(jprog):
    """The same program in the port's IR: blocks, vars, ops and
    program-level records, Block attrs pointing at the port's blocks."""
    p = pfw.Program()
    for k, v in jprog.__dict__.items():
        if k != "blocks":
            p.__dict__[k] = v
    p.blocks = [pfw.Block(p, jb.idx, jb.parent_idx) for jb in jprog.blocks]
    for jb, pb in zip(jprog.blocks, p.blocks):
        for name, v in jb.vars.items():
            kw = dict(shape=v.shape, dtype=v.dtype, lod_level=v.lod_level,
                      persistable=v.persistable,
                      stop_gradient=v.stop_gradient, name=name)
            if isinstance(v, jfw.Parameter):
                nv = pfw.Parameter(pb, trainable=v.trainable, **kw)
            else:
                nv = pfw.Variable(pb, is_data=v.is_data, **kw)
            nv.sharding = v.sharding
            pb.vars[name] = nv
        for op in jb.ops:
            no = pfw.Operator(pb, op.type)
            no.inputs = {k: list(vs) for k, vs in op.inputs.items()}
            no.outputs = {k: list(vs) for k, vs in op.outputs.items()}
            no.attrs = {k: (p.blocks[v.idx] if isinstance(v, jfw.Block)
                            else v) for k, v in op.attrs.items()}
            pb.ops.append(no)
    return p


def _findings(fs):
    return [(f.rule, f.severity, f.block_idx, f.op_idx, f.var, f.message)
            for f in fs]


@pytest.mark.parametrize("case", corpus.all_cases(), ids=lambda c: c[0])
def test_verifier_findings_equal_jax_on_corrupted_programs(case):
    name, prog, feeds, fetches, expect = case
    want = _findings(jax_verify(prog, feed_names=feeds,
                                fetch_names=fetches))
    got = _findings(port_verify(_to_port(prog), feed_names=feeds,
                                fetch_names=fetches))
    assert got == want
    assert expect in {f[0] for f in got}


@pytest.mark.parametrize("spec", ["default,memory", "remat", "all",
                                  "default,-eager_deletion",
                                  "plan_donation"])
def test_memory_passes_raise(spec):
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        ppasses.resolve_pipeline(spec)


def test_unknown_pipeline_token_raises_and_off_is_identity(monkeypatch):
    with pytest.raises(ValueError, match="unknown token"):
        ppasses.resolve_pipeline("default,cse2")
    assert ppasses.resolve_pipeline("off") == []
    assert ppasses.resolve_pipeline("-cse,default") == [
        n for n in ppasses.PRESETS["default"] if n != "cse"]
    main, feeds, fetch = build("port", "bert_classifier_quant")
    monkeypatch.setitem(port_flags._overrides, "pass_pipeline", "off")
    assert ppasses.apply_at_seam(main, feeds, fetch) is main
    monkeypatch.setitem(port_flags._overrides, "pass_pipeline", "default")
    out = ppasses.apply_at_seam(main, feeds, fetch)
    assert out is not main
    assert ppasses.apply_at_seam(main, feeds, fetch) is out      # memo
    assert ppasses.report_for(out).changed


def test_validate_at_seam_modes(monkeypatch, capsys):
    """warn prints once per program version, strict raises, off skips;
    a clean program prints nothing."""
    from paddle_tpu_torch.analysis import (ProgramVerificationError,
                                           validate_at_seam)

    _, prog, feeds, fetches, _ = next(
        c for c in corpus.all_cases() if c[0] == "bad_dangling_input")
    prog = _to_port(prog)
    assert validate_at_seam(prog, feeds, fetches, where="test")
    assert "dangling-input" in capsys.readouterr().err
    assert validate_at_seam(prog, feeds, fetches, where="test") == []
    assert capsys.readouterr().err == ""
    prog._version += 1
    monkeypatch.setitem(port_flags._overrides, "validate_program", "strict")
    with pytest.raises(ProgramVerificationError, match="dangling-input"):
        validate_at_seam(prog, feeds, fetches, where="test")
    monkeypatch.setitem(port_flags._overrides, "validate_program", "off")
    assert validate_at_seam(prog, feeds, fetches, where="test") == []
    monkeypatch.setitem(port_flags._overrides, "validate_program", "warn")
    main, feeds, fetch = build("port", "bert_classifier")
    assert validate_at_seam(main, feeds, fetch, where="test") == []
    assert capsys.readouterr().err == ""


def test_pass_metrics_count_runs():
    ppasses.METRICS.reset()
    main, feeds, fetch = build("port", "bert_classifier_quant")
    ppasses.PassManager(["cse", "quantize_weights"]).run(
        main, ppasses.PassContext(feed_names=feeds, fetch_names=fetch))
    snap = ppasses.METRICS.snapshot()
    assert snap["quantize_weights"]["runs"] == 1
    assert snap["quantize_weights"]["changed"] == 1
    assert np.isfinite(snap["cse"]["ms"])
