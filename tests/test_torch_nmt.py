"""Transformer NMT training in the port against the JAX package at small
size (2 layers, d_model 64, vocabulary 300), and the dropout op's two
arms (the plain version and the hand-written kernel K10's, whose plain
version is the CPU path).

The training program (``models/transformer.py::transformer`` with label
smoothing, ``Adam.minimize``) equals the JAX package's op for op; the
``one_hot`` and ``label_smooth`` ops equal the JAX ops; from the JAX
package's startup state (``zoo.snapshot_startup``) the port's loss list
over 3 Adam steps at dropout 0 matches the JAX package's (relative 1e-4:
float32 through softmax, layer norm and Adam's sqrt in two frameworks).
With dropout the two packages draw different bits by design, so dropout
is held to its keep rate (within 4 standard deviations of 1 - p), to the
same mask for the cotangent, and to equal losses with
``FLAGS_use_fused_dropout`` on and off on the CPU (the plain arm both
times).
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
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu.models import zoo
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch import flags as port_flags
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.core.executor import read_names
from paddle_tpu_torch.models import transformer as port_transformer
from paddle_tpu_torch.ops import dropout_kernels
from paddle_tpu_torch.ops import registry as port_registry

VOCAB, LAYERS, HEADS, D_MODEL, D_INNER = 300, 2, 4, 64, 128
B, T = 4, 16


@pytest.fixture(autouse=True)
def composed_jax_attention(monkeypatch):
    # the JAX side's attention runs its plain composed form, and compiles
    # its steps afresh (the persistent jit cache is shared by the test
    # workers; ROADMAP queue 3)
    monkeypatch.setitem(jax_flags._overrides, "force_attention_impl",
                        "composed")
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)
    monkeypatch.setattr(port_flags, "_overrides", {})


def build(pkg, dropout=0.1, eps=0.1):
    """(main, startup, loss) of the NMT training program, built by the JAX
    package (pkg "jax") or the port under a fresh name generator."""
    fluid, tr, init, names = (
        (jfluid, jax_transformer, jax_init, jax_unique_name) if pkg == "jax"
        else (pfluid, port_transformer, port_init, port_unique_name))
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    with names.guard(), fluid.program_guard(main, startup):
        loss, _, _ = tr.transformer(
            VOCAB, VOCAB, T + 1, LAYERS, HEADS, D_MODEL // HEADS,
            D_MODEL // HEADS, D_MODEL, D_INNER, dropout_rate=dropout,
            label_smooth_eps=eps)
        fluid.optimizer.Adam(learning_rate=2e-4).minimize(loss)
    return main, startup, loss


def nmt_feed(seed=0, b=B, t=T):
    """One bucket batch as ``bench.py::bench_nmt``'s make_batch builds it:
    lengths in (t/2, t], padded to t."""
    rng = np.random.RandomState(seed)
    src_lens = rng.randint(t // 2 + 1, t + 1, b)
    trg_lens = rng.randint(t // 2 + 1, t + 1, b)
    sw = rng.randint(1, VOCAB, (b, t)).astype(np.int64)
    tw = rng.randint(1, VOCAB, (b, t)).astype(np.int64)
    pos = np.tile(np.arange(t, dtype=np.int64), (b, 1))
    sb, tb, xb = port_transformer.make_attn_biases(src_lens, trg_lens,
                                                   HEADS, t, t)
    lblw = (np.arange(t)[None, :] < trg_lens[:, None]).astype(
        np.float32)[..., None]
    return {"src_word": sw, "src_pos": pos, "trg_word": tw,
            "trg_pos": pos, "src_slf_attn_bias": sb,
            "trg_slf_attn_bias": tb, "trg_src_attn_bias": xb,
            "lbl_word": tw[..., None], "lbl_weight": lblw}


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


def test_nmt_program_equals_jax_program():
    jmain, jstart, jloss = build("jax")
    pmain, pstart, ploss = build("port")
    assert ploss.name == jloss.name
    types = [op.type for op in pmain.global_block().ops]
    assert {"one_hot", "label_smooth", "fused_attention",
            "generic_grad", "adam"} <= set(types)
    # 7 dropouts a layer pair (42 at transformer-base's 6 + 6 layers)
    assert types.count("dropout") == 7 * LAYERS
    for jp, pp in ((jmain, pmain), (jstart, pstart)):
        js, ps = _signature(jp), _signature(pp)
        assert len(js) == len(ps)
        for (jops, jvars), (pops, pvars) in zip(js, ps):
            assert pvars == jvars
            assert len(pops) == len(jops)
            for jo, po in zip(jops, pops):
                assert po == jo


def test_nmt_attention_biases_take_no_grad():
    """The three attention biases are data vars: no grad op asks for
    their grad, so the flash-attention backward never writes a full
    [B, H, T, T] dBias."""
    main, _, _ = build("port")
    biases = {"src_slf_attn_bias", "trg_slf_attn_bias",
              "trg_src_attn_bias"}
    for op in main.global_block().ops:
        if op.type == "generic_grad" and \
                op.attrs["fw_type"] == "fused_attention":
            needs = {op.inputs[s][i] for s, i in
                     op.attrs["needs_input_grad"]}
            assert not needs & biases and ("Bias", 0) not in \
                op.attrs["needs_input_grad"]


def _int_ids(shape, lo, hi, seed):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(
        np.int64)


OP_CASES = [
    ("one_hot", lambda: {"X": [_int_ids((6, 1), 0, 10, 1)]},
     {"depth": 10}),
    ("one_hot", lambda: {"X": [_int_ids((2, 5, 1), -2, 12, 2)]},
     {"depth": 10}),
    ("one_hot", lambda: {"X": [_int_ids((3, 4), 0, 7, 3)]}, {"depth": 7}),
    ("label_smooth", lambda: {"X": [np.eye(7, dtype=np.float32)[
        _int_ids((5,), 0, 7, 4)]]}, {"epsilon": 0.1}),
    ("label_smooth", lambda: {
        "X": [np.eye(6, dtype=np.float32)[_int_ids((2, 3), 0, 6, 5)]],
        "PriorDist": [np.random.RandomState(6).dirichlet(
            np.ones(6)).astype(np.float32)[None, :]]}, {"epsilon": 0.25}),
]


@pytest.mark.parametrize("op_type,ins,attrs", OP_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(OP_CASES)])
def test_nmt_loss_ops_match_jax(op_type, ins, attrs):
    ins = ins()
    want = np.asarray(jax_registry.run_op(
        op_type, {s: [jnp.asarray(v) for v in vs] for s, vs in ins.items()},
        dict(attrs))["Out"][0])
    got = port_registry.run_op(
        op_type, {s: [torch.from_numpy(v) for v in vs]
                  for s, vs in ins.items()}, dict(attrs))["Out"][0]
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def jax_state_and_losses():
    """The JAX package's startup state and its 3-step loss list at
    dropout 0 (label smoothing 0.1), on one seeded batch."""
    jax_flags._overrides.update(force_attention_impl="composed",
                                jit_cache=False)
    try:
        main, startup, loss = build("jax", dropout=0.0)
        feed = nmt_feed()
        zp = zoo.ZooProgram("nmt", main, startup,
                            {k: (v.shape, str(v.dtype))
                             for k, v in feed.items()}, [loss.name])
        state = zoo.snapshot_startup(zp)
        exe = jfluid.Executor()
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            for n, v in state.items():
                scope.set_var(n, np.array(v, copy=True))
            losses = [float(np.asarray(exe.run(main, feed=feed,
                                               fetch_list=[loss])[0]))
                      for _ in range(3)]
    finally:
        jax_flags._overrides.pop("force_attention_impl", None)
        jax_flags._overrides.pop("jit_cache", None)
    return state, losses


def port_losses(state, steps=3, dropout=0.0, fused=False, seed=0):
    main, _, loss = build("port", dropout=dropout)
    main.random_seed = seed
    pfluid.set_flags({"use_fused_dropout": fused})
    scope = pfluid.io.state_from_numpy(state, scope=pfluid.Scope(),
                                       place=pfluid.CPUPlace(),
                                       main_program=main)
    exe = pfluid.Executor(pfluid.CPUPlace())
    feed = nmt_feed()
    return [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0]) for _ in range(steps)]


def test_nmt_losses_match_jax_from_its_startup_state(jax_state_and_losses):
    state, want = jax_state_and_losses
    got = port_losses(state)
    assert np.all(np.isfinite(got)) and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_nmt_dropout_fused_flag_on_and_off_agree_on_cpu(
        jax_state_and_losses):
    state, _ = jax_state_and_losses
    off = port_losses(state, steps=2, dropout=0.1)
    on = port_losses(state, steps=2, dropout=0.1, fused=True)
    plain = port_losses(state, steps=1)
    assert on == off
    assert np.all(np.isfinite(on)) and on[0] != plain[0]
    assert dropout_kernels.fused_dropout.launches == 0


# ---- the dropout op's arms --------------------------------------------

P = 0.3
SIGMA4 = 4 * np.sqrt(P * (1 - P) / 20000)


def _run(op_type, ins, attrs, step=0, reads=None, op=None):
    ctx = port_registry.ExecContext(seed=11, step=step, masks={},
                                    reads=reads)
    ctx.op = op
    with port_registry.exec_context(ctx):
        return port_registry.run_op(op_type, ins, attrs)


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
@pytest.mark.parametrize("fused", [False, True])
def test_dropout_keep_rate_and_cotangent_mask(impl, fused, monkeypatch):
    """Over 20000 draws at p=0.3 the keep rate is within 4 sigma of 0.7;
    Out is exactly K10's plain version over the op's mask; the grad op
    applies the same mask to the cotangent, bit for bit; the flag changes
    nothing on the CPU."""
    monkeypatch.setattr(port_flags, "_overrides",
                        {"use_fused_dropout": fused})
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (200, 100)).astype(np.float32))
    og = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (200, 100)).astype(np.float32))
    attrs = {"dropout_prob": P, "seed": 3, "dropout_implementation": impl}
    res = _run("dropout", {"X": [x]}, attrs)
    out, mask = res["Out"][0], res["Mask"][0]
    keep = mask > 0
    assert abs(keep.float().mean().item() - (1 - P)) < SIGMA4
    with port_registry.exec_context(port_registry.ExecContext(seed=11)):
        seed = port_registry.op_seed(attrs)
    upscale = impl == "upscale_in_train"
    assert torch.equal(keep, port_registry.dropout_keep(seed, (200, 100), P,
                                                        x.device))
    assert torch.equal(out, dropout_kernels.fused_dropout_reference(
        x, P, seed, upscale))
    gattrs = {"fw_type": "dropout", "fw_attrs": attrs,
              "fw_in_slots": [("X", 1)],
              "fw_out_slots": [("Out", 1), ("Mask", 1)],
              "needs_input_grad": [("X", 0)],
              "has_out_grad": [("Out", 0)]}
    dx = _run("generic_grad", {"X": [x], "Out@GRAD_OUT": [og]},
              gattrs)["X@GRAD"][0]
    assert torch.equal(dx, dropout_kernels.fused_dropout_reference(
        og, P, seed, upscale))
    assert not torch.equal(_run("dropout", {"X": [x]}, attrs,
                                step=1)["Out"][0], out)


class _Op:
    def __init__(self, outputs):
        self.outputs = outputs


@pytest.mark.parametrize("is_test", [False, True])
def test_dropout_mask_only_when_read(is_test):
    x = torch.ones(8, 8)
    attrs = {"dropout_prob": 0.5, "seed": 1, "is_test": is_test}
    op = _Op({"Out": ["d.out"], "Mask": ["d.mask"]})
    unread = _run("dropout", {"X": [x]}, attrs, reads={"d.out"}, op=op)
    read = _run("dropout", {"X": [x]}, attrs, reads={"d.mask"}, op=op)
    assert set(unread) == {"Out"} and set(read) == {"Out", "Mask"}
    assert torch.equal(read["Out"][0], unread["Out"][0])
    # outside an Executor run (no read set) the Mask is made
    assert "Mask" in _run("dropout", {"X": [x]}, attrs)


def test_dropout_mask_through_the_executor():
    """In a program, Mask is made only when a later op reads it or the
    caller fetches it; a generic_grad op's forward-output input does not
    count, and the grad op runs without it."""
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        x = pfluid.layers.data(name="x", shape=[16], dtype="float32")
        h = pfluid.layers.fc(input=x, size=16)
        d = pfluid.layers.dropout(h, dropout_prob=0.5, seed=4)
        loss = pfluid.layers.mean(d)
        pfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    drop = next(op for op in main.global_block().ops
                if op.type == "dropout")
    mask_name = drop.outputs["Mask"][0]
    assert mask_name not in read_names(main.global_block(), [loss.name])
    assert mask_name in read_names(main.global_block(), [mask_name])
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = pfluid.Scope()
    with pfluid.scope_guard(scope):
        exe.run(startup)
        feed = {"x": np.random.RandomState(0).standard_normal(
            (4, 16)).astype(np.float32)}
        l0, = exe.run(main, feed=feed, fetch_list=[loss])
        mask, out = exe.run(main, feed=feed, fetch_list=[mask_name, d])
    assert np.isfinite(l0)
    assert set(np.unique(mask)) <= {0.0, 1.0}
    np.testing.assert_array_equal(out == 0, mask == 0)


@pytest.mark.parametrize("upscale", [True, False])
@pytest.mark.parametrize("shape", [(3, 5, 7), (64, 33), (1,)])
def test_fused_dropout_wrapper_on_cpu_is_its_plain_version(shape, upscale):
    """K10's wrapper on a CPU tensor runs the plain version and launches
    nothing; its autograd grad is the plain version of the cotangent."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    before = dropout_kernels.fused_dropout.launches
    want = dropout_kernels.fused_dropout_reference(x, 0.1, 77, upscale)
    leaf = x.clone().requires_grad_()
    out = dropout_kernels.fused_dropout(leaf, 0.1, 77, upscale)
    (dx,) = torch.autograd.grad(out, leaf, g)
    assert torch.equal(out.detach(), want)
    assert torch.equal(dx, dropout_kernels.fused_dropout_reference(
        g, 0.1, 77, upscale))
    assert dropout_kernels.fused_dropout.launches == before
    for p in (0.0, 1.0):
        with pytest.raises(ValueError, match="p must be in"):
            dropout_kernels.fused_dropout_fwd(x, p, 77)


def test_fused_dropout_reference_arithmetic():
    """The plain version: kept elements are x times float32(1/(1-p)) in
    float32, rounded to the element type (bf16 too); dropped ones +0."""
    x = torch.linspace(-3, 3, 4099)
    keep = port_registry.dropout_keep(9, (4099,), 0.1, x.device)
    s = np.float32(1 / 0.9)
    out = dropout_kernels.fused_dropout_reference(x, 0.1, 9)
    want = np.where(keep.numpy(), x.numpy() * s, np.float32(0))
    np.testing.assert_array_equal(out.numpy(), want)
    assert not torch.signbit(out[~keep]).any()
    xb = x.to(torch.bfloat16)
    outb = dropout_kernels.fused_dropout_reference(xb, 0.1, 9)
    assert outb.dtype == torch.bfloat16
    assert torch.equal(outb, torch.where(keep, (xb.float() * float(s)).to(
        torch.bfloat16), torch.zeros((), dtype=torch.bfloat16)))
    assert torch.equal(dropout_kernels.fused_dropout_reference(
        x, 0.1, 9, upscale=False), torch.where(keep, x, torch.zeros(())))
