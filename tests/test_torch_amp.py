"""bf16 mixed precision (``contrib.mixed_precision``, ``AnalysisConfig.
enable_bf16``) in the port against the JAX package on the CPU, and the
Executor's verifier and pass-pipeline seams.

The port keeps the JAX package's design: a cast policy wraps kernel
dispatch (``ops/registry.py``), the pass pipeline's ``amp_propagate``
decides each op's precision first, parameters and optimizer state stay
fp32, and there is no loss scaling.  So the port must give the JAX
package's precision plan op for op and variable dtype for variable dtype.

Numbers: the zoo's bert_pretrain, resnet_cifar10 and transformer (dropout
0: the two packages draw different dropout bits by design) take one AMP
step from the JAX package's state (``zoo.snapshot_startup``), fetching
every variable their ops write.  The JAX package's steps run with XLA's
``xla_allow_excess_precision`` off, so that XLA rounds each op's bf16
output as the program says instead of fusing past it (on, it keeps some
fused intermediates in fp32, which no op-by-op interpreter does).

- Op by op: every op of the step runs in the port on the JAX package's
  own inputs to it, and each float output is held to the JAX package's
  within OP_RTOL; where AMP changes the op's output (its fp32 control,
  the same op in fp32 on the same inputs, lands OP_MATERIAL or more from
  the JAX package's), the port must sit under half that distance, so an
  op run at another precision than the JAX package's fails.
- The whole step: the loss within LOSS_RTOL of the JAX package's AMP
  loss, each parameter's gradient within GRAD_GAP of the JAX package's
  AMP gradient (2-norm of the leaf, relative).  These tolerances are
  wider than the op-by-op ones because the step compounds differences:
  one ReLU input near 0 that rounds to the other side of 0 in one
  framework changes its row's gradient whole.
- The whole step against the JAX package's own bf16-vs-fp32 distance:
  where that distance is material, the port's AMP loss and gradients sit
  under half of it, and the port's fp32 step, a planted wrong-precision
  run, does not (see ROUNDED_INSIDE for what is left out).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.stages

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu import passes as jpasses
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.models import zoo as jax_zoo
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch import flags as port_flags
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch import passes as ppasses
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.core.executor import Executor as PortExecutor
from paddle_tpu_torch.models import zoo as port_zoo
from paddle_tpu_torch.ops import nn_ops as port_nn_ops
from paddle_tpu_torch.ops import registry as port_registry

CPU = pfluid.CPUPlace()
ZOO_AMP = ("bert_pretrain", "resnet_cifar10", "transformer")
OP_RTOL, OP_MATERIAL, RMS_FLOOR = 1e-2, 1e-4, 1e-3
LOSS_RTOL, GRAD_GAP = 1e-2, 0.25
# the whole step's half rule holds a loss whose JAX bf16-vs-fp32 distance
# is LOSS_MATERIAL or more, relative, and a gradient leaf whose distance
# (2-norm of the leaf) is GRAD_MATERIAL or more
LOSS_MATERIAL, GRAD_MATERIAL = 1e-4, 1e-3


@pytest.fixture(autouse=True)
def isolated_flags(monkeypatch):
    # the JAX side's attention runs its flash kernel in interpret mode
    # (what the port's K1/K2 mirror), and it compiles its steps afresh
    # (the persistent jit cache is shared by the test workers); the
    # port's flags are its defaults
    monkeypatch.setitem(jax_flags._overrides, "force_attention_impl",
                        "pallas")
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)
    monkeypatch.setattr(port_flags, "_overrides", {})


@contextlib.contextmanager
def rounded_xla():
    """XLA compiles with ``xla_allow_excess_precision`` off."""
    compile_ = jax.stages.Lowered.compile

    def strict(self, compiler_options=None, **kw):
        opts = dict(compiler_options or {}, xla_allow_excess_precision=False)
        return compile_(self, compiler_options=opts, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.stages.Lowered, "compile", strict)
        yield


def build_zoo(name, pkg):
    zoo, init, names = (jax_zoo, jax_init, jax_unique_name) if pkg == "jax" \
        else (port_zoo, port_init, port_unique_name)
    init._auto_seed_counter[0] = 1
    with names.guard():
        zp = zoo.build(name)
    for op in zp.main.global_block().ops:
        for attrs in (op.attrs, op.attrs.get("fw_attrs", {})):
            if "dropout_prob" in attrs:
                attrs["dropout_prob"] = 0.0
    return zp


def amp_plan(program, feeds, fetches, passes):
    """The default pipeline's output of `program`: [(op type, __amp__ of
    the op, __amp__ of its forward's attrs for a grad op)]."""
    out = passes.apply_at_seam(program, feed_names=sorted(feeds),
                               fetch_names=list(fetches))
    return [(op.type, op.attrs.get("__amp__"),
             op.attrs.get("fw_attrs", {}).get("__amp__"))
            for blk in out.blocks for op in blk.ops]


@pytest.mark.parametrize("name", ZOO_AMP)
def test_amp_plan_equals_the_jax_plan(name):
    j, p = build_zoo(name, "jax"), build_zoo(name, "port")
    jfluid.contrib.mixed_precision.enable(j.main)
    pfluid.contrib.mixed_precision.enable(p.main)
    want = amp_plan(j.main, j.feeds, j.fetch_names, jpasses)
    got = amp_plan(p.main, p.feeds, p.fetch_names, ppasses)
    assert got == want
    assert {"bf16", "fp32"} <= {m for _, m, _ in got}


def grad_names(prog):
    return {op.inputs["Param"][0]: op.inputs["Grad"][0]
            for op in prog.global_block().ops
            if "Param" in op.inputs and "Grad" in op.inputs}


def produced(prog):
    """Every name an op of the global block writes, in order."""
    return list(dict.fromkeys(n for op in prog.global_block().ops
                              for n in op.output_arg_names))


def jax_step(zp, state, feed, amp, fetch):
    """One step of the JAX package from `state`: its fetches, as arrays
    of their own dtypes, and the program it ran (after the pipeline)."""
    mp = jfluid.contrib.mixed_precision
    (mp.enable if amp else mp.disable)(zp.main)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope), rounded_xla():
        for n, v in state.items():
            scope.set_var(n, np.array(v, copy=True))
        out = jfluid.Executor().run(zp.main, feed=feed, fetch_list=fetch,
                                    return_numpy=False)
    ran = jpasses.apply_at_seam(zp.main, feed_names=sorted(feed),
                                fetch_names=fetch)
    return dict(zip(fetch, out)), ran


@pytest.fixture(scope="module")
def amp_steps():
    """For each zoo model, one step from the JAX package's state: the
    JAX package's fp32 and AMP fetches (the loss, every parameter's
    gradient, every name the program's ops write), the program its AMP
    step ran, the port's AMP fetches and scope, and the port's fp32
    fetches."""
    steps = {}
    for name in ZOO_AMP:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(jax_flags._overrides, "force_attention_impl",
                       "pallas")
            mp.setitem(jax_flags._overrides, "jit_cache", False)
            mp.setattr(port_flags, "_overrides", {})
            j, p = build_zoo(name, "jax"), build_zoo(name, "port")
            state = jax_zoo.snapshot_startup(j)
            feed = jax_zoo.example_feed_arrays(j)
            fetch = list(dict.fromkeys(j.fetch_names + produced(j.main)))
            jf32, _ = jax_step(j, state, feed, False, fetch)
            jamp, ran = jax_step(j, state, feed, True, fetch)
            pfluid.contrib.mixed_precision.enable(p.main)
            pscope = pfluid.io.state_from_numpy(
                state, scope=pfluid.Scope(), place=CPU, main_program=p.main)
            pamp = pfluid.Executor(CPU).run(
                p.main, feed=feed, fetch_list=fetch, scope=pscope,
                return_numpy=False)
            pfluid.contrib.mixed_precision.disable(p.main)
            pf32 = pfluid.Executor(CPU).run(
                p.main, feed=feed, fetch_list=fetch, return_numpy=False,
                scope=pfluid.io.state_from_numpy(
                    state, scope=pfluid.Scope(), place=CPU,
                    main_program=p.main))
        steps[name] = dict(fetch=fetch, grads=grad_names(j.main),
                           state=state, feed=feed, jf32=jf32, jamp=jamp,
                           ran=ran, pamp=dict(zip(fetch, pamp)),
                           pf32=dict(zip(fetch, pf32)), pscope=pscope)
    return steps


# 64-bit IR types run as 32-bit in the JAX package
NARROW = {"int64": "int32", "float64": "float32"}


def dtype_name(v):
    return str(v.dtype).replace("torch.", "")


def as_f64(v):
    # np.asarray reads a JAX array through its layout; a jnp cast of an
    # array the executor handed out in a non-default layout does not
    if isinstance(v, torch.Tensor):
        return v.detach().double().numpy()
    return np.asarray(v).astype(np.float64)


def rel(a, b):
    """Relative 2-norm distance; a value whose RMS is below RMS_FLOOR (a
    layer norm's mean of normalized rows) is measured against the
    floor."""
    floor = RMS_FLOOR * np.sqrt(max(b.size, 1))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor))


@pytest.mark.parametrize("name", ZOO_AMP)
def test_amp_step_variable_dtypes_equal_the_jax_ones(name, amp_steps):
    """After one AMP step every variable the program writes has the JAX
    package's dtype, bf16 activations among them, and every parameter and
    optimizer accumulator is still fp32."""
    s = amp_steps[name]
    got = {n: NARROW.get(dtype_name(v), dtype_name(v))
           for n, v in s["pamp"].items()}
    want = {n: dtype_name(v) for n, v in s["jamp"].items()}
    assert got == want
    assert "bfloat16" in set(want.values())
    for n, v in s["pscope"].vars.items():
        if np.asarray(s["state"].get(n, 0)).dtype == np.float32:
            assert v.dtype == torch.float32, n


def to_port(value, ir_dtype):
    """A JAX package value as the port holds it (the IR's 64-bit ints)."""
    value = np.asarray(value)
    if value.dtype == jnp.bfloat16:
        return torch.from_numpy(value.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(value))
    return t.long() if ir_dtype == "int64" else t


def run_port_op(op, ins, amp):
    ctx = port_registry.ExecContext(amp=amp, masks={})
    with torch.no_grad(), port_registry.exec_context(ctx):
        ctx.op = op
        return port_registry.run_op(op.type, ins, op.attrs)


# ops whose JAX kernel rounds partial results to bf16 inside the op, where
# the port's rounds once, at its output: an average pool sums its windows
# in bf16 (XLA on the CPU, with every bf16 result rounded), gelu and
# tanh's grad chain bf16 primitives, and batch norm's vjp casts X to fp32
# once for each of its three uses, so the three parts of dX are rounded
# to bf16 apart and summed in bf16.  The port's are nearer the fp32
# answer; these are held to OP_RTOL only
ROUNDS_INSIDE = {"pool2d", "gelu", "tanh", "batch_norm"}


@pytest.mark.parametrize("name", ZOO_AMP)
def test_amp_ops_match_the_jax_ops_one_by_one(name, amp_steps):
    """Each op of the JAX package's AMP step, run by the port on the JAX
    package's inputs to it: its outputs' dtypes, and its float outputs
    within OP_RTOL and, where AMP changes the output, under half the
    distance of the fp32 control (see the module docstring).  A name
    written by more than one op (a grad that a later ``sum`` accumulates
    into) is known only in its last version: an op that reads an earlier
    one is left out, and so is an output a later op writes again."""
    s = amp_steps[name]
    block = s["ran"].global_block()
    last = {}
    for i, op in enumerate(block.ops):
        for n in op.output_arg_names:
            last[n] = i
    values = dict(s["jamp"], **s["feed"])
    values.update(s["state"])          # what each op read: the step's start
    checked = discriminated = 0
    for i, op in enumerate(block.ops):
        if any(last.get(n, -1) >= i and n not in s["state"]
               for n in op.input_arg_names):
            continue
        ins = {slot: [to_port(values[n], block._find_var_recursive(n).dtype)
                      if n in values else None for n in names]
               for slot, names in op.inputs.items()}
        f32_ins = {slot: [v.float() if v is not None and v.dtype ==
                          torch.bfloat16 else v for v in vs]
                   for slot, vs in ins.items()}
        got = run_port_op(op, ins, amp=True)
        control = run_port_op(op, f32_ins, amp=False)
        for slot, names in op.outputs.items():
            for n, p, c in zip(names, got.get(slot, []),
                               control.get(slot, [])):
                if n not in s["jamp"] or last[n] != i or \
                        not isinstance(p, torch.Tensor):
                    continue
                j = s["jamp"][n]
                what = (op.type, slot, n)
                assert NARROW.get(dtype_name(p), dtype_name(p)) == \
                    dtype_name(j), what
                if not p.dtype.is_floating_point or p.numel() == 0:
                    continue
                gap = rel(as_f64(p), as_f64(j))
                fp32_gap = rel(as_f64(c), as_f64(j))
                assert gap <= OP_RTOL, (what, gap, fp32_gap)
                checked += 1
                if fp32_gap >= OP_MATERIAL and op.attrs.get(
                        "fw_type", op.type) not in ROUNDS_INSIDE:
                    assert gap < 0.5 * fp32_gap, (what, gap, fp32_gap)
                    discriminated += 1
    assert discriminated >= 10 and checked >= 2 * discriminated, \
        (checked, discriminated)


@pytest.mark.parametrize("name", ZOO_AMP)
def test_amp_step_loss_and_grads_match_the_jax_amp_step(name, amp_steps):
    s = amp_steps[name]
    loss = s["fetch"][0]
    pl, jl, jl32 = (as_f64(s[k][loss]) for k in ("pamp", "jamp", "jf32"))
    assert abs(pl - jl) <= LOSS_RTOL * abs(jl), (pl, jl, jl32)
    gaps = {p: rel(as_f64(s["pamp"][g]), as_f64(s["jamp"][g]))
            for p, g in s["grads"].items()}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_GAP, (worst, gaps[worst])


# What the whole step's half rule leaves out, held by the op-by-op test
# instead: values that carry the rounding inside a JAX kernel of
# ROUNDS_INSIDE by about as much as AMP itself moves them.  In
# resnet_cifar10 those are the loss and the fc after the global average
# pool (its conv and batch-norm leaves sit far under half); in
# bert_pretrain every gradient leaf, since every encoder layer's gelu
# reaches every leaf, forward or backward.  Its loss, and all of the
# transformer's, hold.
ROUNDED_INSIDE = {"bert_pretrain": "grads",
                  "resnet_cifar10": {"loss", "fc_0.w_0_0", "fc_0.b_0_0"},
                  "transformer": set()}


@pytest.mark.parametrize("name", ZOO_AMP)
def test_amp_step_sits_under_half_the_jax_bf16_fp32_distance(name,
                                                            amp_steps):
    """The AMP loss and each gradient leaf whose JAX bf16-vs-fp32
    distance is material (LOSS_MATERIAL, GRAD_MATERIAL) sit under half
    that distance from the JAX package's AMP values, but what
    ROUNDED_INSIDE leaves out; the port's fp32 step is refused on every
    one of them."""
    s, left_out = amp_steps[name], ROUNDED_INSIDE[name]
    loss = s["fetch"][0]
    held = {}                          # "loss" or a parameter -> fetch
    if "loss" not in left_out:
        held["loss"] = loss
    if left_out != "grads":
        held.update((p, g) for p, g in s["grads"].items()
                    if p not in left_out)

    def gap(side, n):
        a, b = as_f64(s[side][n]), as_f64(s["jamp"][n])
        return abs(a - b) / abs(b) if n == loss else rel(a, b)

    material = {w: 0.5 * gap("jf32", n) for w, n in held.items()
                if gap("jf32", n) >= (LOSS_MATERIAL if n == loss
                                      else GRAD_MATERIAL)}
    assert material, held
    over = {w: (gap("pamp", held[w]), bar) for w, bar in material.items()
            if not gap("pamp", held[w]) < bar}
    assert not over, over
    planted = [w for w, bar in material.items()
               if gap("pf32", held[w]) < bar]
    assert not planted, planted



# ---------------------------------------------------------------------------
# the cast wrap, op class by op class, against the JAX package's
# ---------------------------------------------------------------------------

def f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def bf16(a):
    """An fp32 array rounded to bf16 (as fp32 values), and the two
    packages' bf16 arrays of it."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def wrap_cases():
    rng = np.random.RandomState(3)
    x, w = f32(rng, 4, 8), f32(rng, 8, 3)
    xb = bf16(f32(rng, 4, 3))
    wq = rng.randint(-127, 128, size=(8, 3)).astype(np.int8)
    quant = {"w": "w", "w_slot": "Y", "scale": "w@QSCALE", "cols": 3,
             "bits": 8, "dtype": "int8"}
    return [
        ("white", "mul", {"X": x, "Y": w}, {}),
        ("white annotated fp32", "mul", {"X": bf16(x), "Y": w},
         {"__amp__": "fp32"}),
        ("black", "softmax", {"X": xb}, {}),
        ("gray, a bf16 input", "elementwise_add",
         {"X": xb, "Y": f32(rng, 3)}, {}),
        ("gray, fp32 inputs", "relu", {"X": f32(rng, 4, 3)}, {}),
        ("gray annotated bf16", "relu", {"X": f32(rng, 4, 3)},
         {"__amp__": "bf16"}),
        ("exempt", "layer_norm", {"X": xb, "Scale": f32(rng, 3),
                                  "Bias": f32(rng, 3)},
         {"begin_norm_axis": 1}),
        ("quantized", "mul", {"X": x, "Y": wq, "Scale": np.abs(
            f32(rng, 3)) / 100}, {"__quant__": quant}),
        ("not differentiable", "sgd",
         {"Param": f32(rng, 4, 3), "Grad": xb,
          "LearningRate": np.array([0.1], np.float32)}, {}),
    ]


@pytest.mark.parametrize("case", wrap_cases(), ids=lambda c: c[0])
def test_cast_wrap_matches_the_jax_wrap(case, monkeypatch):
    _, op, ins, attrs = case

    def side(v, i):
        return [v[i] if isinstance(v, tuple) else
                (torch.from_numpy(v), jnp.asarray(v))[i]]

    monkeypatch.setattr(jax_registry.TRACE_CTX, "amp", True)
    want = jax_registry.get_kernel(op, attrs)(
        {s: side(v, 1) for s, v in ins.items()}, attrs)
    with port_registry.exec_context(port_registry.ExecContext(amp=True)):
        got = port_registry.get_kernel(op, attrs)(
            {s: side(v, 0) for s, v in ins.items()}, attrs)
    assert set(got) == set(want)
    for slot in want:
        p, j = got[slot][0], want[slot][0]
        assert dtype_name(p) == dtype_name(j), slot
        np.testing.assert_allclose(as_f64(p), as_f64(j), rtol=1e-2,
                                   atol=1e-2)


# ---------------------------------------------------------------------------
# the registered vjps under AMP: at the forward's precision
# ---------------------------------------------------------------------------

def grad_attrs(op, ins, attrs, out_slots, wrt):
    return {"fw_type": op, "fw_attrs": dict(attrs),
            "fw_in_slots": [(s, len(v)) for s, v in ins.items()],
            "fw_out_slots": [(s, 1) for s in out_slots],
            "needs_input_grad": [(s, 0) for s in wrt],
            "has_out_grad": [(out_slots[0], 0)]}


def vjp_cases():
    rng = np.random.RandomState(5)
    conv = {"strides": [2, 1], "paddings": [1, 1], "dilations": [1, 1],
            "groups": 1}
    bn_stats = {"Scale": f32(rng, 4), "Bias": f32(rng, 4),
                "Mean": f32(rng, 4), "Variance": np.abs(f32(rng, 4)) + 0.5}
    drop = {"dropout_prob": 0.1, "seed": 3,
            "dropout_implementation": "upscale_in_train"}
    return [
        ("conv2d, fp32 operands", "conv2d",
         {"Input": f32(rng, 2, 3, 7, 7), "Filter": f32(rng, 4, 3, 3, 3)},
         conv, ["Input", "Filter"], ["Output"]),
        ("conv2d, a bf16 input", "conv2d",
         {"Input": bf16(f32(rng, 2, 3, 7, 7)),
          "Filter": f32(rng, 4, 3, 3, 3)}, conv, ["Input", "Filter"],
         ["Output"]),
        ("depthwise_conv2d", "depthwise_conv2d",
         {"Input": bf16(f32(rng, 2, 3, 6, 6)),
          "Filter": f32(rng, 3, 1, 3, 3)},
         dict(conv, strides=[1, 1]), ["Input", "Filter"], ["Output"]),
        ("conv2d_transpose", "conv2d_transpose",
         {"Input": bf16(f32(rng, 2, 3, 4, 4)),
          "Filter": f32(rng, 3, 2, 3, 3)}, conv, ["Input", "Filter"],
         ["Output"]),
        ("batch_norm, a bf16 X", "batch_norm",
         dict({"X": bf16(f32(rng, 4, 4, 3, 3) * 2 + 1)}, **bn_stats),
         {"momentum": 0.9, "epsilon": 1e-5}, ["X", "Scale", "Bias"],
         ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"]),
        ("dropout, a bf16 X", "dropout", {"X": bf16(f32(rng, 4, 6, 8))},
         drop, ["X"], ["Out"]),
        ("dropout annotated bf16", "dropout", {"X": f32(rng, 4, 6, 8)},
         dict(drop, __amp__="bf16"), ["X"], ["Out"]),
    ]


@pytest.mark.parametrize("case", vjp_cases(), ids=lambda c: c[0])
def test_vjp_under_amp_is_the_wrapped_recompute(case, monkeypatch):
    """The op's registered vjp answers (not None) under AMP and gives the
    autograd recompute through the cast wrap: each grad in its input's
    dtype, its values within bf16 rounding; and (but dropout, whose bits
    differ by design) the JAX package's generic_grad under AMP.  The
    dropout vjp is K10's arm, which the op takes on a CUDA tensor: here
    its plain version stands in on the CPU."""
    _, op, ins, attrs, wrt, outs = case
    monkeypatch.setattr(
        port_nn_ops, "_fused_dropout",
        lambda x, attrs: 0.0 < attrs.get("dropout_prob", 0.5) < 1.0)
    pins = {s: [v[0] if isinstance(v, tuple) else torch.from_numpy(v)]
            for s, v in ins.items()}
    gattrs = grad_attrs(op, pins, attrs, outs, wrt)
    rng = np.random.RandomState(6)
    ctx = port_registry.ExecContext(amp=True, masks={}, seed=5)
    with torch.no_grad(), port_registry.exec_context(ctx):
        fw = port_registry.run_op(op, pins, attrs)
        y = fw[outs[0]][0]
        cot = torch.from_numpy(f32(rng, *y.shape)).to(y.dtype)
        gins = dict(pins, **{f"{outs[0]}@GRAD_OUT": [cot]})
        gins.update({f"{s}@FW_OUT": fw[s] for s in outs[1:]})
        vjp = port_registry._VJPS.pop(op)
        try:
            assert vjp(gins, gattrs) is not None
            recomputed = port_registry.run_op("generic_grad", gins, gattrs)
        finally:
            port_registry._VJPS[op] = vjp
        got = port_registry.run_op("generic_grad", gins, gattrs)
    assert set(got) == set(recomputed) == {f"{s}@GRAD" for s in wrt}
    for s in wrt:
        p, r = got[f"{s}@GRAD"][0], recomputed[f"{s}@GRAD"][0]
        assert p.dtype == r.dtype == pins[s][0].dtype, s
        np.testing.assert_allclose(as_f64(p), as_f64(r), rtol=1e-2,
                                   atol=1e-2 * float(r.abs().max()))
    if op == "dropout":
        return
    monkeypatch.setattr(jax_registry.TRACE_CTX, "amp", True)
    jins = {s: [v[1] if isinstance(v, tuple) else jnp.asarray(v)]
            for s, v in ins.items()}
    jins[f"{outs[0]}@GRAD_OUT"] = [
        jnp.asarray(cot.float().numpy()).astype(
            jnp.bfloat16 if cot.dtype == torch.bfloat16 else jnp.float32)]
    want = jax_registry.run_op("generic_grad", jins, gattrs)
    for s in wrt:
        p, j = got[f"{s}@GRAD"][0], want[f"{s}@GRAD"][0]
        assert dtype_name(p) == dtype_name(j), s
        np.testing.assert_allclose(as_f64(p), as_f64(j), rtol=1e-2,
                                   atol=1e-2 * float(np.abs(as_f64(j)).max()))


# ---------------------------------------------------------------------------
# tests/test_amp.py's and test_predictor.py's flows on the port
# ---------------------------------------------------------------------------

def mlp(fluid):
    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=x, size=32, act="relu")
    pred = fluid.layers.fc(input=h, size=4, act="softmax")
    return fluid.layers.mean(fluid.layers.cross_entropy(input=pred, label=y))


def mlp_data(rng, n=64):
    x = rng.randn(n, 16).astype(np.float32)
    return {"x": x, "y": x[:, :4].argmax(1).reshape(-1, 1).astype(np.int64)}


def test_amp_converges_and_keeps_fp32_master_weights():
    main, startup, scope = pfluid.Program(), pfluid.Program(), pfluid.Scope()
    with port_unique_name.guard(), pfluid.program_guard(main, startup):
        loss = mlp(pfluid)
        pfluid.optimizer.Momentum(learning_rate=0.1,
                                  momentum=0.9).minimize(loss)
    pfluid.contrib.mixed_precision.enable(main)
    exe = pfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    losses = [float(exe.run(main, feed=mlp_data(rng), fetch_list=[loss],
                            scope=scope)[0]) for _ in range(40)]
    assert losses[-1] < losses[0] * 0.6, (losses[0], losses[-1])
    for p in main.all_parameters():
        assert scope.find_var(p.name).dtype == torch.float32, p.name


def test_amp_matches_fp32_loss_closely():
    """One forward step: the bf16 loss within bf16 tolerance of fp32."""
    feed = mlp_data(np.random.RandomState(1))
    main, startup, scope = pfluid.Program(), pfluid.Program(), pfluid.Scope()
    with port_unique_name.guard(), pfluid.program_guard(main, startup):
        loss = mlp(pfluid)
    exe = pfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    (fp32,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    pfluid.contrib.mixed_precision.enable(main)
    (amp,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    np.testing.assert_allclose(fp32, amp, rtol=2e-2)
    assert fp32 != amp
    pfluid.contrib.mixed_precision.disable(main)
    (again,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert again == fp32


def test_float16_transpiler_shim():
    prog = pfluid.Program()
    version = prog._version
    pfluid.contrib.mixed_precision.Float16Transpiler().transpile(prog)
    assert prog._amp and prog._version == version + 1


def save_mlp(d):
    """The JAX package's test_predictor model, saved by the JAX package:
    its input and fp32 answer."""
    main, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = main.random_seed = 7
    with jax_unique_name.guard(), jfluid.program_guard(main, startup):
        img = jfluid.layers.data(name="img", shape=[8], dtype="float32")
        h = jfluid.layers.fc(img, size=16, act="relu")
        pred = jfluid.layers.fc(h, size=4, act="softmax")
        exe, scope = jfluid.Executor(), jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe.run(startup)
            jfluid.io.save_inference_model(d, ["img"], [pred], exe,
                                           main_program=main)
            x = np.random.default_rng(0).normal(size=(3, 8)).astype(
                np.float32)
            (want,) = exe.run(main, feed={"img": x}, fetch_list=[pred])
    return x, np.asarray(want)


def test_predictor_bf16_config(tmp_path):
    """AnalysisConfig.enable_bf16: the loaded program runs under the bf16
    policy, within the JAX test's bar of fp32, and within the same bar of
    the JAX package's bf16 Predictor."""
    d = str(tmp_path)
    x, want = save_mlp(d)
    cfg = pfluid.AnalysisConfig(d)
    cfg.disable_gpu()
    cfg.enable_bf16()
    pred = pfluid.create_paddle_predictor(cfg)
    assert pred._program._amp
    assert {op.attrs.get("__amp__") for op in
            pred._program.global_block().ops} >= {"bf16", "fp32"}
    (got,) = pred.run({"img": x})
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.02)
    jcfg = jfluid.AnalysisConfig(d)
    jcfg.enable_bf16()
    (jax_bf16,) = jfluid.create_paddle_predictor(jcfg).run({"img": x})
    np.testing.assert_allclose(got, jax_bf16, rtol=0.05, atol=0.02)
    fp32_cfg = pfluid.AnalysisConfig(d)
    fp32_cfg.disable_gpu()
    (fp32,) = pfluid.create_paddle_predictor(fp32_cfg).run({"img": x})
    np.testing.assert_allclose(fp32, want, rtol=1e-5)
    assert not np.array_equal(got, fp32)


# ---------------------------------------------------------------------------
# the Executor's seams
# ---------------------------------------------------------------------------

def shrinkable(fluid, names):
    """x·2 + x·2: CSE takes out one of the two equal scale ops."""
    main, startup = fluid.Program(), fluid.Program()
    with names.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        out = fluid.layers.elementwise_add(fluid.layers.scale(x, scale=2.0),
                                           fluid.layers.scale(x, scale=2.0))
    return main, out


def pipeline_records(program):
    (_, report), = program._pass_memo.values()
    return [(r.name, r.changed, r.op_delta, r.var_delta)
            for r in report.records]


def test_executor_runs_the_pass_pipeline_as_the_jax_executor():
    feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
    jmain, jout = shrinkable(jfluid, jax_unique_name)
    pmain, pout = shrinkable(pfluid, port_unique_name)
    with jfluid.scope_guard(jfluid.Scope()):
        (want,) = jfluid.Executor().run(jmain, feed=feed, fetch_list=[jout])
    (got,) = pfluid.Executor(CPU).run(pmain, feed=feed, fetch_list=[pout],
                                      scope=pfluid.Scope())
    np.testing.assert_array_equal(got, want)
    records = pipeline_records(pmain)
    assert records == pipeline_records(jmain)
    assert records[:2] == [("cse", True, -1, 0), ("dce", True, 0, -1)]
    assert pmain._validate_memo


def test_pass_pipeline_off_is_the_identity(monkeypatch):
    feed = {"x": np.ones((2, 3), np.float32)}
    main, out = shrinkable(pfluid, port_unique_name)
    monkeypatch.setitem(port_flags._overrides, "pass_pipeline", "off")
    assert PortExecutor._at_seams(main, ["x"], [out.name]) is main
    (got,) = pfluid.Executor(CPU).run(main, feed=feed, fetch_list=[out],
                                      scope=pfluid.Scope())
    assert not getattr(main, "_pass_memo", None)
    np.testing.assert_array_equal(got, 4 * feed["x"])


def test_programs_with_host_ops_skip_the_pass_pipeline():
    main, out = shrinkable(pfluid, port_unique_name)
    main.global_block().append_op(type="send", inputs={"X": [out.name]},
                                  outputs={}, attrs={})
    assert PortExecutor._at_seams(main, ["x"], [out.name]) is main


@pytest.mark.parametrize("name", ZOO_AMP)
def test_fp32_zoo_losses_unchanged_by_the_pipeline(name, monkeypatch):
    zp = build_zoo(name, "port")
    state = port_zoo.snapshot_startup(zp, place=CPU)
    with_pipeline = port_zoo.run_steps(zp, 2, init_state=state, place=CPU)
    monkeypatch.setitem(port_flags._overrides, "pass_pipeline", "off")
    without = port_zoo.run_steps(zp, 2, init_state=state, place=CPU)
    assert with_pipeline == without
