"""Port parity, op by op: each kernel of paddle_tpu_torch on the BERT
serving path against paddle_tpu.ops.registry.run_op on the same numpy
inputs.  Tolerance: atol 1e-5, rtol 1e-5 (float32 on both sides; the two
frameworks sum and take transcendentals in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import flags as jax_flags
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch.ops import registry as port_registry

ATOL = RTOL = 1e-5
rng = np.random.RandomState(7)


def f32(*shape):
    return rng.standard_normal(shape).astype(np.float32)


ids = rng.randint(0, 10, (3, 5)).astype(np.int64)
ids[0, :2] = 4                                   # padding_idx rows
CASES = [
    ("elementwise_add", {"X": [f32(2, 3, 4)], "Y": [f32(3)]}, {"axis": 1}),
    ("elementwise_add", {"X": [f32(2, 3, 4)], "Y": [f32(4)]}, {"axis": -1}),
    ("elementwise_sub", {"X": [f32(2, 3)], "Y": [f32(2, 3)]}, {}),
    ("elementwise_mul", {"X": [f32(2, 3, 4)], "Y": [f32(2, 3)]}, {"axis": 0}),
    ("elementwise_div", {"X": [f32(2, 3)], "Y": [f32(2, 3) + 5.0]}, {}),
    ("scale", {"X": [f32(2, 3)]}, {"scale": 2.5, "bias": 0.5}),
    ("scale", {"X": [f32(2, 3)]},
     {"scale": 2.5, "bias": 0.5, "bias_after_scale": False}),
    ("mul", {"X": [f32(2, 5, 6)], "Y": [f32(6, 4)]},
     {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    ("matmul", {"X": [f32(2, 3, 4)], "Y": [f32(2, 5, 4)]},
     {"transpose_Y": True, "alpha": 0.5}),
    ("relu", {"X": [f32(3, 4)]}, {}),
    ("tanh", {"X": [f32(3, 4)]}, {}),
    ("gelu", {"X": [f32(3, 4) * 3]}, {}),
    ("mean", {"X": [f32(3, 4)]}, {}),
    ("reduce_sum", {"X": [f32(3, 4, 5)]}, {"dim": [1], "keep_dim": True}),
    ("reduce_sum", {"X": [f32(3, 4)]}, {"reduce_all": True}),
    ("softmax", {"X": [f32(3, 7)]}, {"axis": -1}),
    ("layer_norm", {"X": [f32(2, 3, 8)], "Scale": [f32(8)],
                    "Bias": [f32(8)]}, {"begin_norm_axis": 2,
                                        "epsilon": 1e-5}),
    ("layer_norm", {"X": [f32(4, 6) * 10 + 3]}, {"begin_norm_axis": 1}),
    ("lookup_table", {"W": [f32(10, 6)], "Ids": [ids]},
     {"padding_idx": 4}),
    ("lookup_table", {"W": [f32(10, 6)], "Ids": [ids[..., None]]},
     {"padding_idx": -1}),
    ("dropout", {"X": [f32(3, 4)]},
     {"dropout_prob": 0.3, "is_test": True,
      "dropout_implementation": "downgrade_in_infer"}),
    ("dropout", {"X": [f32(3, 4)]},
     {"dropout_prob": 0.3, "is_test": True,
      "dropout_implementation": "upscale_in_train"}),
    ("reshape", {"X": [f32(2, 6, 4)]}, {"shape": [0, -1, 2, 4]}),
    ("reshape2", {"X": [f32(2, 6, 4)]}, {"shape": [0, 3, 8]}),
    ("transpose", {"X": [f32(2, 3, 4, 5)]}, {"axis": [0, 2, 1, 3]}),
    ("transpose2", {"X": [f32(2, 3, 4)]}, {"axis": [2, 0, 1]}),
    ("slice", {"Input": [f32(3, 5, 4)]},
     {"axes": [1], "starts": [0], "ends": [1]}),
    ("slice", {"Input": [f32(3, 5, 4)]},
     {"axes": [0, 1], "starts": [-1, 1], "ends": [10, -1],
      "decrease_axis": [0]}),
    ("gather", {"X": [f32(6, 3)], "Index": [np.array([5, 0, 2, 2])]}, {}),
    ("cast", {"X": [f32(3, 4) * 10]}, {"out_dtype": "int32"}),
    ("fill_constant", {}, {"shape": [2, 3], "dtype": "float32",
                           "value": 1.5}),
    ("assign_value", {}, {"shape": [2, 2], "dtype": "float32",
                          "values": [1.0, 2.0, 3.0, 4.0]}),
    ("fused_attention", {"Q": [f32(2, 2, 8, 16)], "K": [f32(2, 2, 8, 16)],
                         "V": [f32(2, 2, 8, 16)],
                         "Bias": [np.where(rng.rand(2, 1, 1, 8) < 0.3,
                                           -1e4, 0.0).astype(np.float32)]},
     {"causal": False, "scale": 0.0, "dropout_prob": 0.1, "is_test": True}),
    ("fused_attention", {"Q": [f32(1, 2, 8, 16)], "K": [f32(1, 2, 8, 16)],
                         "V": [f32(1, 2, 8, 16)]},
     {"causal": True, "scale": 0.3}),
]


@pytest.mark.parametrize("op_type,ins,attrs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_port_op_matches_jax(op_type, ins, attrs, monkeypatch):
    # the JAX side's attention runs its plain composed form, not the
    # measured kernel selection (which would time candidates on the CPU)
    monkeypatch.setitem(jax_flags._overrides, "force_attention_impl",
                        "composed")
    want = jax_registry.run_op(
        op_type, {s: [jnp.asarray(v) for v in vs] for s, vs in ins.items()},
        dict(attrs))
    got = port_registry.run_op(
        op_type, {s: [torch.from_numpy(np.array(v)) for v in vs]
                  for s, vs in ins.items()}, dict(attrs))
    assert set(want) <= set(got)
    for slot, wv in want.items():
        for w, g in zip(wv, got[slot]):
            w = np.asarray(w)
            g = g.detach().numpy()
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            if slot == "XShape":
                continue
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{op_type}:{slot}")


RANDOM_CASES = [
    ("uniform_random", {"min": -0.5, "max": 2.0}),
    ("gaussian_random", {"mean": 1.0, "std": 2.0}),
    ("truncated_gaussian_random", {"mean": -1.0, "std": 0.5}),
]


@pytest.mark.parametrize("op_type,attrs", RANDOM_CASES,
                         ids=[c[0] for c in RANDOM_CASES])
def test_port_random_op_distribution(op_type, attrs):
    """Random draws differ from the JAX package's by design (different
    generators), so the two are compared by shape, dtype, support and
    moments over 20000 draws: |mean difference| < 0.05 * spread, |std
    ratio - 1| < 0.05.  The port's draw is deterministic in (op seed,
    step)."""
    attrs = dict(attrs, shape=[200, 100], dtype="float32", seed=11)
    want = np.asarray(jax_registry.run_op(op_type, {}, attrs)["Out"][0])

    def draw(step):
        ctx = port_registry.ExecContext(step=step)
        with port_registry.exec_context(ctx):
            return port_registry.run_op(op_type, {}, attrs)["Out"][0].numpy()

    got = draw(0)
    assert got.shape == want.shape and got.dtype == want.dtype
    spread = want.std()
    assert abs(got.mean() - want.mean()) < 0.05 * spread
    assert abs(got.std() / spread - 1.0) < 0.05
    if op_type == "uniform_random":
        assert got.min() >= attrs["min"] and got.max() < attrs["max"]
    if op_type == "truncated_gaussian_random":
        lo = attrs["mean"] - 2 * attrs["std"]
        hi = attrs["mean"] + 2 * attrs["std"]
        assert got.min() >= lo - 1e-6 and got.max() <= hi + 1e-6
    np.testing.assert_array_equal(draw(0), got)
    assert not np.array_equal(draw(1), got)


def test_port_train_mode_dropout_and_grad_ops_raise():
    """What still raises now that the port trains: a grad op with neither
    a custom kernel nor the generic form (append_backward never emits
    one).  The sparse table grad, which raised until the port had
    SelectedRows, now gives the JAX package's rows and values."""
    with pytest.raises(NotImplementedError, match="No kernel registered"):
        port_registry.run_op("mul_grad", {}, {})
    rng = np.random.RandomState(7)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    ids = np.array([[4], [1], [4], [2]], np.int64)
    og = rng.standard_normal((4, 3)).astype(np.float32)
    attrs = {"fw_attrs": {"is_sparse": True, "padding_idx": 2}}
    got = port_registry.run_op(
        "lookup_table_grad", {"W": [torch.from_numpy(w)],
                              "Ids": [torch.from_numpy(ids)],
                              "Out@GRAD_OUT": [torch.from_numpy(og)]},
        attrs)["W@GRAD"][0]
    want = jax_registry.run_op(
        "lookup_table_grad", {"W": [jnp.asarray(w)], "Ids": [jnp.asarray(ids)],
                              "Out@GRAD_OUT": [jnp.asarray(og)]},
        attrs)["W@GRAD"][0]
    assert got.height == want.height == 6
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))


# ---------------------------------------------------------------------------
# The training slice: grad ops (the generic recompute-and-autograd kernel
# and the four custom grads) and the update ops, port against the JAX
# package's run_op on the same inputs, atol/rtol 1e-5 (float32).
# ---------------------------------------------------------------------------

def grad_op(fw_type, fw_ins, fw_attrs, out_slots, needs, ograds):
    """ins/attrs of the grad op append_backward emits for one forward op:
    the forward inputs plus ``<slot>@GRAD_OUT`` out-grads."""
    attrs = {"fw_type": fw_type, "fw_attrs": fw_attrs,
             "fw_in_slots": [(s, len(v)) for s, v in fw_ins.items()],
             "fw_out_slots": out_slots, "needs_input_grad": needs,
             "has_out_grad": [(slot, 0) for slot in ograds]}
    ins = dict(fw_ins)
    ins.update({f"{slot}@GRAD_OUT": [g] for slot, g in ograds.items()})
    return ins, attrs


labels = rng.randint(0, 7, (4, 1)).astype(np.int64)
labels[2, 0] = -100                              # ignore_index row
GRAD_CASES = [
    ("generic_grad",) + grad_op(
        "mul", {"X": [f32(2, 5, 6)], "Y": [f32(6, 4)]},
        {"x_num_col_dims": 2, "y_num_col_dims": 1}, [("Out", 1)],
        [("X", 0), ("Y", 0)], {"Out": f32(2, 5, 4)}),
    ("generic_grad",) + grad_op(
        "matmul", {"X": [f32(2, 3, 4)], "Y": [f32(2, 5, 4)]},
        {"transpose_Y": True, "alpha": 0.5}, [("Out", 1)],
        [("X", 0), ("Y", 0)], {"Out": f32(2, 3, 5)}),
    ("generic_grad",) + grad_op(
        "gelu", {"X": [f32(3, 4) * 3]}, {}, [("Out", 1)], [("X", 0)],
        {"Out": f32(3, 4)}),
    ("generic_grad",) + grad_op(
        "softmax", {"X": [f32(3, 7)]}, {"axis": -1}, [("Out", 1)],
        [("X", 0)], {"Out": f32(3, 7)}),
    ("generic_grad",) + grad_op(
        "reshape2", {"X": [f32(2, 6, 4)]}, {"shape": [0, 3, 8]},
        [("Out", 1), ("XShape", 1)], [("X", 0)], {"Out": f32(2, 3, 8)}),
    ("generic_grad",) + grad_op(
        "transpose2", {"X": [f32(2, 3, 4)]}, {"axis": [2, 0, 1]},
        [("Out", 1), ("XShape", 1)], [("X", 0)], {"Out": f32(4, 2, 3)}),
    ("generic_grad",) + grad_op(
        "gather", {"X": [f32(6, 3)], "Index": [np.array([5, 0, 2, 2])]},
        {}, [("Out", 1)], [("X", 0)], {"Out": f32(4, 3)}),
    ("generic_grad",) + grad_op(
        "slice", {"Input": [f32(3, 5, 4)]},
        {"axes": [0, 1], "starts": [-1, 1], "ends": [10, -1],
         "decrease_axis": [0]}, [("Out", 1)], [("Input", 0)],
        {"Out": f32(3, 4)}),
    ("generic_grad",) + grad_op(
        "fused_attention",
        {"Q": [f32(2, 2, 8, 16)], "K": [f32(2, 2, 8, 16)],
         "V": [f32(2, 2, 8, 16)],
         "Bias": [np.where(rng.rand(2, 1, 1, 8) < 0.3, -1e4,
                           0.0).astype(np.float32)]},
        {"causal": False, "scale": 0.0, "dropout_prob": 0.0,
         "is_test": False}, [("Out", 1)], [("Q", 0), ("K", 0), ("V", 0)],
        {"Out": f32(2, 2, 8, 16)}),
    ("elementwise_add_grad",) + grad_op(
        "elementwise_add", {"X": [f32(2, 3, 4)], "Y": [f32(3)]},
        {"axis": 1}, [("Out", 1)], [("X", 0), ("Y", 0)],
        {"Out": f32(2, 3, 4)}),
    ("elementwise_add_grad",) + grad_op(
        "elementwise_add", {"X": [f32(2, 3, 4)], "Y": [f32(2, 1, 4)]},
        {"axis": -1}, [("Out", 1)], [("Y", 0)], {"Out": f32(2, 3, 4)}),
    ("layer_norm_grad",) + grad_op(
        "layer_norm", {"X": [f32(2, 3, 8)], "Scale": [f32(8)],
                       "Bias": [f32(8)]},
        {"begin_norm_axis": 2, "epsilon": 1e-5},
        [("Y", 1), ("Mean", 1), ("Variance", 1)],
        [("X", 0), ("Scale", 0), ("Bias", 0)], {"Y": f32(2, 3, 8)}),
    ("softmax_with_cross_entropy_grad",) + grad_op(
        "softmax_with_cross_entropy",
        {"Logits": [f32(4, 7)], "Label": [labels]}, {},
        [("Softmax", 1), ("Loss", 1)], [("Logits", 0)],
        {"Loss": f32(4, 1)}),
    ("lookup_table_grad",) + grad_op(
        "lookup_table", {"W": [f32(10, 6)], "Ids": [ids]},
        {"padding_idx": 4}, [("Out", 1)], [("W", 0)],
        {"Out": f32(3, 5, 6)}),
]


def _both(op_type, ins, attrs):
    want = jax_registry.run_op(
        op_type, {s: [jnp.asarray(v) for v in vs] for s, vs in ins.items()},
        dict(attrs))
    got = port_registry.run_op(
        op_type, {s: [torch.from_numpy(np.array(v)) for v in vs]
                  for s, vs in ins.items()}, dict(attrs))
    return want, got


def _assert_same(want, got, what):
    assert set(want) == set(got), (what, sorted(want), sorted(got))
    for slot, wv in want.items():
        assert len(wv) == len(got[slot])
        for w, g in zip(wv, got[slot]):
            w, g = np.asarray(w), g.detach().numpy()
            assert g.shape == w.shape, (what, slot, g.shape, w.shape)
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{what}:{slot}")


@pytest.mark.parametrize(
    "op_type,ins,attrs", GRAD_CASES,
    ids=[f"{c[0]}-{c[2]['fw_type']}-{i}" for i, c in enumerate(GRAD_CASES)])
def test_port_grad_op_matches_jax(op_type, ins, attrs, monkeypatch):
    monkeypatch.setitem(jax_flags._overrides, "force_attention_impl",
                        "composed")
    want, got = _both(op_type, ins, attrs)
    _assert_same(want, got, f"{op_type}({attrs['fw_type']})")


def test_port_grad_registry_matches_jax():
    """append_backward reads both sets, so they shape the program: for
    every op the port registers, the same custom grad and the same
    not_differentiable mark as the JAX package."""
    ported = sorted(port_registry._KERNELS)
    assert "adam" in ported and "sum" in ported
    for op in ported:
        assert port_registry.is_differentiable(op) == \
            jax_registry.is_differentiable(op), op
        assert (port_registry.get_custom_grad(op) is None) == \
            (jax_registry.get_custom_grad(op) is None), op


STATE = {"ParamOut": "Param", "VelocityOut": "Velocity",
         "Moment1Out": "Moment1", "Moment2Out": "Moment2",
         "Beta1PowOut": "Beta1Pow", "Beta2PowOut": "Beta2Pow"}
UPDATE_CASES = [
    ("sgd", {"Param": [f32(4, 3)], "LearningRate": [np.full(1, 0.1,
                                                            np.float32)]},
     {}),
    ("momentum", {"Param": [f32(4, 3)], "Velocity": [f32(4, 3)],
                  "LearningRate": [np.full(1, 0.1, np.float32)]},
     {"mu": 0.9, "use_nesterov": False}),
    ("momentum", {"Param": [f32(4, 3)], "Velocity": [f32(4, 3)],
                  "LearningRate": [np.full(1, 0.1, np.float32)]},
     {"mu": 0.8, "use_nesterov": True}),
    ("adam", {"Param": [f32(4, 3)], "Moment1": [np.zeros((4, 3),
                                                         np.float32)],
              "Moment2": [np.zeros((4, 3), np.float32)],
              "Beta1Pow": [np.ones(1, np.float32)],
              "Beta2Pow": [np.ones(1, np.float32)],
              "LearningRate": [np.full(1, 1e-2, np.float32)]},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
]


@pytest.mark.parametrize("op_type,state,attrs", UPDATE_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(UPDATE_CASES)])
def test_port_update_op_matches_jax_over_two_steps(op_type, state, attrs):
    """Each package feeds its own outputs back as the next step's state,
    as the Executor's write-back does."""
    jstate = {s: [jnp.asarray(v) for v in vs] for s, vs in state.items()}
    pstate = {s: [torch.from_numpy(v) for v in vs]
              for s, vs in state.items()}
    for step in range(2):
        grad = f32(4, 3)
        want = jax_registry.run_op(
            op_type, dict(jstate, Grad=[jnp.asarray(grad)]), dict(attrs))
        got = port_registry.run_op(
            op_type, dict(pstate, Grad=[torch.from_numpy(grad)]),
            dict(attrs))
        _assert_same(want, got, f"{op_type} step {step}")
        jstate.update({STATE[s]: v for s, v in want.items()})
        pstate.update({STATE[s]: v for s, v in got.items()})
    assert port_registry.get_custom_grad(op_type) is None
    assert not port_registry.is_differentiable(op_type)


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_port_train_mode_dropout(impl):
    """Training-mode dropout, statistically: over 20000 draws at p=0.3 the
    keep rate is within 0.016 of 0.7 (five standard deviations); Mask
    times the implementation's scale is Out/X; the generic grad's
    recompute draws the same mask, so X@GRAD = Mask·scale·og; the next
    step draws another mask."""
    p = 0.3
    scale = 1.0 / (1.0 - p) if impl == "upscale_in_train" else 1.0
    x = torch.from_numpy(f32(200, 100)) + 5.0
    og = torch.from_numpy(f32(200, 100))
    attrs = {"dropout_prob": p, "seed": 3, "dropout_implementation": impl}

    def run(step, op_type="dropout", ins=None, a=None):
        ctx = port_registry.ExecContext(seed=11, step=step)
        with port_registry.exec_context(ctx):
            return port_registry.run_op(op_type, ins or {"X": [x]},
                                        a or attrs)

    res = run(0)
    out, mask = res["Out"][0], res["Mask"][0]
    assert set(mask.unique().tolist()) <= {0.0, 1.0}
    assert abs(mask.mean().item() - (1.0 - p)) < 0.016
    torch.testing.assert_close(mask * scale, out / x, atol=1e-6, rtol=1e-6)
    ins, gattrs = grad_op("dropout", {"X": [x]}, attrs,
                          [("Out", 1), ("Mask", 1)], [("X", 0)], {"Out": og})
    dx = run(0, "generic_grad", ins, gattrs)["X@GRAD"][0]
    torch.testing.assert_close(dx, mask * scale * og, atol=1e-6, rtol=1e-6)
    assert torch.equal(run(0)["Mask"][0], mask)
    assert not torch.equal(run(1)["Mask"][0], mask)


def test_port_train_mode_fused_attention_dropout():
    """fused_attention in training mode with dropout_prob runs the flash
    attention with the op's Philox seed (the plain version on CPU
    tensors), and its grad recomputes the same mask."""
    from paddle_tpu_torch.ops import attention_kernels as ak

    q, k, v = (torch.from_numpy(f32(1, 2, 8, 16)) for _ in range(3))
    attrs = {"dropout_prob": 0.25, "seed": 5, "causal": False,
             "scale": 0.0}
    ctx = port_registry.ExecContext(seed=2, step=4)
    with port_registry.exec_context(ctx):
        out = port_registry.run_op("fused_attention",
                                   {"Q": [q], "K": [k], "V": [v]},
                                   attrs)["Out"][0]
        seed = port_registry.op_seed(attrs)
    want = ak.flash_attention_reference(q, k, v, dropout_p=0.25, seed=seed)
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    assert not torch.allclose(out, ak.flash_attention_reference(q, k, v))
