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
    x = torch.ones(2, 3)
    with pytest.raises(NotImplementedError, match="training slice"):
        port_registry.run_op("dropout", {"X": [x]}, {"dropout_prob": 0.5})
    with pytest.raises(NotImplementedError, match="training slice"):
        port_registry.run_op(
            "fused_attention",
            {"Q": [torch.ones(1, 1, 4, 8)], "K": [torch.ones(1, 1, 4, 8)],
             "V": [torch.ones(1, 1, 4, 8)]}, {"dropout_prob": 0.1})
    with pytest.raises(NotImplementedError, match="training slice"):
        port_registry.run_op("mul_grad", {}, {})
