"""The dense image slice's ops, port against the JAX package: conv2d and
its depthwise and transposed forms, pool2d, adaptive pooling,
batch_norm, top_k, arg_max/arg_min and accuracy.  The same seeded numpy
inputs go through ``paddle_tpu.ops.registry`` and the port's registry,
forward and grads: the JAX package's ``generic_grad`` (``jax.vjp`` of its
op) against the port's (the op's registered vjp where it has one, the
autograd recompute otherwise).  Tolerance: atol 1e-5, rtol 1e-5 (float32
on both sides; the frameworks sum in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch.ops import registry as port_registry

ATOL = RTOL = 1e-5


def f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def run_both(op, ins, attrs):
    """Forward outputs of `op` in both packages: {slot: [(jax, port)]}."""
    jout = jax_registry.run_op(
        op, {s: [jnp.asarray(v) for v in vs] for s, vs in ins.items()},
        dict(attrs))
    pout = port_registry.run_op(
        op, {s: [torch.from_numpy(v) for v in vs] for s, vs in ins.items()},
        dict(attrs))
    assert set(pout) == set(jout), (sorted(pout), sorted(jout))
    return {s: list(zip(jout[s], pout[s])) for s in jout}


def assert_close(j, p, what):
    j = np.asarray(j)
    p = p.detach().numpy()
    assert p.shape == j.shape, (what, p.shape, j.shape)
    np.testing.assert_allclose(p, j.astype(p.dtype), atol=ATOL, rtol=RTOL,
                               err_msg=what)


def grad_attrs(op, ins, attrs, outs, wrt, fw_outs):
    return {"fw_type": op, "fw_attrs": dict(attrs),
            "fw_in_slots": [(s, len(v)) for s, v in ins.items()],
            "fw_out_slots": [(s, len(v)) for s, v in outs.items()],
            "needs_input_grad": [(s, 0) for s in wrt],
            "has_out_grad": [(s, 0) for s in fw_outs]}


def check_grads(op, ins, attrs, wrt, rng, fw_outs=None, saved=()):
    """The port's generic_grad against the JAX package's on one random
    cotangent per differentiated output; `saved` are forward outputs
    handed to the grad op as ``<slot>@FW_OUT`` (what the Executor
    binds)."""
    outs = run_both(op, ins, attrs)
    fw_outs = fw_outs or [s for s in outs if s in ("Out", "Output", "Y")]
    cots = {s: f32(rng, *np.shape(outs[s][0][0])) for s in fw_outs}
    gattrs = grad_attrs(op, ins, attrs, outs, wrt, fw_outs)
    jins = {s: [jnp.asarray(v) for v in vs] for s, vs in ins.items()}
    pins = {s: [torch.from_numpy(v) for v in vs] for s, vs in ins.items()}
    for s in fw_outs:
        jins[f"{s}@GRAD_OUT"] = [jnp.asarray(cots[s])]
        pins[f"{s}@GRAD_OUT"] = [torch.from_numpy(cots[s])]
    for s in saved:
        pins[f"{s}@FW_OUT"] = [outs[s][0][1]]
    jg = jax_registry.run_op("generic_grad", jins, gattrs)
    pg = port_registry.run_op("generic_grad", pins, gattrs)
    for s in wrt:
        assert_close(jg[f"{s}@GRAD"][0], pg[f"{s}@GRAD"][0], f"d{s}")
    return pins, gattrs, pg


def assert_vjp_is_the_recompute(op, pins, gattrs, pg):
    """The op's registered vjp answers (not None) and gives what the
    autograd recompute of its forward gives."""
    vjp = port_registry._VJPS.pop(op)
    try:
        assert vjp(pins, gattrs) is not None
        recomputed = port_registry.run_op("generic_grad", pins, gattrs)
    finally:
        port_registry._VJPS[op] = vjp
    assert set(recomputed) == set(pg)
    for s in pg:
        torch.testing.assert_close(pg[s][0], recomputed[s][0], atol=ATOL,
                                   rtol=RTOL)


def check_forward(op, ins, attrs):
    for slot, pairs in run_both(op, ins, attrs).items():
        for j, p in pairs:
            assert_close(j, p, slot)


CONVS = [
    ("conv2d", (2, 4, 9, 11), (6, 2, 3, 3),
     {"strides": [2, 1], "paddings": [1, 2], "dilations": [1, 2],
      "groups": 2}),
    ("conv2d", (2, 3, 8, 8), (5, 3, 5, 5),
     {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
      "groups": 1}),
    ("depthwise_conv2d", (2, 4, 7, 7), (4, 1, 3, 3),
     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]}),
    ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 3),
     {"strides": [2, 1], "paddings": [1, 0], "dilations": [1, 2],
      "groups": 1}),
    ("conv2d_transpose", (2, 4, 5, 5), (4, 2, 4, 4),
     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
      "groups": 2}),
    ("depthwise_conv2d_transpose", (2, 3, 5, 5), (3, 1, 3, 3),
     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]}),
]


@pytest.mark.parametrize("op,xs,ws,attrs", CONVS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CONVS)])
def test_convolution_forward_and_grads(op, xs, ws, attrs):
    rng = np.random.RandomState(1)
    ins = {"Input": [f32(rng, *xs)], "Filter": [f32(rng, *ws)]}
    check_forward(op, ins, attrs)
    pins, gattrs, pg = check_grads(op, ins, attrs, ["Input", "Filter"], rng)
    assert_vjp_is_the_recompute(op, pins, gattrs, pg)


def test_conv_vjp_returns_only_the_grads_asked_for():
    rng = np.random.RandomState(2)
    ins = {"Input": [f32(rng, 2, 3, 6, 6)], "Filter": [f32(rng, 4, 3, 3, 3)]}
    attrs = {"strides": [1, 1], "paddings": [1, 1]}
    _, _, pg = check_grads("conv2d", ins, attrs, ["Filter"], rng)
    assert set(pg) == {"Filter@GRAD"}


POOLS = [
    {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1]},
    {"pooling_type": "max", "ksize": [2, 3], "strides": [1, 2],
     "paddings": [1, 2]},                        # pad above half a window
    {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1], "exclusive": True},
    {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1], "exclusive": False},
    {"pooling_type": "avg", "ksize": [2, 2], "strides": [1, 1],
     "paddings": [2, 1], "exclusive": True},
    {"pooling_type": "avg", "ksize": [2, 2], "strides": [1, 1],
     "paddings": [2, 1], "exclusive": False},
    {"pooling_type": "avg", "ksize": [2, 2], "strides": [2, 2]},
    {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [0, 0], "ceil_mode": True},
    {"pooling_type": "avg", "ksize": [1, 1], "global_pooling": True},
    {"pooling_type": "max", "ksize": [1, 1], "global_pooling": True},
]


@pytest.mark.parametrize("attrs", POOLS, ids=range(len(POOLS)))
def test_pool2d_forward_and_grad(attrs):
    rng = np.random.RandomState(3)
    ins = {"X": [f32(rng, 2, 3, 7, 8)]}
    check_forward("pool2d", ins, attrs)
    check_grads("pool2d", ins, attrs, ["X"], rng)


@pytest.mark.parametrize("op,shape,pooled,ptype", [
    ("adaptive_pool2d", (2, 3, 8, 6), [4, 3], "avg"),
    ("adaptive_pool2d", (2, 3, 7, 10), [3, 4], "avg"),
    ("adaptive_pool2d", (2, 3, 7, 10), [3, 4], "max"),
    ("adaptive_pool3d", (1, 2, 4, 6, 8), [2, 3, 4], "max"),
    ("adaptive_pool3d", (1, 2, 5, 7, 6), [2, 3, 4], "avg"),
])
def test_adaptive_pool_forward_and_grad(op, shape, pooled, ptype):
    rng = np.random.RandomState(4)
    ins = {"X": [f32(rng, *shape)]}
    attrs = {"pooled_size": pooled, "pooling_type": ptype}
    check_forward(op, ins, attrs)
    check_grads(op, ins, attrs, ["X"], rng)


def bn_inputs(rng, shape, c):
    return {"X": [f32(rng, *shape) * 2 + 1],
            "Scale": [f32(rng, c)], "Bias": [f32(rng, c)],
            "Mean": [f32(rng, c)],
            "Variance": [rng.uniform(0.5, 2.0, c).astype(np.float32)]}


BATCH_NORMS = [
    ("train NCHW", (4, 3, 5, 6), 3, {}),
    ("train NC (after fc)", (6, 5), 5, {}),
    ("train NHWC", (4, 5, 6, 3), 3, {"data_layout": "NHWC"}),
    ("is_test", (4, 3, 5, 6), 3, {"is_test": True}),
    ("use_global_stats", (4, 3, 5, 6), 3, {"use_global_stats": True}),
    ("is_test NHWC", (2, 4, 4, 3), 3, {"is_test": True,
                                       "data_layout": "NHWC"}),
]


@pytest.mark.parametrize("name,shape,c,extra", BATCH_NORMS,
                         ids=[b[0] for b in BATCH_NORMS])
def test_batch_norm_forward_and_grads(name, shape, c, extra):
    """Y, MeanOut, VarianceOut (momentum · old + (1 − momentum) · the
    batch's biased statistics), SavedMean and SavedVariance (1/sqrt(var
    + eps)); then dX, dScale and dBias through the registered vjp, fed
    the forward's saved statistics."""
    rng = np.random.RandomState(5)
    ins = bn_inputs(rng, shape, c)
    attrs = dict({"momentum": 0.9, "epsilon": 1e-5}, **extra)
    check_forward("batch_norm", ins, attrs)
    pins, gattrs, pg = check_grads(
        "batch_norm", ins, attrs, ["X", "Scale", "Bias"], rng,
        fw_outs=["Y"], saved=("SavedMean", "SavedVariance"))
    assert_vjp_is_the_recompute("batch_norm", pins, gattrs, pg)


def test_batch_norm_moving_stats_use_the_biased_variance():
    rng = np.random.RandomState(6)
    ins = bn_inputs(rng, (8, 2, 3, 3), 2)
    x, var = ins["X"][0], ins["Variance"][0]
    out = port_registry.run_op(
        "batch_norm", {s: [torch.from_numpy(v) for v in vs]
                       for s, vs in ins.items()}, {"momentum": 0.75})
    batch = x.transpose(1, 0, 2, 3).reshape(2, -1).var(axis=1, ddof=0)
    np.testing.assert_allclose(out["VarianceOut"][0].numpy(),
                               0.75 * var + 0.25 * batch, rtol=1e-5)


def test_batch_norm_in_a_test_mode_run_keeps_the_moving_stats():
    rng = np.random.RandomState(7)
    ins = {s: [torch.from_numpy(v) for v in vs]
           for s, vs in bn_inputs(rng, (4, 3, 2, 2), 3).items()}
    with port_registry.test_mode(), port_registry.exec_context(
            port_registry.ExecContext(is_test=True)):
        out = port_registry.run_op("batch_norm", ins, {})
    assert torch.equal(out["MeanOut"][0], ins["Mean"][0])
    assert torch.equal(out["VarianceOut"][0], ins["Variance"][0])


def test_top_k_arg_max_arg_min_and_accuracy():
    """Inputs without ties (torch.topk on the card promises no order
    among ties; lax.top_k takes the lower index).  The port's indices
    are the IR's int64, the JAX package's int32: values compared."""
    rng = np.random.RandomState(8)
    x = rng.permutation(6 * 10).reshape(6, 10).astype(np.float32) / 7
    outs = run_both("top_k", {"X": [x]}, {"k": 3})
    for j, p in outs["Out"] + outs["Indices"]:
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    for op in ("arg_max", "arg_min"):
        for axis in (-1, 0):
            (j, p), = run_both(op, {"X": [x]}, {"axis": axis})["Out"]
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    label = rng.randint(0, 10, (6, 1)).astype(np.int64)
    label[0] = np.argsort(-x[0])[1]              # a hit at rank 2
    indices = outs["Indices"][0][1].numpy()
    acc = run_both("accuracy", {"Out": [outs["Out"][0][1].numpy()],
                                "Indices": [indices], "Label": [label]}, {})
    for slot, dtype in (("Accuracy", torch.float32),
                        ("Correct", torch.int32), ("Total", torch.int32)):
        (j, p), = acc[slot]
        assert p.dtype == dtype and p.shape == np.shape(j)
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-7)
    assert acc["Total"][0][1].item() == 6
