"""The vision, tail and metric ops the port's front end emits against the
JAX package on the CPU, on the same seeded numpy inputs
(``tests/torch_op_parity.py``):

- each op's outputs: float within the case's stated tolerance, relative
  and absolute (1e-6 for elementwise and gather ops, 1e-5 where a
  reduction or a contraction sums in another order: group norm, LRN,
  the 3-D convolution and pools, the grids, ``tree_conv``), integer,
  bool and index outputs equal (``hash``'s XXH64 values, ``chunk_eval``'s
  counts, ``similarity_focus``'s mask, ``edit_distance``'s distances);
- each differentiable op's generic grad against the JAX package's vjp
  under the same cotangents, within 1e-5 relative (atol 1e-6, or 1e-5
  of the grad's largest magnitude for the cases that sum many products),
  equal maxima under ``maxout`` planted;
- ``random_crop`` and ``sample_logits`` with the JAX package's draw
  replaced by the port's (so both compute the same crop and the same
  sampled logits), and the port's draws held statistically: crop
  offsets uniform over their span, sampled classes log-uniform;
- the host-read ops (``chunk_eval``, ``tree_conv``, ``hash``,
  ``similarity_focus``, ``range``) refuse a program's capture, and
  ``squared_l2_norm``, ``clip`` and ``lars_momentum`` do not
  (``executor.capturable`` / ``capture_refusals``).
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu_torch as pfluid
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch.core import executor as port_executor
from paddle_tpu_torch.ops import registry as port_registry
from paddle_tpu_torch.ops import tail_ops, vision_ops
from torch_op_parity import (assert_grads_equal, assert_outputs_match,
                             case_ids, differentiable, f32, grad_call,
                             jax_outputs_of, run_both, run_port)

EW, RED = 1e-6, 1e-5


def _vision_cases(rng):
    img = f32(rng, 2, 4, 5, 6)
    eq = img.copy()
    eq[0, 1] = eq[0, 0]                          # maxout's equal maxima
    vol = f32(rng, 2, 4, 5, 6, 7)
    theta = f32(rng, 2, 2, 3) * 0.5
    grid = np.clip(f32(rng, 2, 3, 4, 2), -1.2, 1.2)
    return [
        ("affine_channel", {"X": [img], "Scale": [f32(rng, 4)],
                            "Bias": [f32(rng, 4)]}, {}, EW),
        ("affine_channel", {"X": [f32(rng, 2, 3, 3, 4)],
                            "Scale": [f32(rng, 4)], "Bias": [f32(rng, 4)]},
         {"data_layout": "NHWC"}, EW),
        ("group_norm", {"X": [img * 3 + 1], "Scale": [f32(rng, 4)],
                        "Bias": [f32(rng, 4)]},
         {"groups": 2, "epsilon": 1e-5}, RED),
        ("lrn", {"X": [img]}, {"n": 5, "k": 1.0, "alpha": 1e-2,
                               "beta": 0.75}, RED),
        ("lrn", {"X": [img]}, {"n": 2, "k": 2.0, "alpha": 0.1,
                               "beta": 0.5}, RED),
        ("maxout", {"X": [eq]}, {"groups": 2}, EW),
        ("bilinear_interp", {"X": [img]}, {"out_h": 9, "out_w": 4,
                                           "align_corners": True}, EW),
        ("bilinear_interp", {"X": [img]}, {"out_h": 3, "out_w": 11,
                                           "align_corners": False}, EW),
        ("bilinear_interp", {"X": [img]}, {"out_h": 1, "out_w": 1,
                                           "align_corners": True}, EW),
        ("nearest_interp", {"X": [img]}, {"out_h": 8, "out_w": 3,
                                          "align_corners": True}, EW),
        ("nearest_interp", {"X": [img]}, {"out_h": 7, "out_w": 13,
                                          "align_corners": False}, EW),
        ("crop", {"X": [img]}, {"offsets": [0, 1, 2, 3],
                                "shape": [2, 2, 3, 3]}, EW),
        ("crop", {"X": [img], "Y": [f32(rng, 1, 3, 4, 4)]},
         {"offsets": [1, 0, 4, 5]}, EW),
        ("pad_constant_like", {"X": [img], "Y": [f32(rng, 1, 3, 5, 2)]},
         {"pad_value": 1.5}, EW),
        ("space_to_depth", {"X": [f32(rng, 2, 3, 4, 6)]},
         {"blocksize": 2}, EW),
        ("shuffle_channel", {"X": [f32(rng, 2, 6, 3, 2)]}, {"group": 3},
         EW),
        ("conv3d", {"Input": [vol], "Filter": [f32(rng, 6, 2, 3, 2, 3)]},
         {"strides": [1, 2, 1], "paddings": [1, 0, 2],
          "dilations": [1, 1, 2], "groups": 2}, RED),
        ("conv3d", {"Input": [vol], "Filter": [f32(rng, 3, 4, 1, 1, 1)]},
         {}, RED),
        ("pool3d", {"X": [vol]}, {"pooling_type": "max", "ksize": [2, 3, 2],
                                  "strides": [2, 1, 2],
                                  "paddings": [1, 1, 0]}, EW),
        ("pool3d", {"X": [vol]}, {"pooling_type": "avg", "ksize": [3, 3, 3],
                                  "strides": [2, 2, 2],
                                  "paddings": [1, 1, 1],
                                  "exclusive": True}, RED),
        ("pool3d", {"X": [vol]}, {"pooling_type": "avg", "ksize": [2, 2, 2],
                                  "strides": [1, 2, 3],
                                  "paddings": [1, 0, 1],
                                  "exclusive": False}, RED),
        ("pool3d", {"X": [vol]}, {"pooling_type": "avg",
                                  "global_pooling": True}, RED),
        ("affine_grid", {"Theta": [theta]},
         {"output_shape": [2, 1, 4, 5]}, RED),
        ("grid_sampler", {"X": [img], "Grid": [grid]}, {}, RED),
    ]


def _tail_cases(rng):
    ta_buf = f32(rng, 4, 2, 3)
    tags = rng.randint(0, 7, (3, 9)).astype(np.int64)
    lab = tags.copy()
    lab[0, 2:5] = rng.randint(0, 7, 3)
    edges = np.array([[[1, 2], [1, 3], [2, 4], [2, 5], [3, 6], [0, 0]],
                      [[1, 2], [2, 3], [3, 4], [0, 0], [0, 0], [0, 0]]],
                     np.int32)
    hyps = rng.randint(1, 5, (4, 6)).astype(np.int64)
    refs = rng.randint(1, 5, (4, 7)).astype(np.int64)
    return [
        ("im2sequence", {"X": [f32(rng, 2, 3, 5, 6)]},
         {"kernels": [2, 3], "strides": [1, 2],
          "paddings": [1, 0, 0, 1]}, EW),
        ("tensor_array_to_tensor", {"X": [(ta_buf, np.array(3, np.int32))]},
         {"axis": 1, "use_stack": False}, EW),
        ("tensor_array_to_tensor", {"X": [(ta_buf, np.array(2, np.int32))]},
         {"axis": 1, "use_stack": True}, EW),
        ("tensor_array_to_tensor", {"X": [ta_buf]},
         {"axis": 0, "use_stack": False}, EW),
        ("sample_logits", {"Logits": [f32(rng, 3, 8)],
                           "Labels": [np.array([[1], [5], [2]], np.int64)],
                           "CustomizedSamples": [np.array(
                               [[1, 3, 5, 1], [5, 0, 5, 7], [2, 6, 4, 3]],
                               np.int64)],
                           "CustomizedProbabilities": [np.abs(f32(
                               rng, 3, 4)) + 0.05]},
         {"num_samples": 3, "remove_accidental_hits": True}, EW),
        ("chunk_eval", {"Inference": [tags], "Label": [lab],
                        "SeqLen": [np.array([9, 4, 0], np.int32)]},
         {"chunk_scheme": "IOB", "num_chunk_types": 3}, EW),
        ("chunk_eval", {"Inference": [tags], "Label": [lab]},
         {"chunk_scheme": "IOE", "num_chunk_types": 3,
          "excluded_chunk_types": [1]}, EW),
        ("chunk_eval", {"Inference": [tags % 5], "Label": [lab % 5]},
         {"chunk_scheme": "IOBES", "num_chunk_types": 1}, EW),
        ("chunk_eval", {"Inference": [tags], "Label": [lab]},
         {"chunk_scheme": "plain", "num_chunk_types": 7}, EW),
        ("tree_conv", {"NodesVector": [f32(rng, 2, 6, 3)],
                       "EdgeSet": [edges], "Filter": [f32(rng, 3, 3, 2, 4)]},
         {"max_depth": 2}, RED),
        ("tree_conv", {"NodesVector": [f32(rng, 2, 6, 3)],
                       "EdgeSet": [edges], "Filter": [f32(rng, 3, 3, 1, 2)]},
         {"max_depth": 3}, RED),
        ("hash", {"X": [rng.randint(0, 10**6, (5, 4)).astype(np.int64)]},
         {"mod_by": 10007, "num_hash": 3}, EW),
        ("hash", {"X": [rng.randint(0, 10**6, (3, 9)).astype(np.int64)]},
         {"mod_by": 1000, "num_hash": 2}, EW),
        ("similarity_focus", {"X": [f32(rng, 2, 3, 4, 5)]},
         {"axis": 1, "indexes": [0, 2]}, EW),
        ("similarity_focus", {"X": [f32(rng, 2, 3, 4, 5)]},
         {"axis": 2, "indexes": [1]}, EW),
        ("similarity_focus", {"X": [f32(rng, 2, 3, 4, 5)]},
         {"axis": 3, "indexes": [4, 0]}, EW),
        ("edit_distance", {"Hyps": [hyps], "Refs": [refs],
                           "HypsLen": [np.array([6, 0, 3, 5], np.int32)],
                           "RefsLen": [np.array([7, 2, 0, 4], np.int32)]},
         {"normalized": False}, EW),
        ("edit_distance", {"Hyps": [hyps[..., None]], "Refs": [refs],
                           "HypsLen": [np.array([2, 6, 1, 4], np.int32)],
                           "RefsLen": [np.array([7, 5, 1, 0], np.int32)]},
         {"normalized": True}, EW),
    ]


_RNG = np.random.RandomState(31)
CASES = _vision_cases(_RNG) + _tail_cases(_RNG)
GRAD_CASES = differentiable(CASES)


@pytest.fixture(scope="module")
def jax_forward():
    return jax_outputs_of([c[:3] for c in CASES])


@pytest.fixture(scope="module")
def jax_grads():
    return jax_outputs_of([grad_call(*c[:3]) for c in GRAD_CASES])


@pytest.mark.parametrize("k", range(len(CASES)), ids=case_ids(CASES))
def test_op_matches_jax(k, jax_forward):
    op_type, ins, attrs, tol = CASES[k]
    assert_outputs_match(op_type, jax_forward[k],
                         run_port(op_type, ins, attrs), tol)


@pytest.mark.parametrize("k", range(len(GRAD_CASES)),
                         ids=case_ids(GRAD_CASES))
def test_generic_grad_matches_jax(k, jax_grads):
    op_type, ins, attrs, tol = GRAD_CASES[k]
    assert_grads_equal(op_type, jax_grads[k],
                       run_port(*grad_call(op_type, ins, attrs)),
                       summed=tol == RED)


@pytest.mark.parametrize("op_type", ["bilinear_interp", "nearest_interp"])
def test_interp_refuses_a_dynamic_out_size(op_type):
    ins = {"X": [torch.zeros(1, 1, 2, 2)],
           "OutSize": [torch.tensor([4, 4], dtype=torch.int32)]}
    with pytest.raises(NotImplementedError):
        port_registry.run_op(op_type, ins, {"out_h": 4, "out_w": 4})


def _port_uniforms(attrs, n, tag):
    return port_registry.uniforms(port_registry.op_seed(attrs), (n,),
                                  torch.device("cpu"), tag).numpy()


def test_random_crop_matches_jax_on_the_same_offsets(monkeypatch):
    x = f32(np.random.RandomState(4), 2, 3, 9, 7)
    attrs = {"shape": [4, 5], "seed": 3}
    u = _port_uniforms(attrs, 2, vision_ops._TAG_RANDOM_CROP)
    # one randint a cropped dim, in order, each time the op is traced
    starts = itertools.cycle([int(u[0] * 6), int(u[1] * 3)])
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, *a, **k:
                        jnp.asarray(next(starts), jnp.int32))
    want, got = run_both("random_crop", {"X": [x]}, attrs)
    assert_outputs_match("random_crop", want, got, EW)
    assert got["Out"][0].shape == (2, 3, 4, 5)


def test_random_crop_offsets_are_uniform():
    """Over 600 steps (the op's seed keyed by the step) each offset of a
    span of 4 comes up within 5 standard errors of a quarter."""
    x = torch.arange(9.0).reshape(1, 9)
    starts = []
    for step in range(600):
        ctx = port_registry.ExecContext(step=step)
        with port_registry.exec_context(ctx):
            out = port_registry.run_op("random_crop", {"X": [x]},
                                       {"shape": [6]})["Out"][0]
        starts.append(int(out[0, 0]))
    share = np.bincount(starts, minlength=4) / len(starts)
    assert len(share) == 4
    se = np.sqrt(0.25 * 0.75 / len(starts))
    assert np.all(np.abs(share - 0.25) < 5 * se), share


def _sample_logits_case(rng):
    ins = {"Logits": [f32(rng, 5, 20)],
           "Labels": [rng.randint(0, 20, (5, 2)).astype(np.int64)]}
    return ins, {"num_samples": 6, "seed": 4,
                 "remove_accidental_hits": True}


def test_sample_logits_matches_jax_on_the_same_draw(monkeypatch):
    ins, attrs = _sample_logits_case(np.random.RandomState(6))
    u = _port_uniforms(attrs, 5 * 6, tail_ops._TAG_SAMPLE_LOGITS)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k:
                        jnp.asarray(u.reshape(shape)))
    want, got = run_both("sample_logits", ins, attrs)
    assert_outputs_match("sample_logits", want, got, EW)
    call = grad_call("sample_logits", ins, attrs)
    assert_grads_equal("sample_logits", *run_both(*call))


def test_sample_logits_draws_are_log_uniform():
    """4000 rows × 6 draws over C = 20: each class's share within 5
    standard errors of log((k + 2) / (k + 1)) / log(C + 1)."""
    rng = np.random.RandomState(7)
    c, n = 20, 4000
    ins = {"Logits": [torch.from_numpy(f32(rng, n, c))],
           "Labels": [torch.zeros(n, 1, dtype=torch.int64)]}
    out = port_registry.run_op("sample_logits", ins,
                               {"num_samples": 6, "seed": 1})
    drawn = out["Samples"][0][:, 1:].numpy().reshape(-1)
    k = np.arange(c)
    p = np.log((k + 2) / (k + 1)) / np.log(c + 1)
    share = np.bincount(drawn, minlength=c) / drawn.size
    se = np.sqrt(p * (1 - p) / drawn.size)
    assert np.all(np.abs(share - p) < 5 * se), (share, p)


def _program_with(op_types):
    """A program holding one op of each type (inputs are never fed: only
    the ops' types matter to the capture rule)."""
    main = pfluid.Program()
    blk = main.global_block()
    for i, t in enumerate(op_types):
        x = blk.create_var(name=f"x{i}", shape=(2,), dtype="float32")
        out = blk.create_var(name=f"o{i}", shape=(2,), dtype="float32")
        blk.append_op(type=t, inputs={"X": [x]}, outputs={"Out": [out]})
    return main


HOST_READ = ["chunk_eval", "tree_conv", "hash", "similarity_focus", "range"]


@pytest.mark.parametrize("op_type", HOST_READ)
def test_capture_refuses_an_op_read_on_the_host(op_type):
    prog = _program_with(["squared_l2_norm", op_type, "clip"])
    assert not port_executor.capturable(prog)
    assert port_executor.capture_refusals(prog) == [op_type]


def test_capture_admits_clipping_and_lars():
    prog = _program_with(["squared_l2_norm", "clip", "clip_by_norm",
                          "lars_momentum", "sqrt", "elementwise_max"])
    assert port_executor.capturable(prog)
    assert port_executor.capture_refusals(prog) == []


def test_ported_ops_keep_the_jax_packages_differentiability():
    ops = sorted({c[0] for c in CASES} | {"random_crop"})
    assert [o for o in ops if port_registry.is_differentiable(o)
            != jax_registry.is_differentiable(o)] == []
