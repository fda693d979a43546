"""The math, tensor, nn and loss ops the port's front end emits (its
layers, gradient clipping and ``L1Decay``) against the JAX package on
the CPU, on the same seeded numpy inputs (``tests/torch_op_parity.py``):

- each op's outputs: float within the case's stated tolerance, relative
  and absolute (1e-6 for elementwise ops, 1e-5 where a reduction or a
  contraction sums in another order), integer, bool and index outputs
  equal;
- each differentiable op's generic grad against the JAX package's vjp
  under the same cotangents, within 1e-5 relative (atol 1e-6, or 1e-5
  of the grad's largest magnitude for the cases that sum many
  products), with
  values planted on the ties where torch's default derivatives differ
  from JAX's: ``clip`` at its bounds, ``relu6`` at 0 and 6,
  ``hard_sigmoid`` at its corners, equal maxima and minima under
  ``reduce_max`` / ``reduce_min``, and 0 under ``abs``, ``leaky_relu``,
  ``elu`` and the losses' ``max(·, 0)``;
- ``elementwise_mod`` / ``elementwise_floordiv`` with mixed signs (the
  divisor's sign, a floor);
- ``sampling_id`` held statistically (its draws' histogram against the
  probabilities) and its ids reproducible; ``nce`` with the JAX
  package's negative draw replaced by the port's, so the two compute
  the loss over the same ids.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch.ops import registry as port_registry
from torch_op_parity import (assert_grads_equal, assert_grads_match,
                             assert_outputs_match, case_ids, differentiable,
                             f32, grad_call, jax_outputs_of, run_both,
                             run_port)

EW, RED = 1e-6, 1e-5
B, D = 4, 6


def _ties():
    # planted ties: clip's bounds ±1, relu6's 0 and 6, and hard_sigmoid's
    # corners at slope 0.25 (exact in float32, with or without an FMA)
    return np.array([[-1.0, 1.0, 0.0, 6.0, -2.0, 2.0],
                     [0.3, -0.7, 7.0, -3.0, 0.5, 1.5]], np.float32)


def _math_cases(rng):
    x = f32(rng, B, D)
    pos = np.abs(x) + 0.2
    with_zero = x.copy()
    with_zero[0, :2] = 0.0
    eq = x.copy()
    eq[1, 2] = eq[1, 4] = np.max(eq[1]) + 1.0      # equal maxima in a row
    eq[2, 0] = eq[2, 3] = np.min(eq[2]) - 1.0      # equal minima
    ties = _ties()
    ints = rng.randint(-9, 10, (B, D)).astype(np.int64)
    divs = rng.choice([-4, -3, 3, 5], (B, D)).astype(np.int64)
    fdiv = np.where(rng.rand(B, D) < 0.5, -1.0, 1.0).astype(np.float32) \
        * (np.abs(f32(rng, B, D)) + 0.5)
    return [
        ("sqrt", {"X": [pos]}, {}, EW),
        ("rsqrt", {"X": [pos]}, {}, EW),
        ("abs", {"X": [with_zero]}, {}, EW),
        ("round", {"X": [x * 3]}, {}, EW),
        ("reciprocal", {"X": [pos]}, {}, EW),
        ("softsign", {"X": [x]}, {}, EW),
        ("softplus", {"X": [x * 5]}, {}, EW),
        ("sin", {"X": [x * 3]}, {}, EW),
        ("erf", {"X": [x]}, {}, EW),
        ("logsigmoid", {"X": [x * 4]}, {}, EW),
        ("leaky_relu", {"X": [with_zero]}, {"alpha": 0.1}, EW),
        ("elu", {"X": [with_zero * 3]}, {"alpha": 1.5}, EW),
        ("relu6", {"X": [ties]}, {"threshold": 6.0}, EW),
        ("hard_sigmoid", {"X": [ties]}, {"slope": 0.25}, EW),
        ("hard_sigmoid", {"X": [x * 3]}, {}, EW),
        ("swish", {"X": [x * 3]}, {"beta": 1.5}, EW),
        ("clip", {"X": [ties]}, {"min": -1.0, "max": 1.0}, EW),
        ("clip_by_norm", {"X": [x]}, {"max_norm": 1.0}, EW),
        ("clip_by_norm", {"X": [x * 0.05]}, {"max_norm": 1.0}, EW),
        ("reduce_max", {"X": [eq]}, {"dim": [1], "keep_dim": False}, EW),
        ("reduce_max", {"X": [eq]}, {"dim": [0, 1], "keep_dim": True}, EW),
        ("reduce_min", {"X": [eq]}, {"dim": [-1], "keep_dim": True}, EW),
        ("reduce_min", {"X": [eq]}, {"reduce_all": True}, EW),
        ("reduce_prod", {"X": [pos]}, {"dim": [1]}, RED),
        ("reduce_prod", {"X": [f32(rng, 2, 3, 4)]},
         {"dim": [0, 2], "keep_dim": True}, RED),
        ("reduce_prod", {"X": [with_zero]}, {"reduce_all": True}, RED),
        ("squared_l2_norm", {"X": [x]}, {}, RED),
        ("isfinite", {"X": [x]}, {}, EW),
        ("isfinite", {"X": [np.where(x > 1, np.inf, x).astype(
            np.float32)]}, {}, EW),
        ("elementwise_mod", {"X": [ints], "Y": [divs]}, {}, EW),
        ("elementwise_mod", {"X": [x * 5], "Y": [fdiv]}, {}, EW),
        ("elementwise_floordiv", {"X": [ints], "Y": [divs]}, {}, EW),
        ("elementwise_floordiv", {"X": [x * 5], "Y": [fdiv]}, {}, EW),
        ("elementwise_mod", {"X": [f32(rng, B, 3, D) * 4],
                             "Y": [np.abs(f32(rng, D)) + 0.5]},
         {"axis": -1}, EW),
    ]


def _tensor_cases(rng):
    x = f32(rng, B, D)
    ties = x.copy()
    ties[0, 1] = ties[0, 4]                       # argsort keeps order
    probs = np.abs(f32(rng, B, 5)) + 0.01
    return [
        ("fill_zeros_like", {"X": [x]}, {}, EW),
        ("squeeze", {"X": [f32(rng, B, 1, D, 1)]}, {"axes": [1, -1]}, EW),
        ("squeeze", {"X": [f32(rng, 1, D, 1)]}, {}, EW),
        ("unsqueeze", {"X": [x]}, {"axes": [2, 0]}, EW),
        ("flatten", {"X": [f32(rng, 2, 3, 4, 5)]}, {"axis": 2}, EW),
        ("scatter", {"X": [x], "Ids": [np.array([3, 0], np.int64)],
                     "Updates": [f32(rng, 2, D)]}, {"overwrite": True}, EW),
        ("scatter", {"X": [x], "Ids": [np.array([1, 1, 2], np.int64)],
                     "Updates": [f32(rng, 3, D)]}, {"overwrite": False},
         EW),
        ("range", {"Start": [np.array([1.0], np.float32)],
                   "End": [np.array([6.5], np.float32)],
                   "Step": [np.array([0.75], np.float32)]}, {}, EW),
        ("shape", {"Input": [f32(rng, 2, 3, 5)]}, {}, EW),
        ("reverse", {"X": [f32(rng, 3, 4, 5)]}, {"axis": [0, 2]}, EW),
        ("argsort", {"X": [ties]}, {"axis": -1}, EW),
        ("argsort", {"X": [ties]}, {"axis": 0}, EW),
        ("multiplex", {"X": [f32(rng, B, D) for _ in range(3)],
                       "Ids": [np.array([[2], [0], [1], [2]], np.int32)]},
         {}, EW),
        ("selu", {"X": [x * 2]}, {}, EW),
        ("is_empty", {"X": [x]}, {}, EW),
        ("is_empty", {"X": [np.zeros((0, 3), np.float32)]}, {}, EW),
        ("row_conv", {"X": [f32(rng, 2, 5, 3)], "Filter": [f32(rng, 3, 3)]},
         {}, RED),
    ], probs


def _nn_loss_cases(rng):
    x = f32(rng, B, D)
    y = f32(rng, B, D)
    lab01 = rng.randint(0, 2, (B, 1)).astype(np.float32)
    prob = (rng.rand(B, 1) * 0.9 + 0.05).astype(np.float32)
    logit = f32(rng, B, 1)
    at_zero = logit.copy()
    at_zero[0] = 1.0                              # hinge's max at 0
    logp = np.log(np.abs(f32(rng, B, D)) + 0.1).astype(np.float32)
    target = np.abs(f32(rng, B, D))
    target[0, :2] = 0.0                           # target <= 0 terms
    c = 10
    return [
        ("l2_normalize", {"X": [x]}, {"axis": 1, "epsilon": 1e-10}, EW),
        ("l2_normalize", {"X": [f32(rng, 2, 3, 4)]}, {"axis": 0}, EW),
        ("smooth_l1_loss", {"X": [x], "Y": [y * 0.5]}, {"sigma": 2.0},
         RED),
        ("hierarchical_sigmoid", {"X": [f32(rng, 5, 4)],
                                  "W": [f32(rng, c - 1, 4)],
                                  "Label": [np.array([[0], [9], [3], [7],
                                                      [5]], np.int64)],
                                  "Bias": [f32(rng, c - 1)]},
         {"num_classes": c}, RED),
        ("hierarchical_sigmoid", {"X": [f32(rng, 3, 4)],
                                  "W": [f32(rng, 6, 4)],
                                  "Label": [np.array([0, 6, 4],
                                                     np.int64)]},
         {"num_classes": 7}, RED),
        ("sign", {"X": [np.where(np.abs(x) < 0.3, 0, x).astype(
            np.float32)]}, {}, EW),
        ("log_loss", {"Predicted": [prob], "Labels": [lab01]},
         {"epsilon": 1e-4}, EW),
        ("hinge_loss", {"Logits": [at_zero], "Labels": [
            np.ones((B, 1), np.float32)]}, {}, EW),
        ("hinge_loss", {"Logits": [logit], "Labels": [lab01]}, {}, EW),
        ("rank_loss", {"Label": [lab01], "Left": [logit],
                       "Right": [np.where(np.arange(B)[:, None] == 0,
                                          logit, f32(rng, B, 1))]}, {}, EW),
        ("margin_rank_loss", {"Label": [np.where(lab01 > 0, 1.0, -1.0)
                                        .astype(np.float32)],
                              "X1": [logit], "X2": [f32(rng, B, 1)]},
         {"margin": 0.1}, EW),
        ("modified_huber_loss", {"X": [np.array([[-2.0], [0.3], [1.0],
                                                 [-0.5]], np.float32)],
                                 "Y": [np.array([[1.0], [1.0], [1.0],
                                                 [0.0]], np.float32)]},
         {}, EW),
        ("huber_loss", {"X": [x], "Y": [y * 2]}, {"delta": 1.0}, EW),
        ("kldiv_loss", {"X": [logp], "Target": [target]},
         {"reduction": "mean"}, RED),
        ("kldiv_loss", {"X": [logp], "Target": [target]},
         {"reduction": "batchmean"}, RED),
        ("kldiv_loss", {"X": [logp], "Target": [target]},
         {"reduction": "none"}, EW),
        ("squared_l2_distance", {"X": [x], "Y": [y]}, {}, RED),
        ("bpr_loss", {"X": [f32(rng, B, 5)],
                      "Label": [np.array([[0], [4], [2], [2]], np.int64)]},
         {}, EW),
        ("bilinear_tensor_product", {"X": [f32(rng, B, 3)],
                                     "Y": [f32(rng, B, 4)],
                                     "Weight": [f32(rng, 2, 3, 4)],
                                     "Bias": [f32(rng, 1, 2)]}, {}, RED),
        ("teacher_student_sigmoid_loss",
         {"X": [np.array([[20.0], [-0.4], [15.0], [2.0]], np.float32)],
          "Label": [np.array([[0.7], [0.0], [1.0], [0.2]], np.float32)]},
         {}, EW),
    ]


_RNG = np.random.RandomState(21)
TENSOR_CASES, SAMPLING_PROBS = _tensor_cases(_RNG)
CASES = _math_cases(_RNG) + TENSOR_CASES + _nn_loss_cases(_RNG)
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


def test_ties_split_as_jax_does():
    """The planted ties give JAX's derivatives, not torch's defaults:
    0.5 at a clip bound, (0.5, 0.5) over two equal maxima."""
    x = torch.tensor([-1.0, 1.0, 0.0, 6.0], requires_grad=True)
    out = port_registry.run_op("clip", {"X": [x]},
                               {"min": -1.0, "max": 1.0})["Out"][0]
    out.sum().backward()
    assert x.grad.tolist() == [0.5, 0.5, 1.0, 0.0]
    m = torch.tensor([[2.0, 2.0, 1.0]], requires_grad=True)
    port_registry.run_op("reduce_max", {"X": [m]},
                         {"dim": [1]})["Out"][0].sum().backward()
    assert m.grad.tolist() == [[0.5, 0.5, 0.0]]


def test_mod_and_floordiv_take_the_divisors_sign():
    x = torch.tensor([-7, 7, -7, 7])
    y = torch.tensor([3, -3, -3, 3])
    mod = port_registry.run_op("elementwise_mod", {"X": [x], "Y": [y]},
                               {})["Out"][0]
    div = port_registry.run_op("elementwise_floordiv",
                               {"X": [x], "Y": [y]}, {})["Out"][0]
    assert mod.tolist() == [2, -2, -1, 1]
    assert div.tolist() == [-3, -3, 2, 2]
    assert np.asarray(jnp.mod(jnp.array([-7, 7]),
                              jnp.array([3, -3]))).tolist() == [2, -2]


def test_sampling_id_draws_follow_the_probabilities():
    """8000 rows of one distribution: each class's share of the draws
    within 5 standard errors of its probability (the JAX package's
    categorical over log(max(x, 1e-20)) has the same law); a step's ids
    are a function of (seed, step)."""
    p = SAMPLING_PROBS[0] / SAMPLING_PROBS[0].sum()
    n = 8000
    x = torch.from_numpy(np.tile(SAMPLING_PROBS[0], (n, 1)))
    ids = port_registry.run_op("sampling_id", {"X": [x]},
                               {"seed": 5})["Out"][0].numpy()
    share = np.bincount(ids, minlength=p.size) / n
    se = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(share - p) < 5 * se), (share, p)
    again = port_registry.run_op("sampling_id", {"X": [x]},
                                 {"seed": 5})["Out"][0].numpy()
    np.testing.assert_array_equal(ids, again)
    jids = np.asarray(jax_registry.run_op(
        "sampling_id", {"X": [jnp.asarray(x.numpy())]}, {})["Out"][0])
    jshare = np.bincount(jids, minlength=p.size) / n
    assert np.all(np.abs(jshare - p) < 5 * se), (jshare, p)


def _nce_case(rng):
    ins = {"Input": [f32(rng, B, 5)],
           "Label": [np.array([[1], [7], [3], [3]], np.int64)],
           "Weight": [f32(rng, 12, 5)], "Bias": [f32(rng, 12)]}
    return ins, {"num_neg_samples": 6, "num_total_classes": 12, "seed": 2}


def _port_negatives(ins, attrs):
    got = port_registry.run_op(
        "nce", {s: [torch.from_numpy(v) for v in vs]
                for s, vs in ins.items()}, dict(attrs))
    return got["SampleLabels"][0][:, 1:].numpy()


@pytest.fixture
def jax_draws_port_negatives(monkeypatch):
    """The JAX package's nce draws its negatives with
    ``jax.random.randint``: give it the port's draw instead."""
    def use(neg):
        monkeypatch.setattr(jax.random, "randint",
                            lambda key, shape, lo, hi, *a, **k:
                            jnp.asarray(neg, jnp.int32).reshape(shape))
    return use


def test_nce_matches_jax_on_the_same_negatives(jax_draws_port_negatives):
    ins, attrs = _nce_case(np.random.RandomState(8))
    neg = _port_negatives(ins, attrs)
    assert neg.min() >= 0 and neg.max() < 12
    jax_draws_port_negatives(neg)
    want, got = run_both("nce", ins, attrs)
    assert_outputs_match("nce", want, got, RED)
    assert_grads_match("nce", ins, attrs)


def test_nce_negatives_are_uniform():
    """Over 4000 rows × 6 draws every class's share is within 5 standard
    errors of 1/12, and the draw depends on the op's seed."""
    rng = np.random.RandomState(9)
    ins, attrs = _nce_case(rng)
    ins = dict(ins, Input=[f32(rng, 4000, 5)],
               Label=[rng.randint(0, 12, (4000, 1)).astype(np.int64)])
    neg = _port_negatives(ins, attrs)
    share = np.bincount(neg.reshape(-1), minlength=12) / neg.size
    se = np.sqrt((1 / 12) * (11 / 12) / neg.size)
    assert np.all(np.abs(share - 1 / 12) < 5 * se), share
    other = _port_negatives(ins, dict(attrs, seed=3))
    assert (other != neg).any()


def test_ported_ops_keep_the_jax_packages_differentiability():
    ops = sorted({c[0] for c in CASES} | {"sampling_id", "nce"})
    assert [o for o in ops if port_registry.is_differentiable(o)
            != jax_registry.is_differentiable(o)] == []
