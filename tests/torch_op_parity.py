"""Shared harness of the op-parity tests: one op run by the JAX package's
registry and by the port's on the same numpy inputs, and the generic
grad op of each against the other under the same cotangents.

A case is ``(op_type, ins, attrs, tol)``: `ins` maps a slot to a list of
numpy arrays (or, for a tensor array, a ``(buffer, count)`` pair),
`tol` the op's stated float tolerance, relative and absolute.  Integer
and bool outputs must be equal; the JAX package runs 64-bit types as
32-bit, so values are compared, not dtypes.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch.ops import registry as port_registry

GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


def f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _to_jax(v):
    if isinstance(v, tuple):
        return tuple(jnp.asarray(a) for a in v)
    return jnp.asarray(v)


def _to_torch(v):
    if isinstance(v, tuple):
        return tuple(torch.from_numpy(np.array(a)) for a in v)
    return torch.from_numpy(np.array(v))


def run_jax(op_type, ins, attrs):
    """The JAX package's op under ``jax.jit``, eagerly where the kernel
    reads a value on the host."""
    return jax_outputs_of([(op_type, ins, attrs)])[0]


def _jins(ins):
    return {s: [_to_jax(v) for v in vs] for s, vs in ins.items()}


def _traces(op_type, jins, attrs):
    try:
        jax.eval_shape(lambda i: jax_registry.run_op(op_type, i,
                                                     dict(attrs)), jins)
        return True
    except jax.errors.ConcretizationTypeError:
        return False


def jax_outputs_of(calls):
    """The JAX package's outputs of every ``(op_type, ins, attrs)`` call,
    the calls whose kernels trace under one ``jax.jit`` (one compile for
    them all, where a compile a case would take most of a test's time)
    and the others eagerly."""
    jins = [_jins(ins) for _, ins, _ in calls]
    traced = [k for k, (op, _, attrs) in enumerate(calls)
              if _traces(op, jins[k], attrs)]

    def run_all(args):
        return [jax_registry.run_op(calls[k][0], a, dict(calls[k][2]))
                for k, a in zip(traced, args)]

    outs = dict(zip(traced, jax.jit(run_all)([jins[k] for k in traced])))
    return [outs[k] if k in outs else
            jax_registry.run_op(op, jins[k], dict(attrs))
            for k, (op, _, attrs) in enumerate(calls)]


def run_port(op_type, ins, attrs):
    return port_registry.run_op(
        op_type, {s: [_to_torch(v) for v in vs] for s, vs in ins.items()},
        dict(attrs))


def grad_call(op_type, ins, attrs):
    """The generic grad op's ``(op_type, ins, attrs)`` call for `op_type`
    over `ins` (:func:`grad_case` over the forward's output shapes)."""
    outs = jax.eval_shape(
        lambda i: jax_registry.run_op(op_type, i, dict(attrs)), _jins(ins))
    gins, gattrs = grad_case(op_type, ins, attrs, outs)
    return "generic_grad", gins, gattrs


def assert_grads_equal(op_type, want, got, summed=False):
    """Grads within GRAD_RTOL relative and GRAD_ATOL absolute; for an op
    whose forward sums many products (`summed`: a convolution, a
    contraction), whose grads sum in another order in each framework,
    the absolute term is GRAD_RTOL of the grad's largest magnitude."""
    assert set(want) == set(got) and want
    for slot, wv in want.items():
        for w, g in zip(wv, got[slot]):
            w = np.asarray(w)
            atol = max(GRAD_ATOL, GRAD_RTOL * float(np.abs(w).max(
                initial=0.0))) if summed else GRAD_ATOL
            np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                       atol=atol,
                                       err_msg=f"{op_type}:{slot}")


def run_both(op_type, ins, attrs):
    return run_jax(op_type, ins, attrs), run_port(op_type, ins, attrs)


def assert_outputs_match(op_type, want, got, tol, slots=None):
    assert set(want) == set(got), (sorted(want), sorted(got))
    for slot in slots or want:
        for w, g in zip(want[slot], got[slot]):
            w, g = np.asarray(w), g.detach().numpy()
            assert g.shape == w.shape, (op_type, slot, g.shape, w.shape)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                           err_msg=f"{op_type}:{slot}")
            else:
                np.testing.assert_array_equal(
                    g, w.astype(g.dtype), err_msg=f"{op_type}:{slot}")


def is_float(v):
    return not isinstance(v, tuple) and np.asarray(v).dtype == np.float32


def grad_case(op_type, ins, attrs, outs, seed=3):
    """The generic grad op's ins and attrs for `op_type`'s forward over
    `ins` (float inputs differentiated, float outputs given random
    cotangents); `outs` are the forward's outputs or their shapes."""
    rng = np.random.RandomState(seed)
    needs = [(s, i) for s, vs in ins.items() for i, v in enumerate(vs)
             if is_float(v)]
    ograds = {s: [f32(rng, *v.shape) for v in vs]
              for s, vs in outs.items()
              if np.issubdtype(vs[0].dtype, np.floating)}
    gattrs = {"fw_type": op_type, "fw_attrs": dict(attrs),
              "fw_in_slots": [(s, len(v)) for s, v in ins.items()],
              "fw_out_slots": [(s, len(v)) for s, v in outs.items()],
              "needs_input_grad": needs,
              "has_out_grad": [(s, i) for s, gs in ograds.items()
                               for i in range(len(gs))]}
    gins = dict(ins)
    gins.update({f"{s}@GRAD_OUT": gs for s, gs in ograds.items()})
    return gins, gattrs


def differentiable(cases):
    """The cases whose op the port differentiates (as the JAX package
    does: the same ``not_differentiable`` marks) over a float input."""
    return [c for c in cases if port_registry.is_differentiable(c[0])
            and any(is_float(v) for vs in c[1].values() for v in vs)]


def assert_grads_match(op_type, ins, attrs):
    call = grad_call(op_type, ins, attrs)
    assert_grads_equal(op_type, *run_both(*call))


def case_ids(cases):
    return [f"{c[0]}-{i}" for i, c in enumerate(cases)]
