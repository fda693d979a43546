"""The RNN time steps of the port (K8 ``lstm_step``, K9 ``gru_step``)
against the JAX package on the CPU, on the same seeded numpy inputs:

- the steps' plain versions, chained over three time steps forward and in
  reverse, against the JAX package's scan body (the product, the Pallas
  cell in interpret mode, the length mask; ``paddle_tpu/ops/rnn_ops.py``
  :63-93 and :165-189): outputs and ``jax.vjp`` grads for xg, h_prev,
  c_prev and W (and ur_pre for the GRU step), at B 8, D 128, ragged
  lengths that include 0 and one past every step, atol/rtol 1e-5;
- the ``lstm`` and ``gru`` ops on the CPU against the composition of
  torch ops the port ran before its step kernels, bit for bit;
- the step wrappers' refusals (misshapen inputs; on CUDA tensors, other
  dtypes, strides and lengths) and no launch for a CPU tensor;
- a CPU model of the step kernels' product (3xTF32 m16n8k8 with the
  tensor cores' sum truncated to fp32): with fresh accumulators for each
  k8 step, added rounded to nearest, it is as close to float64 as
  torch's fp32 product in mean, while one accumulator chain over 16 k8
  steps is more than 3 times as far.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import registry as port_registry
from paddle_tpu_torch.ops import rnn_kernels

ATOL = RTOL = 1e-5
B, D = 8, 128
# a zero length, lengths inside the three steps, and ones past them
LENS = np.array([0, 1, 2, 3, 5, 128, 2, 7], np.int32)


def f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jax_lstm_step(xg, h_prev, c_prev, w, lens, step):
    gates = xg + h_prev @ w
    h, c = pk.fused_lstm_cell(gates, c_prev, interpret=True)
    valid = (step < lens)[:, None].astype(xg.dtype)
    h = h * valid + h_prev * (1 - valid)
    c = c * valid + c_prev * (1 - valid)
    return h, c, h * valid, c * valid


def _jax_gru_step(ur_pre, xg_c, h_prev, w_c, lens, step, origin_mode):
    d = h_prev.shape[1]
    _, r = jnp.split(jax.nn.sigmoid(ur_pre), 2, axis=-1)
    cand_pre = xg_c + (r * h_prev) @ w_c
    h = pk.fused_gru_output(ur_pre[:, :d], cand_pre, h_prev,
                            origin_mode=origin_mode, interpret=True)
    valid = (step < lens)[:, None].astype(h.dtype)
    h = h * valid + h_prev * (1 - valid)
    return h, h * valid


def _chain(kind, steps, np_mod):
    """fn(*inputs) -> outputs of three chained steps of `kind` taken in
    the order `steps`, through the JAX body (np_mod jnp) or the port's
    step wrapper (np_mod torch); the numpy inputs beside."""
    rng = np.random.RandomState(23)
    if kind == "lstm":
        arrays = [f32(rng, B, 3, 4 * D), f32(rng, B, D, scale=0.5),
                  f32(rng, B, D), f32(rng, D, 4 * D, scale=D ** -0.5)]
    else:
        arrays = [f32(rng, B, 3, 2 * D), f32(rng, B, 3, D),
                  f32(rng, B, D, scale=0.5),
                  f32(rng, D, D, scale=D ** -0.5)]
    mode = kind == "gru_origin"

    def fn(*xs):
        outs = []
        if kind == "lstm":
            x, h, c, w = xs
            lens = jnp.asarray(LENS) if np_mod is jnp \
                else torch.from_numpy(LENS)
            for s in steps:
                step = (_jax_lstm_step if np_mod is jnp
                        else rnn_kernels.lstm_step)
                h, c, he, ce = step(x[:, s], h, c, w, lens, s)
                outs += [he, ce]
            return tuple(outs + [h, c])
        ur, xc, h, w = xs
        lens = jnp.asarray(LENS) if np_mod is jnp \
            else torch.from_numpy(LENS)
        for s in steps:
            if np_mod is jnp:
                h, he = _jax_gru_step(ur[:, s], xc[:, s], h, w, lens, s,
                                      mode)
            else:
                h, he = rnn_kernels.gru_step(ur[:, s], xc[:, s], h, w,
                                             lens, s, mode)
            outs.append(he)
        return tuple(outs + [h])

    return fn, arrays


@pytest.mark.parametrize("reverse", [False, True], ids=["forward",
                                                        "reverse"])
@pytest.mark.parametrize("kind", ["lstm", "gru", "gru_origin"])
def test_step_plain_matches_jax_step_body(kind, reverse):
    steps = [2, 1, 0] if reverse else [0, 1, 2]
    jax_fn, arrays = _chain(kind, steps, jnp)
    want, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in arrays])
    rng = np.random.RandomState(5)
    cots = [f32(rng, *np.shape(w)) for w in want]
    want_grads = vjp(tuple(jnp.asarray(c) for c in cots))

    port_fn, _ = _chain(kind, steps, torch)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = port_fn(*leaves)
    grads = torch.autograd.grad(got, leaves,
                                [torch.from_numpy(c) for c in cots])
    for g, w in zip(got + grads, tuple(want) + tuple(want_grads)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=RTOL)
    # the zero-length row emits zeros and carries its initial state
    assert not got[0][0].detach().any()
    np.testing.assert_array_equal(got[-1][0].detach().numpy(),
                                  arrays[-2][0] if kind == "lstm"
                                  else arrays[2][0])


# ---------------------------------------------------------------------------
# the ops on the CPU: the composition the port ran before its step kernels
# ---------------------------------------------------------------------------

def _composed_lstm(x, lens, w, h, c, is_reverse):
    t, d = x.shape[1], c.shape[1]
    hs, cs = [None] * t, [None] * t
    for step in (range(t - 1, -1, -1) if is_reverse else range(t)):
        gates = x[:, step] + h @ w
        h_new, c_new = rnn_kernels.lstm_cell_reference(gates, c)
        valid = (step < lens).to(x.dtype)[:, None]
        h = h_new * valid + h * (1 - valid)
        c = c_new * valid + c * (1 - valid)
        hs[step], cs[step] = h * valid, c * valid
    assert d == w.shape[0]
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def _composed_gru(x, lens, w, h, is_reverse, origin_mode):
    t, d = x.shape[1], h.shape[1]
    hs = [None] * t
    for step in (range(t - 1, -1, -1) if is_reverse else range(t)):
        xg = x[:, step]
        ur_pre = xg[:, :2 * d] + h @ w[:, :2 * d]
        u, r = torch.chunk(torch.sigmoid(ur_pre), 2, dim=-1)
        cand_pre = xg[:, 2 * d:] + (r * h) @ w[:, 2 * d:]
        h_new = rnn_kernels.gru_output_reference(ur_pre[:, :d], cand_pre, h,
                                                 origin_mode)
        valid = (step < lens).to(x.dtype)[:, None]
        h = h_new * valid + h * (1 - valid)
        hs[step] = h * valid
    return torch.stack(hs, dim=1)


@pytest.mark.parametrize("given_state", [False, True],
                         ids=["zero_state", "given_state"])
@pytest.mark.parametrize("kind,reverse", [
    ("lstm", False), ("lstm", True), ("gru", False), ("gru", True),
    ("gru_origin", False)])
def test_cpu_ops_equal_the_earlier_composition_bit_for_bit(kind, reverse,
                                                           given_state):
    rng = np.random.RandomState(31)
    b, t, d = 5, 7, 24
    lens = torch.from_numpy(np.array([7, 0, 3, 6, 1], np.int32))
    gates = 4 if kind == "lstm" else 3
    x = torch.from_numpy(f32(rng, b, t, gates * d))
    w = torch.from_numpy(f32(rng, d, gates * d, scale=d ** -0.5))
    bias = torch.from_numpy(f32(rng, 1, gates * d, scale=0.1))
    h0 = torch.from_numpy(f32(rng, b, d, scale=0.5))
    c0 = torch.from_numpy(f32(rng, b, d))
    ins = {"Input": [x], "SeqLen": [lens], "Weight": [w], "Bias": [bias]}
    h = h0 if given_state else torch.zeros(b, d)
    c = c0 if given_state else torch.zeros(b, d)
    if given_state:
        ins["H0"] = [h0]
        if kind == "lstm":
            ins["C0"] = [c0]
    if kind == "lstm":
        got = port_registry.run_op("lstm", ins, {"use_peepholes": False,
                                                 "is_reverse": reverse})
        want = _composed_lstm(x + bias.reshape(1, 1, -1), lens, w, h, c,
                              reverse)
        assert torch.equal(got["Hidden"][0], want[0])
        assert torch.equal(got["Cell"][0], want[1])
    else:
        mode = kind == "gru_origin"
        got = port_registry.run_op("gru", ins, {"is_reverse": reverse,
                                                "origin_mode": mode})
        want = _composed_gru(x + bias.reshape(1, 1, -1), lens, w, h,
                             reverse, mode)
        assert torch.equal(got["Hidden"][0], want)


# ---------------------------------------------------------------------------
# the step wrappers' refusals
# ---------------------------------------------------------------------------

class _OnCuda:
    """A CPU tensor that reports a CUDA device: what the wrappers check
    before they launch, without a card (the checks raise before any
    launch)."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self.t, name)


def _step_args(kind, d=8, b=3):
    if kind == "lstm":
        return [torch.zeros(b, 4 * d), torch.zeros(b, d), torch.zeros(b, d),
                torch.zeros(d, 4 * d), torch.zeros(b, dtype=torch.int32)]
    return [torch.zeros(b, 2 * d), torch.zeros(b, d), torch.zeros(b, d),
            torch.zeros(d, d), torch.zeros(b, dtype=torch.int32)]


def _call(kind, args):
    if kind == "lstm":
        return rnn_kernels.lstm_step_fwd(*args, 0)
    return rnn_kernels.gru_step_fwd(*args, 0)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_step_wrappers_refuse_what_the_kernel_does_not_take(kind):
    before = (rnn_kernels.fused_lstm_cell.launches,
              rnn_kernels.fused_gru_output.launches)
    # misshapen: a weight of the wrong width, lengths of the wrong count
    args = _step_args(kind)
    args[3] = torch.zeros(8, 5)
    with pytest.raises(ValueError, match="is not"):
        _call(kind, args)
    args = _step_args(kind)
    args[4] = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="lens"):
        _call(kind, args)
    # on CUDA tensors: float64, a row not of unit stride, int64 lengths
    args = [_OnCuda(a) for a in _step_args(kind)]
    args[1] = _OnCuda(args[1].t.double())
    with pytest.raises(TypeError, match="float32"):
        _call(kind, args)
    args = [_OnCuda(a) for a in _step_args(kind)]
    args[2] = _OnCuda(torch.zeros(8, 3).t())
    with pytest.raises(ValueError, match="unit stride"):
        _call(kind, args)
    args = [_OnCuda(a) for a in _step_args(kind)]
    args[4] = _OnCuda(args[4].t.long())
    with pytest.raises(TypeError, match="int32"):
        _call(kind, args)
    # a CPU tensor takes the plain version, float64 too: no launch
    assert len(_call(kind, _step_args(kind))) == (4 if kind == "lstm"
                                                 else 2)
    double = [a.double() if a.is_floating_point() else a
              for a in _step_args(kind)]
    assert all(o.dtype == torch.float64 for o in _call(kind, double))
    assert (rnn_kernels.fused_lstm_cell.launches,
            rnn_kernels.fused_gru_output.launches) == before


# ---------------------------------------------------------------------------
# a CPU model of the step kernels' 3xTF32 product
# ---------------------------------------------------------------------------

def _tf32(x):
    """x rounded to TF32 as the kernels' split rounds (half away)."""
    u = (x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xffffe000)
    return u.view(np.float32)


def _mma(c, a, b):
    """c + a @ b, one m16n8k8: the products and their sum exact, then
    truncated to fp32 (the tensor cores' sum does not round to nearest;
    the lo halves are read to their top 19 bits)."""
    trunc = np.uint32(0xffffe000)
    a = a.view(np.uint32) & trunc
    b = b.view(np.uint32) & trunc
    exact = c.astype(np.float64) + a.view(np.float32).astype(np.float64) \
        @ b.view(np.float32).astype(np.float64)
    out = exact.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(exact)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


def _model_product(a, w, fresh, warps=8):
    """a [16, K] @ w [K, N] as the kernels run it: split 3xTF32, K split
    over `warps` (one k8 step each a chunk of 8 * warps rows), the warps'
    sums added in order."""
    ah, bh = _tf32(a), _tf32(w)
    al, bl = a - ah, w - bh
    sums = []
    for wp in range(warps):
        acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
        for k in range(8 * wp, a.shape[1], 8 * warps):
            s = slice(k, k + 8)
            part = np.zeros_like(acc) if fresh else acc
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                part = _mma(part, x[:, s], y[s])
            acc = (acc + part).astype(np.float32) if fresh else part
        sums.append(acc)
    total = sums[0]
    for part in sums[1:]:
        total = (total + part).astype(np.float32)
    return total


def test_step_product_model_is_as_accurate_as_fp32():
    # the kernels' tile (8 warps, one k8 step each a chunk) with fresh
    # accumulators, against one chain each over 16 k8 steps (4 warps):
    # mean errors against float64, beside torch's fp32 product's
    rng = np.random.RandomState(3)
    a = np.tanh(rng.standard_normal((16, 512))).astype(np.float32)
    w = f32(rng, 512, 64, scale=512 ** -0.5)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    fp32 = np.abs((torch.from_numpy(a) @ torch.from_numpy(w)).numpy()
                  - exact).mean()
    fresh = np.abs(_model_product(a, w, True) - exact).mean()
    chain = np.abs(_model_product(a, w, False, warps=4) - exact).mean()
    assert fresh <= fp32, (fresh, fp32)
    assert chain > 3 * fp32, (chain, fp32)
