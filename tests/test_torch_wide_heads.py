"""Head dims above 256 in the port's attention (the kernels' wide arm), on
the CPU, against the JAX package, which takes any head dim as a block's
last dimension.

- The port's ``flash_attention`` forward and its grads (q, k, v and a row
  bias; the plain versions, what a CPU tensor runs and what chip_smoke
  holds the CUDA kernels' wide arm to on the card) against the JAX
  package's ``flash_attention(..., select=False, interpret=True)`` and
  its vjp at D 320 and D 300 (B 1, H 2, T 128: one 128-row block, so the
  Pallas kernels run one grid step a head).  Tolerances: atol 1e-5
  forward (float32 in two frameworks, the sums in other orders), 2e-3 on
  the grads (the JAX package's own bar for its backward kernels,
  tests/test_pallas_kernels.py:92).
- The head-dim rule: every D from 257 to 1024 pads to a whole 16-byte
  chunk and runs ceil(D / 256) column groups; the wrappers' check
  accepts it.
- ``paged_attention`` and ``paged_attention_quant`` at D 320 against the
  JAX package's Pallas kernels in interpret mode (atol/rtol 2e-5, as
  tests/test_torch_paged.py), the empty slot exactly 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as jpk
from paddle_tpu.ops import quant_kernels as jqk
from paddle_tpu_torch.ops import attention_kernels as ak
from paddle_tpu_torch.ops import paged_kernels as pk
from paddle_tpu_torch.ops import quant_kernels as qk

ATOL = 1e-5
GRAD_ATOL = 2e-3
WIDE_DIMS = (320, 300)


def _case(d, b=1, h=2, t=128):
    rng = np.random.RandomState(1000 + d)
    q, k, v, cot = (rng.standard_normal((b, h, t, d)).astype(np.float32)
                    for _ in range(4))
    bias = np.where(rng.rand(b, 1, 1, t) < 0.3, -1e4, 0.0).astype(
        np.float32)
    return q, k, v, bias, cot


@functools.lru_cache(maxsize=None)
def _pallas(d):
    """(out, [dq, dk, dv, dbias]) of the JAX package's flash attention on
    _case(d) under its cotangent, the Pallas kernels in interpret mode."""
    q, k, v, bias, cot = _case(d)

    def f(qq, kk, vv, bb):
        return jpk.flash_attention(qq, kk, vv, bias=bb, scale=d ** -0.5,
                                   interpret=True, select=False)

    def out_and_grads(args, ct):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(ct)

    out, grads = jax.jit(out_and_grads)(
        [jnp.asarray(a) for a in (q, k, v, bias)], jnp.asarray(cot))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_plain_forward_and_grads_match_jax_pallas(d):
    q, k, v, bias, cot = _case(d)
    counters = (ak.flash_attention, ak.flash_attention_bwd_dkv,
                ak.flash_attention_bwd_dq)
    for c in counters:
        c.launches = 0
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = ak.flash_attention(*leaves[:3], bias=leaves[3])
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    assert all(c.launches == 0 for c in counters)    # CPU: no kernel
    want_out, want_grads = _pallas(d)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=ATOL,
                               rtol=0)
    for g, w, what in zip(grads, want_grads, ("dq", "dk", "dv", "dbias")):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dims_above_256_pad_and_run_in_column_groups(dtype):
    chunk = {torch.float32: 4, torch.bfloat16: 8}[dtype]
    widest = ak.kernel_widths()[-1]
    groups = set()
    for d in range(widest + 1, 1025):
        dp = ak.padded_head_dim(d, dtype)
        assert dp % chunk == 0 and d <= dp < d + chunk, d
        groups.add(-(-dp // 256))
    assert groups == {2, 3, 4}
    # the wrappers' check (it runs for CUDA tensors) takes them: 300 is
    # no whole bf16 chunk, so bf16 pads it
    q = torch.zeros(1, 1, 4, 300, dtype=dtype)
    assert ak._check(q, q, q, None) == ak.padded_head_dim(300, dtype)


def _paged_case(d=320, s_=4, h=2, bs=4, mb=3, n=9, lengths=(12, 5, 0, 1)):
    rng = np.random.RandomState(d)
    q = rng.randn(s_, h, d).astype(np.float32) * 0.5
    ka = rng.randn(n, bs, h, d).astype(np.float32) * 0.5
    va = rng.randn(n, bs, h, d).astype(np.float32)
    table = rng.randint(1, n, (s_, mb)).astype(np.int32)
    return q, ka, va, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_d320_matches_jax_pallas(quant):
    q, ka, va, table, lengths = _paged_case()
    pk.paged_attention.launches = qk.paged_attention_quant.launches = 0
    if quant:
        (kq, ks), (vq, vs) = qk.quantize_kv(ka), qk.quantize_kv(va)
        want = jqk.paged_attention_quant(
            *(jnp.asarray(a) for a in (q, kq, vq, ks, vs)), table, lengths,
            select=False, interpret=True)
        got = qk.paged_attention_quant(torch.from_numpy(q), kq, vq, ks, vs,
                                       table, lengths)
    else:
        want = jpk.paged_attention(
            *(jnp.asarray(a) for a in (q, ka, va)), table, lengths,
            select=False, interpret=True)
        got = pk.paged_attention(torch.from_numpy(q), ka, va, table,
                                 lengths)
    assert pk.paged_attention.launches == qk.paged_attention_quant.launches \
        == 0
    assert got.shape == (4, 2, 320)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(got.numpy()[2], 0.0)      # empty slot
