"""The port's flash-attention forward (paddle_tpu_torch/ops/
attention_kernels.py) against the JAX package's: the Pallas kernel
``paddle_tpu.ops.pallas_kernels.flash_attention`` run in interpret mode
(select=False, 16-row blocks so T=32 walks two K tiles) and its composed
reference ``_attn_reference``, on the same numpy inputs.  On CPU tensors
the port's wrapper takes the plain version and never launches the CUDA
kernel.  Tolerance: atol 1e-5, float32."""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import attention_kernels as ak

ATOL = 1e-5


def _case(name, b=2, h=3, t=32, d=16, bias=None, causal=False):
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32)
               for _ in range(3))
    if bias == "row":
        bb = np.where(rng.rand(b, 1, 1, t) < 0.3, -1e4, 0.0)
    elif bias == "row1":
        bb = np.where(rng.rand(1, 1, 1, t) < 0.3, -1e4, 0.0)
    elif bias == "full":
        bb = rng.standard_normal((b, h, t, t))
    elif bias == "masked_row":
        # query row 3 of every head sees only -inf: the kernel gives 0
        bb = rng.standard_normal((b, h, t, t))
        bb[:, :, 3, :] = -np.inf
    else:
        bb = None
    bb = None if bb is None else bb.astype(np.float32)
    return q, k, v, bb, causal


CASES = {
    "no_bias": _case("no_bias"),
    "row_bias_b": _case("row_bias_b", bias="row"),
    "row_bias_1": _case("row_bias_1", bias="row1"),
    "full_bias": _case("full_bias", bias="full"),
    "causal": _case("causal", causal=True),
    "causal_row_bias": _case("causal_row_bias", bias="row", causal=True),
    "ragged_t24": _case("ragged_t24", t=24, bias="row"),
    "fully_masked_row": _case("fully_masked_row", bias="masked_row"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_flash_attention_matches_jax(name):
    q, k, v, bias, causal = CASES[name]
    scale = 1.0 / np.sqrt(q.shape[-1])
    ak.flash_attention.launches = 0
    tq, tk, tv, tb = (None if a is None else torch.from_numpy(a)
                      for a in (q, k, v, bias))
    got = ak.flash_attention(tq, tk, tv, bias=tb, causal=causal)
    plain = ak.flash_attention_reference(tq, tk, tv, tb, causal, scale)
    assert ak.flash_attention.launches == 0      # CPU: no kernel launch
    assert got.dtype == torch.float32 and got.shape == tq.shape
    np.testing.assert_array_equal(got.numpy(), plain.numpy())

    jb = None if bias is None else jnp.asarray(bias)
    pallas = np.asarray(pk.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jb,
        causal=causal, scale=scale, block_q=16, block_k=16,
        interpret=True, select=False))
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=0)
    if name == "fully_masked_row":
        assert np.all(got.numpy()[:, :, 3, :] == 0.0)
        return                      # the composed reference gives NaN there
    composed = np.asarray(pk._attn_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale, jb))
    np.testing.assert_allclose(got.numpy(), composed, atol=ATOL, rtol=0)


def test_port_flash_attention_never_falls_back_off_cpu():
    """On a device that is neither CPU nor CUDA the wrapper raises; it
    never computes the plain version there."""
    q = torch.empty(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ak.flash_attention(q, q, q)
    assert ak.flash_attention.launches == 0
