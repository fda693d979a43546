"""The port's flash attention (paddle_tpu_torch/ops/attention_kernels.py)
against the JAX package's: the Pallas kernels of
``paddle_tpu.ops.pallas_kernels.flash_attention`` run in interpret mode
(select=False) and the composed reference ``_attn_reference``, on the
same numpy inputs — the forward (16-row blocks so T=32 walks two K
tiles), and below the lse, the FlashAttention-2 backward and dropout.
On CPU tensors the port's wrappers take the plain versions and never
launch a CUDA kernel.  Tolerance: atol 1e-5 on the forward, float32."""

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
    """On a device that is neither CPU nor CUDA the wrappers raise; they
    never compute the plain version there."""
    q = torch.empty(1, 1, 4, 64, device="meta")
    row = torch.empty(1, 1, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ak.flash_attention(q, q, q)
    for bwd in (ak.flash_attention_bwd_dkv, ak.flash_attention_bwd_dq):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            bwd(q, q, q, None, q, row, row)
    with pytest.raises(ValueError, match="dropout_p"):
        ak.flash_attention(torch.ones(1, 1, 4, 8), torch.ones(1, 1, 4, 8),
                           torch.ones(1, 1, 4, 8), dropout_p=1.0)
    assert ak.flash_attention.launches == 0


# ---------------------------------------------------------------------------
# The training arms: lse, the FlashAttention-2 backward and dropout.  The
# JAX side runs its own K1/K2a/K2b Pallas kernels in interpret mode
# (select=False), as tests/test_pallas_kernels.py does; b=2, h=2, T=128,
# D=64, float32.  Tolerance: atol 2e-3 on the grads (the JAX package's
# own bar, tests/test_pallas_kernels.py:92), atol 1e-5 on out and lse.
# ---------------------------------------------------------------------------

GRAD_ATOL = 2e-3
BWD_CASES = {
    "no_bias": _case("bwd_no_bias", b=2, h=2, t=128, d=64),
    "row_bias_b": _case("bwd_row_bias_b", b=2, h=2, t=128, d=64,
                        bias="row"),
    "row_bias_1": _case("bwd_row_bias_1", b=2, h=2, t=128, d=64,
                        bias="row1"),
    "full_bias": _case("bwd_full_bias", b=2, h=2, t=128, d=64,
                       bias="full"),
    "causal": _case("bwd_causal", b=2, h=2, t=128, d=64, causal=True),
    "fully_masked_row": _case("bwd_masked_row", b=2, h=2, t=128, d=64,
                              bias="masked_row"),
}


def _jax_vjp(q, k, v, bias, causal, scale, cot):
    import jax

    def f(qq, kk, vv, *bb):
        return pk.flash_attention(qq, kk, vv, bias=bb[0] if bb else None,
                                  causal=causal, scale=scale,
                                  interpret=True, select=False)

    args = [jnp.asarray(a) for a in (q, k, v)]
    if bias is not None:
        args.append(jnp.asarray(bias))
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(cot))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_port_flash_backward_matches_jax_pallas(name):
    q, k, v, bias, causal = BWD_CASES[name]
    scale = 1.0 / np.sqrt(q.shape[-1])
    cot = np.random.RandomState(zlib.crc32(name.encode())) \
        .standard_normal(q.shape).astype(np.float32)
    want_out, want_grads = _jax_vjp(q, k, v, bias, causal, scale, cot)

    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    out, lse = ak.flash_attention_reference(tq, tk, tv, tb, causal, scale,
                                            return_lse=True)
    assert lse.shape == (2, 2, 128) and lse.dtype == torch.float32
    got = ak.flash_attention_backward_reference(
        tq, tk, tv, tb, out, lse, torch.from_numpy(cot), causal, scale)
    np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL, rtol=0)
    for g, w, what in zip(got, want_grads, ["dq", "dk", "dv", "dbias"]):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=what)
    if name == "fully_masked_row":
        assert torch.isneginf(lse[:, :, 3]).all()
        assert np.all(got[0].numpy()[:, :, 3] == 0.0)
        assert np.all(got[3].numpy()[:, :, 3] == 0.0)

    # the differentiable wrapper on CPU tensors: the same plain backward
    # through the wrappers of K2a and K2b, and no kernel launch
    counters = (ak.flash_attention, ak.flash_attention_bwd_dkv,
                ak.flash_attention_bwd_dq)
    for c in counters:
        c.launches = 0
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)] + (
        [] if tb is None else [tb.clone().requires_grad_()])
    o = ak.flash_attention(*leaves[:3], bias=leaves[3] if tb is not None
                           else None, causal=causal, scale=scale)
    auto = torch.autograd.grad(o, leaves, torch.from_numpy(cot))
    assert all(c.launches == 0 for c in counters)
    np.testing.assert_array_equal(o.detach().numpy(), out.numpy())
    for a, g in zip(auto, got):
        np.testing.assert_array_equal(a.numpy(), g.numpy())


@pytest.mark.parametrize("causal", [False, True])
def test_port_lse_matches_jax_flash_attention_with_lse(causal):
    q, k, v, _, _ = _case(f"lse_{causal}", b=2, h=2, t=128, d=64)
    scale = 1.0 / 8.0
    want_out, want_lse = pk.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale, 128,
        128, True)
    out, lse = ak.flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), None, causal, scale,
        return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=ATOL, rtol=0)


def test_philox_known_answers():
    """Random123's Philox4x32-10 known-answer vectors."""
    from paddle_tpu_torch.ops.registry import philox4x32

    def words(ctr, key):
        t = torch.tensor(ctr, dtype=torch.int64).reshape(4, 1)
        return [int(w) for w in philox4x32(t, key).flatten()]

    assert words([0] * 4, (0, 0)) == [
        0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]
    assert words([0xffffffff] * 4, (0xffffffff, 0xffffffff)) == [
        0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]


def test_attention_dropout_mask_statistics():
    """Over 4·128·128 draws at p=0.1 the keep rate is within 0.006 of 0.9
    (five standard deviations); one seed gives one mask, another seed
    another."""
    m = ak.philox_keep_mask(1234, 4, 128, 128, 0.1)
    assert m.shape == (4, 128, 128) and m.dtype == torch.bool
    assert abs(m.float().mean().item() - 0.9) < 0.006
    assert torch.equal(m, ak.philox_keep_mask(1234, 4, 128, 128, 0.1))
    assert not torch.equal(m, ak.philox_keep_mask(1235, 4, 128, 128, 0.1))
    # the threshold rule of the reference's _keep_threshold
    from paddle_tpu_torch.ops.registry import keep_threshold

    assert keep_threshold(0.1) == int(pk._keep_threshold(0.1))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_dropped_backward_equals_autograd_of_dropped_forward(causal):
    """With dropout, the explicit FlashAttention-2 backward under the same
    Philox mask is the gradient of the dropped forward (atol 1e-5)."""
    q, k, v, bias, _ = _case(f"dropped_{causal}", b=2, h=2, t=64, d=16,
                             bias="row")
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out, lse = ak.flash_attention_reference(
        *leaves, causal=causal, dropout_p=0.2, seed=99, return_lse=True)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    auto = torch.autograd.grad(out, leaves, cot)
    got = ak.flash_attention_backward_reference(
        *(t.detach() for t in leaves), out.detach(), lse.detach(), cot,
        causal, dropout_p=0.2, seed=99)
    for a, g, what in zip(auto, got, ["dq", "dk", "dv", "dbias"]):
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=1e-5, rtol=0,
                                   err_msg=what)
    # dropout moved the output away from the undropped attention
    plain = ak.flash_attention_reference(*(t.detach() for t in leaves),
                                         causal=causal)
    assert not torch.allclose(out.detach(), plain)
