"""Head dims off BERT's 64 in the port's flash attention
(``paddle_tpu_torch/ops/attention_kernels.py``), on the CPU.

- The plain forward and the plain FlashAttention-2 backward (what a CPU
  tensor runs, and what the CUDA kernels are held to on the card) against
  the JAX package's Pallas kernels in interpret mode (select=False,
  16-row blocks, so T=32 walks two tiles) at head dims 8, 16, 80 and 256,
  with a row bias (and its grad), and causal with no bias.  Tolerances:
  atol 1e-5 forward, 2e-3 on the grads (the JAX package's own bar for its
  backward kernels, tests/test_pallas_kernels.py:92), float32.
- The head-dim rule of the kernels: every D from 1 to 256 maps onto an
  instantiated width (columns padded to whole 16-byte chunks); D 257 is
  padded the same way and accepted (it runs the wide arm), and only D 0
  raises.
- A model of the tensor-core forward's arithmetic
  (``csrc/flash_attention_fwd.cu``) in plain torch, after
  tests/test_torch_tf32_split.py: a tile-by-tile online softmax whose
  products take fp32 operands as TF32 parts (3xTF32: a_lo.b_hi +
  a_hi.b_lo + a_hi.b_hi) and sum each K/V tile's P.V in a fresh
  accumulator.  Against a float64 forward its out and lse stay within 10
  times the fp32 plain version's error (chip_smoke's bar on the card);
  one TF32 product a term misses that bar.  The kernels themselves run
  only on the card, where chip_smoke checks them.
"""

import functools
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import attention_kernels as ak

ATOL = 1e-5
GRAD_ATOL = 2e-3
FACTOR = 10.0   # chip_smoke.GRAD64_FACTOR
FLOOR = 1e-6    # chip_smoke.GRAD64_FLOOR, of the answer's largest entry
HEAD_DIMS = (8, 16, 80, 256)
KINDS = ("row", "causal")       # a row bias (and its grad); causal, no bias


def _rng(name):
    return np.random.RandomState(zlib.crc32(name.encode()))


def _case(d, kind, b=1, h=2, t=32):
    rng = _rng(f"widths_{d}_{kind}")
    q, k, v, cot = (rng.standard_normal((b, h, t, d)).astype(np.float32)
                    for _ in range(4))
    bias = None
    if kind == "row":
        bias = np.where(rng.rand(b, 1, 1, t) < 0.3, -1e4,
                        0.0).astype(np.float32)
    return q, k, v, bias, kind == "causal", cot


@functools.lru_cache(maxsize=None)
def _pallas(d, kind):
    """(out, grads) of the JAX package's flash attention on _case(d,
    kind) under its cotangent, the Pallas kernels in interpret mode (one
    run serves a case's forward and backward test)."""
    q, k, v, bias, causal, cot = _case(d, kind)
    scale = 1.0 / np.sqrt(d)

    def f(qq, kk, vv, *bb):
        return pk.flash_attention(qq, kk, vv, bias=bb[0] if bb else None,
                                  causal=causal, scale=scale, block_q=16,
                                  block_k=16, interpret=True, select=False)

    def out_and_grads(args, ct):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(ct)

    args = [jnp.asarray(a) for a in (q, k, v)]
    if bias is not None:
        args.append(jnp.asarray(bias))
    # jitted: eager interpret mode dispatches op by op and takes longer
    out, grads = jax.jit(out_and_grads)(args, jnp.asarray(cot))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_forward_matches_jax_pallas(d, kind):
    q, k, v, bias, causal, cot = _case(d, kind)
    scale = 1.0 / np.sqrt(d)
    tq, tk, tv, tb = (None if a is None else torch.from_numpy(a)
                      for a in (q, k, v, bias))
    ak.flash_attention.launches = 0
    got, lse = ak.flash_attention_fwd(tq, tk, tv, tb, causal, with_lse=True)
    assert ak.flash_attention.launches == 0      # CPU: no kernel launch
    assert got.shape == tq.shape and lse.shape == (1, 2, 32)
    want, _ = _pallas(d, kind)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if bias is None:        # the reference's lse entry takes no bias
        _, want_lse = pk.flash_attention_with_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
            16, 16, True)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_backward_matches_jax_pallas(d, kind):
    q, k, v, bias, causal, cot = _case(d, kind)
    want_out, want_grads = _pallas(d, kind)
    counters = (ak.flash_attention, ak.flash_attention_bwd_dkv,
                ak.flash_attention_bwd_dq)
    for c in counters:
        c.launches = 0
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)] + (
        [] if bias is None else [torch.from_numpy(bias).requires_grad_()])
    out = ak.flash_attention(*leaves[:3], bias=leaves[3] if bias is not None
                             else None, causal=causal)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    assert all(c.launches == 0 for c in counters)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=ATOL,
                               rtol=0)
    for g, w, what in zip(grads, want_grads, ("dq", "dk", "dv", "dbias")):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_head_dim_to_256_has_a_kernel_width(dtype):
    chunk = {torch.float32: 4, torch.bfloat16: 8}[dtype]
    # the widths the C entries dispatch over (csrc/flash_attention_mma.cuh)
    widths = ak.kernel_widths()
    assert list(widths) == sorted(set(widths))
    assert widths[-1] == 256
    assert all(w % 16 == 0 for w in widths)
    used = set()
    for d in range(1, widths[-1] + 1):
        dp = ak.padded_head_dim(d, dtype)
        # padded to a whole 16-byte chunk (what the C entries accept), at
        # most the widest instantiation
        assert dp % chunk == 0 and d <= dp < d + chunk, d
        assert dp <= widths[-1], d
        used.add(min(w for w in widths if w >= dp))
    assert used == set(widths)
    # above the widest width the wide arm takes the head dim, padded alike
    assert ak.padded_head_dim(257, dtype) == 256 + chunk
    with pytest.raises(ValueError, match="head dims of 1 and more, not 0"):
        ak.padded_head_dim(0, dtype)
    # the wrappers' check (it runs for CUDA tensors) accepts D 257
    q = torch.zeros(1, 1, 4, 257, dtype=dtype)
    assert ak._check(q, q, q, None) == 256 + chunk
    q33 = q[..., :33].contiguous()
    assert ak._check(q33, q33, q33, None) == ak.padded_head_dim(33, dtype)


def test_dense_pads_with_zero_columns_on_an_aligned_address():
    base = torch.arange(2 * 3 * 5 * 7 + 1, dtype=torch.float32)
    t = base[1:].reshape(2, 3, 5, 7)            # 4 bytes past an alignment
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    padded = ak._dense(t, 8)
    assert padded.shape == (2, 3, 5, 8) and padded.data_ptr() % 16 == 0
    assert torch.equal(padded[..., :7], t) and not padded[..., 7].any()
    whole = torch.arange(17, dtype=torch.float32)[1:].reshape(2, 8)
    assert whole.data_ptr() % 16 != 0
    moved = ak._dense(whole, 8)                 # copied to an aligned one
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, whole)
    assert ak._dense(padded, 8) is padded       # aligned, whole: as it is


# ---------------------------------------------------------------------------
# the tensor-core forward's arithmetic, modelled
# ---------------------------------------------------------------------------

def tf32_rna(x):
    """fp32 -> the nearest TF32 value, ties away from zero (the kernels'
    hi, two integer operations)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """What a TF32 tensor-core product reads of an fp32 register."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm(a, b, terms):
    """a @ b in fp32 from TF32 parts: 3 terms (the kernels' scheme, small
    ones first) or 1 (plain TF32)."""
    ah = tf32_rna(a)
    bh = tf32_rna(b)
    if terms == 1:
        return ah @ bh
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def forward_model(q, k, v, bias, causal, scale, terms, bn=64):
    """The kernel's forward over K/V tiles of `bn` rows: S = Q.K^T in
    TF32 parts, scale, bias and masks, the online softmax (running max
    m, per-row sum l of the undropped weights, rescale corr), and each
    tile's P.V in a fresh accumulator added to the rescaled one."""
    tq, tk = q.shape[-2], k.shape[-2]
    m = torch.full(q.shape[:-1], float("-inf"))
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    rows = torch.arange(tq)[:, None]
    for k0 in range(0, tk, bn):
        kt, vt = k[..., k0:k0 + bn, :], v[..., k0:k0 + bn, :]
        s = mm(q, kt.transpose(-1, -2), terms) * scale
        if bias is not None:
            s = s + bias[..., k0:k0 + bn]
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[-2])[None, :]
            s = s.masked_fill(cols > rows, float("-inf"))
        mn = torch.maximum(m, s.amax(dim=-1))
        ms = torch.where(mn == float("-inf"), torch.zeros_like(mn), mn)
        corr = torch.exp(m - ms)
        p = torch.exp(s - ms.unsqueeze(-1))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr.unsqueeze(-1) + mm(p, vt, terms)
        m = mn
    lc = l.clamp_min(1e-20)
    lse = torch.where(m == float("-inf"), m, m + torch.log(lc))
    return acc / lc.unsqueeze(-1), lse


# (name, B, H, T, D, bias, causal): BERT-base training's T, D and row
# bias; the ring's shard T, causal; the head dims 16 and 256
MODEL_CASES = {"bert_t128_row": (2, 2, 128, 64, "row", False),
               "shard_t512_causal": (1, 1, 512, 64, None, True),
               "d16_t128_row": (2, 2, 128, 16, "row", False),
               "d256_t128": (1, 2, 128, 256, None, False)}


@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_forward_model_against_float64(name, terms):
    b, h, t, d, bias_kind, causal = MODEL_CASES[name]
    r = _rng(name)
    q, k, v = (torch.from_numpy(r.standard_normal((b, h, t, d))
                                .astype(np.float32)) for _ in range(3))
    bias = None
    if bias_kind == "row":
        bias = torch.from_numpy(np.where(r.rand(b, 1, 1, t) < 0.3, -1e4,
                                         0.0).astype(np.float32))
    scale = d ** -0.5
    plain = ak.flash_attention_reference(q, k, v, bias, causal, scale,
                                         return_lse=True)
    exact = ak.flash_attention_reference(
        q.double(), k.double(), v.double(),
        None if bias is None else bias.double(), causal, scale,
        return_lse=True, dtype=torch.float64)
    got = forward_model(q, k, v, bias, causal, scale, terms)
    within = []
    for g, pl, ex in zip(got, plain, exact):
        assert ex.dtype == torch.float64 and pl.dtype == torch.float32
        e_k = (g.double() - ex).abs().max().item()
        e_p = (pl.double() - ex).abs().max().item()
        within.append(e_k <= max(FACTOR * e_p,
                                 FLOOR * ex.abs().max().item()))
    if terms == 3:
        assert all(within), within
    else:
        assert not any(within), within
