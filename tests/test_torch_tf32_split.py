"""The precision scheme of the port's FlashAttention-2 backward kernels
(``paddle_tpu_torch/csrc/flash_attention_bwd.cu``), modelled in plain
torch on the CPU: each fp32 operand x is split as hi = x rounded to TF32
(to nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and lo = the
residue x - hi, of which the tensor core reads the TF32 part (its low 13
bits dropped), and a product a·b is taken as a_hi·b_hi + a_hi·b_lo +
a_lo·b_hi summed in fp32 ("3xTF32").

Held against float64 on tiles of the shapes the kernels see (BERT-base
training: D 64, T 128; the ring's shard: T 512) made with numpy from a
seed, the 3-term product must stay within 10 times the error of an fp32
matmul of the same operands (the bar chip_smoke holds the kernels to on
the card, ``GRAD64_FACTOR``), and one TF32 product a term must miss that
bar.  The whole backward taken this way is held to the same bar against
the port's plain version computed in float64.  The kernels themselves
run only on the card, where chip_smoke checks them."""

import zlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import attention_kernels as ak

FACTOR = 10.0   # chip_smoke.GRAD64_FACTOR
FLOOR = 1e-6    # chip_smoke.GRAD64_FLOOR, of the answer's largest entry


def tf32_rna(x):
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: add half of the dropped 13 bits' weight to the magnitude, then
    drop them (the sign bit is untouched for finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """What a TF32 tensor-core product reads of an fp32 register: the
    top 19 bits, the low 13 dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def mm(a, b, terms):
    """a @ b in fp32 from TF32 parts: 3 terms (the kernels' scheme,
    small ones first) or 1 (plain TF32)."""
    ah, al = split(a)
    bh, bl = split(b)
    if terms == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def _rng(name):
    return np.random.RandomState(zlib.crc32(name.encode()))


def _softmax_rows(rng, m, n):
    s = rng.standard_normal((m, n))
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return p / p.sum(axis=1, keepdims=True)


# (name, a, b) in float32: the kernels' products at their shapes.  S^T =
# K·Qᵀ and dP^T = V·dOᵀ over D; dV = Pᵀ·dO and dK = dSᵀ·Q over the q
# rows; dQ = dS·K over the keys.
def _tiles():
    out = {}
    for tag, t in (("bert", 128), ("shard", 512)):
        r = _rng(tag)
        q = r.standard_normal((t, 64))
        k = r.standard_normal((64, 64))
        p = _softmax_rows(r, t, 64)                  # P of a key tile
        ds = p * (r.standard_normal((t, 64)) - 0.1)  # P·(dP - delta)
        out[f"{tag}_scores"] = (k, q.T)
        out[f"{tag}_dv"] = (p.T, r.standard_normal((t, 64)))
        out[f"{tag}_dk"] = (ds.T, q)
        out[f"{tag}_dq"] = (_softmax_rows(r, 64, t) * 0.5,
                            r.standard_normal((t, 64)))
    return {n: tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32))
                     for x in ab) for n, ab in out.items()}


TILES = _tiles()


def _errors(a, b, terms):
    exact = a.double() @ b.double()
    got = mm(a, b, terms).double()
    fp32 = (a @ b).double()
    return ((got - exact).abs().max().item(),
            (fp32 - exact).abs().max().item())


def test_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10                      # TF32's ulp at 1
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2),
                      1 + one_ulp / 2 - 2.0 ** -23, 1 + 3 * one_ulp / 2,
                      3.0e-3, 0.0], dtype=torch.float32)
    want = [1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp]
    got = tf32_rna(x)
    assert got[:4].tolist() == want
    assert got[5].item() == 0.0
    # 10 stored mantissa bits: the low 13 bits of every result are zero
    assert not (got.view(torch.int32) & 0x1FFF).any()


def test_split_keeps_x_to_2_pow_minus_21():
    x = torch.from_numpy(_rng("split").standard_normal(4096)
                         .astype(np.float32)) * 10.0
    hi, lo = split(x)
    # |x - hi| <= 2^-11 |x| and lo keeps 11 of its bits
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert (resid <= 2.0 ** -21 * x.double().abs()).all()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    # hi alone is only good to half a TF32 ulp
    assert ((x.double() - hi.double()).abs()
            <= 2.0 ** -11 * x.double().abs()).all()


@pytest.mark.parametrize("name", sorted(TILES))
def test_three_term_product_within_bar_of_fp32(name):
    err3, err32 = _errors(*TILES[name], terms=3)
    assert err3 <= FACTOR * err32, (name, err3, err32)


@pytest.mark.parametrize("name", sorted(TILES))
def test_one_term_tf32_product_misses_the_bar(name):
    err1, err32 = _errors(*TILES[name], terms=1)
    assert err1 > FACTOR * err32, (name, err1, err32)


def _backward_tf32(q, k, v, dout, lse, delta, scale, causal, terms):
    """The kernels' backward with every product in TF32 parts (no bias,
    no dropout), fp32 elsewhere: dq, dk, dv."""
    kt, vt = k.transpose(-1, -2), v.transpose(-1, -2)
    s = mm(q, kt, terms) * scale
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(),
                          float("-inf"))
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = mm(dout, vt, terms)
    ds = p * (dp - delta.unsqueeze(-1))
    dv = mm(p.transpose(-1, -2), dout, terms)
    dk = mm(ds.transpose(-1, -2), q, terms) * scale
    dq = mm(ds, k, terms) * scale
    return dq, dk, dv


# (name, B, H, T, D, causal): BERT-base training's T and D; the ring's
# shard T, causal as the step's diagonal shard
BACKWARD_CASES = {"bert_t128": (1, 2, 128, 64, False),
                  "shard_t512_causal": (1, 1, 512, 64, True)}


def _backward_case(name):
    b, h, t, d, causal = BACKWARD_CASES[name]
    r = _rng(name)
    q, k, v, dout = (torch.from_numpy(r.standard_normal((b, h, t, d))
                                      .astype(np.float32))
                     for _ in range(4))
    scale = d ** -0.5
    out, lse = ak.flash_attention_reference(q, k, v, None, causal, scale,
                                            return_lse=True)
    delta = ak.attention_delta(dout, out)
    return (q, k, v, dout, lse, delta), scale, causal


@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("name", sorted(BACKWARD_CASES))
def test_backward_in_tf32_parts_against_float64(name, terms):
    (q, k, v, dout, lse, delta), scale, causal = _backward_case(name)
    plain = ak._backward_plain(q, k, v, None, dout, lse, delta, causal,
                               scale, 0.0, 0)[:3]
    exact = ak._backward_plain(q.double(), k.double(), v.double(), None,
                               dout.double(), lse.double(), delta.double(),
                               causal, scale, 0.0, 0,
                               dtype=torch.float64)[:3]
    got = _backward_tf32(q, k, v, dout, lse, delta, scale, causal, terms)
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


def test_plain_backward_compute_dtype_defaults_to_fp32():
    (q, k, v, dout, lse, delta), scale, causal = _backward_case("bert_t128")
    base = ak._backward_plain(q, k, v, None, dout, lse, delta, causal,
                              scale, 0.1, 7)
    again = ak._backward_plain(q, k, v, None, dout, lse, delta, causal,
                               scale, 0.1, 7, dtype=torch.float32)
    wide = ak._backward_plain(q.double(), k.double(), v.double(), None,
                              dout.double(), lse.double(), delta.double(),
                              causal, scale, 0.1, 7, dtype=torch.float64)
    for a, b, w in zip(base, again, wide):
        assert torch.equal(a, b)
        assert w.dtype == torch.float64
        # the same dropout bits, the same function: fp32 rounding apart
        assert (a.double() - w).abs().max().item() < 1e-4
