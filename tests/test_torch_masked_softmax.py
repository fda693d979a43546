"""A float32 model of K7's arithmetic (``csrc/masked_softmax.cu``)
against the JAX package's masked softmax and the port's plain version,
on the CPU.

K7 cannot run here, so its summation order is modelled in numpy float32
and held to the reference:

- T <= 64, a warp a row: lane l holds elements l and l + 32, sums its
  exponentials in that order, and the lanes' sums meet in a butterfly of
  shuffles (offsets 16, 8, 4, 2, 1, each lane adding its partner's
  value);
- T > 64, a CTA a row: the row is cut into W-wide vectors (W = 4 from
  T 1025 where T, the row stride and the base address allow 16-byte
  loads, else 1), and thread i of the CTA's 128, 256, 512 or 1024 (up
  to 128, 512, 1024 vectors, above) holds vectors i, i + threads, ...
  (two at most up to 2048 vectors, in registers; more in shared memory),
  sums in order, the butterfly within each warp, then the warps' sums
  added in warp order.

The max is exact in any order.  Each output is p / max(sum, 1e-20) with
p = exp(x - max) at the valid positions t < length and 0 elsewhere.  At
T in {1, 31, 64, 128, 300, 1000, 1025, 4096, 8320}, rows of lengths 0,
1 and T, inputs up to +-80: within 1e-5 of ``pk.masked_softmax`` in
interpret mode (it composes in XLA where T % 128 != 0, as the JAX
function does) and of the port's plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import sequence_kernels

F32 = np.float32
FLT_MAX = np.finfo(F32).max
WARP_ROW_MAX, VEC_ROW_MIN = 64, 1025
ATOL = 1e-5


def row_threads(vectors):
    """The CTA size of the CTA arm at a row of `vectors` W-wide vectors."""
    return 128 if vectors <= 128 else 256 if vectors <= 512 else \
        512 if vectors <= 1024 else 1024


def _butterfly(s):
    """The xor-shuffle tree over the 32 lanes of `s`: every lane ends
    with the same float32 sum."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = (s + s[lanes ^ o]).astype(F32)
    return s


def _kernel_row(x, n, w):
    """One row of K7: x float32 [T], length n, vector width w."""
    t = x.shape[0]
    valid = np.arange(t) < min(n, t)
    mx = np.max(np.where(valid, x, -FLT_MAX)).astype(F32)
    with np.errstate(over="ignore"):
        p = np.where(valid, np.exp((x - mx).astype(F32)), F32(0)).astype(F32)
    owners = 32 if t <= WARP_ROW_MAX else row_threads(t // w)
    chunk = owners * w
    rounds = -(-t // chunk)
    # [round, owner, k]: owner o holds vectors o, o + owners, ... in order
    held = np.zeros(rounds * chunk, F32)
    held[:t] = p
    held = held.reshape(rounds, owners, w)
    partial = np.zeros(owners, F32)
    for r in range(rounds):
        for k in range(w):
            partial = (partial + held[r, :, k]).astype(F32)
    if t <= WARP_ROW_MAX:
        total = _butterfly(partial)[0]
    else:
        warps = [_butterfly(partial[32 * i:32 * (i + 1)])[0]
                 for i in range(owners // 32)]
        total = warps[0]
        for s in warps[1:]:
            total = F32(total + s)
    return (p / np.maximum(total, F32(1e-20))).astype(F32)


def kernel_model(x, lens, w):
    return np.stack([_kernel_row(row, int(n), w) for row, n in zip(x, lens)])


CASES = [(t, w) for t in (1, 31, 64, 128, 300, 1000, 1025, 4096, 8320)
         for w in ((1, 4) if t >= VEC_ROW_MIN and t % 4 == 0 else (1,))]


@pytest.mark.parametrize("t,w", CASES, ids=[f"t{t}_w{w}" for t, w in CASES])
def test_kernel_order_matches_jax_and_plain(t, w):
    rng = np.random.RandomState(t + w)
    x = rng.uniform(-80, 80, (4, t)).astype(F32)
    lens = np.array([0, 1, t, max(1, t // 3)], np.int32)
    got = kernel_model(x, lens, w)
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(F32)
    want = np.asarray(pk.masked_softmax(jnp.asarray(x), jnp.asarray(mask),
                                        interpret=True))
    plain = sequence_kernels.masked_softmax(
        torch.from_numpy(x), torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL)
    assert not got[0].any()                   # the empty row is all 0
    assert got[1, 0] == 1 and not got[1, 1:].any()
    np.testing.assert_allclose(got[2:].sum(axis=1), 1, rtol=0, atol=1e-5)


def test_butterfly_is_not_a_sequential_sum():
    """The model is of the kernel's order, not numpy's: on values of mixed
    magnitude the butterfly and a left-to-right float32 sum differ."""
    s = np.array([1e8, 1.0, -1e8, 3.0] * 8, F32)
    seq = F32(0)
    for v in s:
        seq = F32(seq + v)
    tree = _butterfly(s)
    assert np.all(tree == tree[0]) and tree[0] != seq
