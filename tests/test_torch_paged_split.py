"""K5's split-KV kernel (``csrc/paged_attention.cu::
paged_attention_split_kernel``) on the CPU: its split plan
(``ops/paged_kernels.py::split_plan``) and a float32 model of its
arithmetic, written here in torch, held against the JAX package's
``_paged_attn_quant_reference`` and its Pallas kernel in interpret mode on
the same seeded int8 arenas (atol/rtol 2e-5, the kernel's bar against its
plain version on the card).

The model does what the kernel does, in its order of merges: the slot's
chain cut into the plan's splits of ``blocks`` blocks, each walked a tile
(a block, or 16 positions of a larger one) at a time; for each head the
tile's max over its tokens' scores and one rescale of (m, l, acc) per
tile; the K scale applied to the dot of the int8 row with the pre-scaled
q, the V scale folded into the token's weight; then the splits merged (an
empty split's state is m = -inf, l = 0).  A block id outside [0, N)
contributes nothing.  (The kernel adds a tile's tokens in several lanes
of a warp before it adds the lanes; the model adds them in token order:
float32 rounding apart, the same sums.)  The kernel
itself runs only on the card (``chip_smoke.py``'s ``paged_kernel_phase``
holds it against the plain version within 2e-5).
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import quant_kernels as jax_qk
from paddle_tpu_torch.ops import paged_kernels as pk
from paddle_tpu_torch.ops import quant_kernels as qk

ATOL = 2e-5
NEG = float("-inf")


def _merge(m, l, acc):
    """Merge online-softmax states stacked on dim 0: m, l [n, G], acc
    [n, G, D] -> (M, L, A); a state with m = -inf weighs 0."""
    mx = m.max(0).values
    w = torch.where(m == NEG, torch.zeros_like(m), torch.exp(m - mx))
    return mx, (l * w).sum(0), (acc * w[..., None]).sum(0)


def split_model(q, k8, v8, ks, vs, table, lengths, scale, plan=None):
    """The split kernel's arithmetic in float32 (see the module
    docstring); `plan` defaults to the wrapper's own split_plan."""
    s_, h, d = q.shape
    n, bs = k8.shape[:2]
    mb = table.shape[1]
    p = plan or pk.split_plan(s_, h, d, bs, mb)
    tpb = -(-bs // p.tile)
    kf, vf = k8.float(), v8.float()
    out = torch.zeros(s_, h, d)
    for s in range(s_):
        length = min(max(int(lengths[s]), 0), mb * bs)
        for g in range(p.groups):
            heads = slice(g * p.heads, min(h, (g + 1) * p.heads))
            qs = q[s, heads].float() * scale                  # [G, D]
            gv = qs.shape[0]
            parts = []
            for split in range(p.splits):
                m = torch.full((gv,), NEG)
                l = torch.zeros(gv)
                acc = torch.zeros(gv, d)
                for b in range(split * p.blocks,
                               min(mb, (split + 1) * p.blocks)):
                    for piece in range(tpb):
                        tok0 = piece * p.tile
                        start = b * bs + tok0
                        if start >= length:
                            break
                        blk = int(table[s, b])
                        if not 0 <= blk < n:
                            continue
                        pos = list(range(tok0, tok0 + min(
                            p.tile, bs - tok0, length - start)))
                        dot = torch.einsum("gd,tgd->tg", qs,
                                           kf[blk, pos, heads])
                        sc = ks[blk, pos][:, None] * dot          # [t, G]
                        m_new = torch.maximum(m, sc.max(0).values)
                        corr = torch.exp(m - m_new)
                        pr = torch.exp(sc - m_new)
                        w = pr * vs[blk, pos][:, None]
                        l = l * corr + pr.sum(0)
                        acc = acc * corr[:, None] + torch.einsum(
                            "tg,tgd->gd", w, vf[blk, pos, heads])
                        m = m_new
                parts.append((m, l, acc))
            mx, den, a = _merge(*(torch.stack(x) for x in zip(*parts)))
            out[s, heads] = a / torch.clamp_min(den, 1e-20)[:, None]
    return out


def _case(seed, s_, h, d, bs, mb, n, lengths, shared=True):
    rng = np.random.RandomState(seed)
    q = rng.randn(s_, h, d).astype(np.float32) * 0.5
    kf = rng.randn(n, bs, h, d).astype(np.float32) * 0.5
    vf = rng.randn(n, bs, h, d).astype(np.float32)
    table = rng.randint(1, n, (s_, mb)).astype(np.int32)
    if shared:
        table[1, 0] = table[0, 0]
    (k8, ks), (v8, vs) = qk.quantize_kv(kf), qk.quantize_kv(vf)
    return q, k8, v8, ks, vs, table, np.asarray(lengths, np.int32)


def _model(args, plan=None):
    q, k8, v8, ks, vs, table, lengths = args
    return split_model(torch.from_numpy(q), torch.from_numpy(k8),
                       torch.from_numpy(v8), torch.from_numpy(ks),
                       torch.from_numpy(vs), table, lengths,
                       1.0 / q.shape[-1] ** 0.5, plan).numpy()


def _jax(args, pallas):
    q, k8, v8, ks, vs, table, lengths = args
    ja = [jnp.asarray(a) for a in args]
    if pallas:
        return np.asarray(jax_qk.paged_attention_quant(
            *ja, select=False, interpret=True))
    return np.asarray(jax_qk._paged_attn_quant_reference(
        *ja, 1.0 / q.shape[-1] ** 0.5))


# (seed, S, H, D, Bs, MB, N, lengths): lengths 0, 1, one block, one block
# and a token, the whole table; the table's first block shared by slots 0
# and 1 (its "shared" case)
EDGE_CASES = {
    "d64_bs16": (0, 5, 2, 64, 16, 4, 12, [0, 1, 16, 17, 64]),
    "d128_bs16": (1, 5, 2, 128, 16, 3, 10, [17, 16, 0, 1, 48]),
    "d4_bs4": (2, 5, 3, 4, 4, 5, 14, [1, 4, 0, 5, 20]),
    "d100_bs5": (3, 5, 3, 100, 5, 4, 11, [6, 5, 1, 0, 20]),
    "d256_bs5": (4, 4, 2, 256, 5, 3, 9, [15, 1, 5, 0]),
}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_split_model_matches_reference_and_pallas(name):
    """The model against the JAX reference and the Pallas kernel in
    interpret mode at every head dim and block size of the cases; empty
    slots exactly 0.  The plan cuts each slot's chain into one split a
    block, so lengths of one block leave the trailing splits empty."""
    args = _case(*EDGE_CASES[name])
    s_, h, d = args[0].shape
    plan = pk.split_plan(s_, h, d, args[1].shape[1], args[5].shape[1])
    assert plan.splits == args[5].shape[1] and plan.blocks == 1
    got = _model(args)
    np.testing.assert_allclose(got, _jax(args, pallas=False), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, _jax(args, pallas=True), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got[args[6] == 0], 0.0)


def test_split_model_with_uneven_splits_matches_reference():
    """Enough slots that the plan puts three blocks in a split, with MB
    not a multiple of three: the last split holds one block; lengths
    spread from 0 to the whole table, so some slots' trailing splits are
    empty."""
    s_, mb = 30, 22
    rng = np.random.RandomState(5)
    lengths = rng.randint(0, mb * 16 + 1, s_)
    lengths[:4] = [0, 1, 16, mb * 16]
    args = _case(6, s_, 8, 128, 16, mb, 40, lengths)
    plan = pk.split_plan(s_, 8, 128, 16, mb)
    assert plan.blocks == 3 and plan.splits == 8 and mb % plan.blocks
    got = _model(args)
    np.testing.assert_allclose(got, _jax(args, pallas=False), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got[0], 0.0)


@pytest.mark.parametrize("blocks", [1, 2, 3, 7])
def test_split_model_does_not_depend_on_the_cut(blocks):
    """Any cut of the chain (blocks a split) and any tile give the
    reference's answer: the merges are exact up to float32 rounding."""
    args = _case(7, 3, 4, 64, 5, 7, 15, [35, 12, 1])
    base = pk.split_plan(3, 4, 64, 5, 7)
    plan = base._replace(blocks=blocks, splits=-(-7 // blocks),
                         tile=min(5, blocks + 1))
    np.testing.assert_allclose(_model(args, plan),
                               _jax(args, pallas=False), rtol=ATOL,
                               atol=ATOL)


def test_split_model_skips_block_ids_outside_the_arena():
    """A block id outside [0, N) contributes nothing: the same answer as
    the reference over a table whose bad block is masked out by a length
    that ends before it."""
    args = _case(8, 2, 2, 64, 4, 3, 9, [12, 8], shared=False)
    q, k8, v8, ks, vs, table, lengths = args
    bad = table.copy()
    bad[0, 2] = 9            # N: outside the arena
    bad[1, 2] = -1
    got = _model((q, k8, v8, ks, vs, bad, lengths))
    want = _model((q, k8, v8, ks, vs, table, np.array([8, 8], np.int32)))
    np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)


def test_split_model_clamps_lengths_past_the_table():
    args = _case(9, 2, 2, 16, 4, 2, 6, [100, -3])
    got = _model(args)
    np.testing.assert_allclose(got[0], _jax(args[:6] + (
        np.array([8, 0], np.int32),), pallas=False)[0], rtol=ATOL, atol=ATOL)
    np.testing.assert_array_equal(got[1], 0.0)


def _smem_bytes(p, d):
    """The kernel's dynamic shared memory for plan `p` (split_params in
    csrc/paged_attention.cu): a ring of 2 tiles, or the merge's weights,
    whichever is larger."""
    dp = -(-d // 16) * 16
    stage = 2 * p.tile * p.heads * dp + (-(-(8 * p.tile) // 16)) * 16
    return max(2 * stage, 4 * p.heads * p.splits)


SHAPES = [(s_, h, d, bs, mb)
          for s_ in (1, 3, 8, 64, 1000, 100000)
          for h in (1, 3, 8, 12, 64)
          for d in (1, 4, 17, 64, 100, 128, 256)
          for bs in (1, 5, 16, 64)
          for mb in (1, 4, 16, 256, 4096)]


def test_split_plan_covers_every_block_once_within_launch_limits():
    """Every block of [0, MB) in exactly one split and no split empty; the
    most splits that keep S * groups * splits within SPLIT_CTAS (one wave
    of two CTAs an SM), at least one; the grid within CUDA's 2^31 - 1;
    every group within 1024 padded bytes and 8 warps, tiles within 16
    positions, shared memory within 226 KB (227 KB less the static)."""
    for s_, h, d, bs, mb in SHAPES:
        p = pk.split_plan(s_, h, d, bs, mb)
        owner = np.full(mb, -1)
        for j in range(p.splits):
            blocks = range(j * p.blocks, min(mb, (j + 1) * p.blocks))
            assert len(blocks) > 0
            assert (owner[blocks.start:blocks.stop] == -1).all()
            owner[blocks.start:blocks.stop] = j
        assert (owner >= 0).all()
        assert p.groups == -(-h // p.heads)
        rows = s_ * p.groups
        assert rows * p.splits <= max(rows, pk.SPLIT_CTAS)
        if p.blocks > 1:      # one more split would overfill the wave
            assert rows * -(-mb // (p.blocks - 1)) > pk.SPLIT_CTAS
        assert rows * p.splits <= 2 ** 31 - 1
        assert p.heads * (-(-d // 16) * 16) <= pk.SPLIT_GROUP_BYTES
        assert p.heads <= pk.SPLIT_WARPS
        assert 1 <= p.tile <= min(bs, pk.SPLIT_TILE)
        assert _smem_bytes(p, d) <= 226 * 1024


def test_split_plan_reads_shapes_only():
    """The plan is a function of the shapes: nothing of the lengths
    reaches it (the wrapper never reads them to the host)."""
    assert list(inspect.signature(pk.split_plan).parameters) == \
        ["s", "h", "d", "bs", "mb"]
    assert pk.split_plan(64, 8, 128, 16, 16) == pk.SplitPlan(
        heads=8, groups=1, tile=16, splits=4, blocks=4)
    assert pk.split_plan(8, 8, 128, 16, 256).splits == 32


def test_cpu_quant_call_takes_the_plain_version_and_counts_nothing():
    """On CPU tensors the wrapper runs its plain version and launches
    nothing: its counter stays 0."""
    args = _case(10, 3, 2, 64, 16, 2, 6, [20, 0, 32])
    before = qk.paged_attention_quant.launches
    got = qk.paged_attention_quant(torch.from_numpy(args[0]), *args[1:])
    assert qk.paged_attention_quant.launches == before == 0
    np.testing.assert_allclose(got.numpy(), _model(args), rtol=ATOL,
                               atol=ATOL)
    assert math.isfinite(float(got.abs().max()))
