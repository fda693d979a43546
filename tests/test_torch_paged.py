"""Paged decode attention in the port: the plain versions of K4
(``ops/paged_kernels.py::paged_attention``) and K5
(``ops/quant_kernels.py::paged_attention_quant``), which the wrappers run
on CPU tensors and which ``chip_smoke.py`` holds the CUDA kernel
(``csrc/paged_attention.cu``) against on the card, held to the JAX
package's ``_paged_attn_reference`` and its Pallas kernels in interpret
mode on the same seeded inputs: float32 at ``test_pallas_kernels.py``'s
case (a shared block, an empty slot; atol/rtol 2e-5, float32 einsums in
two frameworks), bf16 at its second case (2e-2, bf16 rounding of the
output), the int8 arm within 2e-5.  ``quantize_kv`` is byte for byte the
reference's.  The pool-fed int8 case of ``test_paged_kv.py`` runs on the
port's pool: within 0.05 of float32 attention over the original rows, the
empty slot exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import quant_kernels as jax_qk
from paddle_tpu.ops.pallas_kernels import (_paged_attention_call,
                                           _paged_attn_reference)
from paddle_tpu_torch.ops import cuda_build
from paddle_tpu_torch.ops import paged_kernels as pk
from paddle_tpu_torch.ops import quant_kernels as qk
from paddle_tpu_torch.serving.kv import KVBlockPool, PagedKVConfig


def _case(seed, s_, h, d, bs, mb, n, lengths, shared=True):
    rng = np.random.RandomState(seed)
    q = rng.randn(s_, h, d).astype(np.float32) * 0.5
    ka = rng.randn(n, bs, h, d).astype(np.float32) * 0.5
    va = rng.randn(n, bs, h, d).astype(np.float32)
    table = rng.randint(1, n, (s_, mb)).astype(np.int32)
    if shared:
        table[1, 0] = table[0, 0]
    return q, ka, va, table, np.asarray(lengths, np.int32)


FP32_CASE = dict(seed=0, s_=5, h=2, d=16, bs=4, mb=3, n=10,
                 lengths=[12, 9, 4, 1, 0])


@pytest.mark.parametrize("table_kind", ["numpy", "tensor"])
def test_paged_attention_fp32_matches_reference_and_pallas(table_kind):
    q, ka, va, table, lengths = _case(**FP32_CASE)
    scale = 1.0 / 16 ** 0.5
    args = [jnp.asarray(a) for a in (q, ka, va, table, lengths)]
    ref = np.asarray(_paged_attn_reference(*args, scale))
    pal = np.asarray(_paged_attention_call(*args, scale, interpret=True))
    if table_kind == "tensor":
        table, lengths = torch.from_numpy(table), torch.from_numpy(lengths)
    got = pk.paged_attention(torch.from_numpy(q), torch.from_numpy(ka),
                             va, table, lengths)
    assert got.dtype == torch.float32 and got.shape == (5, 2, 16)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), pal, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got.numpy()[4], 0.0)   # empty slot


def test_paged_attention_bf16_matches_reference():
    rng = np.random.RandomState(1)
    s_, h, d, bs, mb, n = 4, 2, 8, 4, 2, 7
    q = jnp.asarray(rng.randn(s_, h, d), jnp.bfloat16)
    ka = jnp.asarray(rng.randn(n, bs, h, d), jnp.bfloat16)
    va = jnp.asarray(rng.randn(n, bs, h, d), jnp.bfloat16)
    table = rng.randint(1, n, (s_, mb)).astype(np.int32)
    lengths = np.array([7, 5, 2, 8], np.int32)
    want = np.asarray(_paged_attn_reference(
        q, ka, va, jnp.asarray(table), jnp.asarray(lengths),
        1.0 / d ** 0.5), np.float32)

    def to_torch(a):
        return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()

    got = pk.paged_attention(to_torch(q), to_torch(ka), to_torch(va),
                             table, lengths, select=False, interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_quantize_kv_byte_equal_to_reference():
    rng = np.random.RandomState(2)
    for shape in [(6, 2, 4), (3, 5, 8, 16), (1, 1, 1)]:
        kv = rng.randn(*shape).astype(np.float32) * 3.0
        kv.reshape(-1)[0] = 0.0
        got = qk.quantize_kv(kv)
        want = jax_qk.quantize_kv(kv)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
    zeros = qk.quantize_kv(np.zeros((2, 2, 3), np.float32))
    assert (zeros[0] == 0).all() and (zeros[1] == np.float32(1e-12)).all()


def test_paged_attention_quant_matches_pallas_interpret():
    q, ka, va, table, lengths = _case(**FP32_CASE)
    (kq, ks), (vq, vs) = qk.quantize_kv(ka), qk.quantize_kv(va)
    want = np.asarray(jax_qk.paged_attention_quant(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks),
        jnp.asarray(vs), table, lengths, select=False, interpret=True))
    got = qk.paged_attention_quant(torch.from_numpy(q), kq, vq, ks, vs,
                                   table, lengths)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got.numpy()[4], 0.0)
    # the plain K5 is the plain K4 over the dequantized arena
    deq = pk.paged_attention(torch.from_numpy(q),
                             kq.astype(np.float32) * ks[..., None, None],
                             vq.astype(np.float32) * vs[..., None, None],
                             table, lengths)
    np.testing.assert_array_equal(got.numpy(), deq.numpy())


def test_pool_fed_int8_attention_within_bar_of_fp32():
    """PagedKVConfig(kv_dtype="int8") planes written through the port's
    pool feed paged_attention_quant within the int8 bar (0.05) of fp32
    paged attention over the original rows; the empty slot is 0."""
    h, d = 2, 4
    cfg = PagedKVConfig(block_size=4, num_blocks=9, cache_prefixes=False,
                        kv_dtype="int8")
    spec = cfg.kv_value_spec(h, d)
    assert spec["k"] == ((h, d), "int8")
    assert spec["k_scale"] == ((), "float32")
    cfg.value_spec.update(spec)
    pool = KVBlockPool(2, 4, cfg)
    rng = np.random.RandomState(0)
    n_tok = 6
    k_rows = rng.randn(n_tok, h, d).astype(np.float32)
    v_rows = rng.randn(n_tok, h, d).astype(np.float32)
    kq, ks = qk.quantize_kv(k_rows)
    vq, vs = qk.quantize_kv(v_rows)
    pool.admit(0, list(range(10, 10 + n_tok)),
               values={"k": kq, "k_scale": ks, "v": vq, "v_scale": vs})
    q = torch.from_numpy(rng.randn(2, h, d).astype(np.float32))
    lengths = np.array([n_tok, 0], np.int64)
    out_q = qk.paged_attention_quant(
        q, pool.arena("k"), pool.arena("v"), pool.arena("k_scale"),
        pool.arena("v_scale"), pool.table_view(), lengths,
        select=False, interpret=True).numpy()
    ref_pool = KVBlockPool(2, 4, PagedKVConfig(
        block_size=4, num_blocks=9, cache_prefixes=False,
        value_spec={"k": ((h, d), np.float32),
                    "v": ((h, d), np.float32)}))
    ref_pool.admit(0, list(range(10, 10 + n_tok)),
                   values={"k": k_rows, "v": v_rows})
    out_fp = pk.paged_attention(q, ref_pool.arena("k"), ref_pool.arena("v"),
                                ref_pool.table_view(), lengths).numpy()
    assert np.max(np.abs(out_q - out_fp)) < 0.05
    np.testing.assert_array_equal(out_q[1], 0.0)
    # and the fp32 arm equals the JAX reference over the same arenas
    want = np.asarray(_paged_attn_reference(
        jnp.asarray(q.numpy()), jnp.asarray(ref_pool.arena("k")),
        jnp.asarray(ref_pool.arena("v")), ref_pool.table_view(), lengths,
        1.0 / d ** 0.5))
    np.testing.assert_allclose(out_fp, want, rtol=2e-5, atol=2e-5)


def test_lengths_past_the_table_are_clamped_as_in_the_reference():
    """A length beyond MB * Bs attends over every table position, as the
    reference's mask does; an explicit scale is honoured."""
    q, ka, va, table, _ = _case(3, 3, 2, 8, 4, 2, 6, [0, 0, 0])
    lengths = np.array([100, 8, 3], np.int32)
    want = np.asarray(_paged_attn_reference(
        *(jnp.asarray(a) for a in (q, ka, va, table, lengths)), 0.3))
    got = pk.paged_attention(torch.from_numpy(q), ka, va, table, lengths,
                             scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_wrappers_check_operands():
    """Shapes that do not fit raise named errors before anything runs;
    the int8 and float arms refuse each other's arenas; a device other
    than the CPU or a CUDA card is refused."""
    q, ka, va, table, lengths = _case(**FP32_CASE)
    tq = torch.from_numpy(q)
    with pytest.raises(ValueError, match="arenas"):
        pk.paged_attention(tq, ka[..., :8], va, table, lengths)
    with pytest.raises(ValueError, match="block table"):
        pk.paged_attention(tq, ka, va, table[:2], lengths)
    with pytest.raises(ValueError, match=r"q \[S, H, D\]"):
        pk.paged_attention(q, ka, va, table, lengths)
    (kq, ks), (vq, vs) = qk.quantize_kv(ka), qk.quantize_kv(va)
    with pytest.raises(TypeError, match="int8 arenas"):
        qk.paged_attention_quant(tq, ka, va, ks, vs, table, lengths)
    with pytest.raises(ValueError, match="scale plane"):
        qk.paged_attention_quant(tq, kq, vq, ks[:, :2], vs, table, lengths)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pk.paged_attention(tq.to("meta"), ka, va, table, lengths)


def test_kernel_source_is_built_with_the_others():
    """csrc/paged_attention.cu is one of the sources the build compiles
    (one nvcc each, all started together), and nothing is built at
    import."""
    assert "paged_attention" in cuda_build.SOURCES
    assert pk.paged_attention.launches == 0
    assert qk.paged_attention_quant.launches == 0
    assert "paged_attention" not in cuda_build._LIBS
