"""K11's host entry (``sparse.gather.gather_rows_to_host``) and the shard
lookup that uses it, against the JAX package on the CPU, on the same
seeded numpy inputs:

- on a CPU table the entry runs the plain version and equals the JAX
  ``gather_rows`` through ``take`` and through the Pallas kernel in
  interpret mode, bit for bit: bucket-padded ids, N = 0, D = 1,
  bfloat16 and a table whose rows are strided; no launch is counted;
- a port ``SparseShardServer.lookup_local`` (the CPU mirror, which takes
  the entry, and the host block) equals the JAX server's on the same
  block and ids;
- the entry refuses ids that are not integers [N], tables on other
  devices, and (on tensors that report a CUDA device) the tables K11
  does not take, before any launch.

Tolerance: exact (a gather moves bytes).
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pfluid
import paddle_tpu.sparse as jsparse
import paddle_tpu_torch.sparse as psparse
from paddle_tpu_torch.sparse import gather as pgather


@pytest.fixture(autouse=True)
def _clean():
    for sp in (jsparse, psparse):
        sp.clear_tables()
    psparse.gather_rows.launches = 0
    yield
    for sp in (jsparse, psparse):
        sp.clear_tables()


def _bits(a):
    """The bytes of an array of any dtype, as unsigned integers."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def _table(rng, v, d, dtype, strided):
    """A [v, d] table as numpy (the JAX side) and torch (the port): a
    column slice of a wider one when `strided` (row stride d + 3)."""
    wide = rng.standard_normal((v, d + 3 if strided else d)) * 4
    if dtype == "bfloat16":
        import ml_dtypes

        host = wide.astype(np.float32)
        port = torch.from_numpy(host).to(torch.bfloat16)
        host = host.astype(ml_dtypes.bfloat16)
    else:
        host = wide.astype(dtype)
        port = torch.from_numpy(host)
    return host[:, :d], port[:, :d]


def _padded_ids(rng, v, n_uniq):
    """What a shard lookup gathers: unique ids, padded with row 0 to the
    power-of-two bucket."""
    uniq = np.unique(rng.randint(0, v, 2 * n_uniq))[:n_uniq]
    ids = np.zeros(psparse.pad_bucket(len(uniq)), np.int64)
    ids[:len(uniq)] = uniq
    return ids


CASES = [
    # name, v, d, dtype, strided, ids
    ("padded_d16", 500, 16, "float32", False, "padded"),
    ("n0_d16", 50, 16, "float32", False, "empty"),
    ("d1", 300, 1, "float32", False, "padded"),
    ("bf16_d16", 200, 16, "bfloat16", False, "padded"),
    ("strided_d16", 200, 16, "float32", True, "padded"),
    ("int32_ids_d129", 70, 129, "float32", False, "int32"),
]


@pytest.mark.parametrize("name,v,d,dtype,strided,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_host_entry_matches_jax_gather(name, v, d, dtype, strided, kind):
    rng = np.random.RandomState(11)
    host, port = _table(rng, v, d, dtype, strided)
    if kind == "empty":
        ids = np.zeros((0,), np.int64)
    elif kind == "int32":
        ids = rng.randint(0, v, 40).astype(np.int32)
    else:
        ids = _padded_ids(rng, v, 37)
    if strided:
        assert port.stride(0) == d + 3 and port.stride(1) == 1
    got = psparse.gather_rows_to_host(port, ids)
    assert isinstance(got, np.ndarray) and got.shape == (len(ids), d)
    assert got.dtype == host.dtype
    impls = ("take",) if kind == "empty" else ("take", "pallas")
    for impl in impls:
        want = np.asarray(jsparse.gather_rows(host, ids, impl=impl))
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert psparse.gather_rows.launches == 0      # the plain version ran


@pytest.mark.parametrize("device_table", [True, False])
def test_lookup_local_matches_jax_server(device_table):
    rng = np.random.RandomState(12)
    dense = rng.standard_normal((1024, 16)).astype(np.float32)
    jcfg = jsparse.declare_sharded_table("t", 1024, 16, ["127.0.0.1:0"] * 2)
    pcfg = psparse.declare_sharded_table("t", 1024, 16, ["127.0.0.1:0"] * 2)
    jsrv = jsparse.SparseShardServer("127.0.0.1:0", 1, {"t": jcfg},
                                     device_table=True)
    psrv = psparse.SparseShardServer("127.0.0.1:0", 1, {"t": pcfg},
                                     device_table=device_table,
                                     place=pfluid.CPUPlace())
    jsrv.values["t"] = np.array(dense[jcfg.partition.shard_rows(1)])
    psrv.load_dense("t", dense)
    for ids in (_padded_ids(rng, 512, 100), np.arange(512)[::-1],
                np.zeros((0,), np.int64), [7]):
        want = jsrv.lookup_local("t", ids)
        got = psrv.lookup_local("t", ids)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(IndexError, match="outside shard 1"):
        psrv.lookup_local("t", [512])
    assert psparse.gather_rows.launches == 0
    # the CPU mirror was built by the first lookup and read since
    assert ("t" in psrv._dev) == device_table


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what the entry checks
    before it launches, without a card (the checks raise before any
    launch or pinned allocation)."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self.t, name)


def test_host_entry_refuses_what_it_does_not_take():
    t = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="ids \\[N\\]"):
        psparse.gather_rows_to_host(t, np.zeros((2, 2), np.int64))
    with pytest.raises(TypeError, match="integer ids"):
        psparse.gather_rows_to_host(t, np.array([0.0, 1.0]))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        psparse.gather_rows_to_host(torch.zeros(4, 2, device="meta"), [0])
    # tables K11 does not take, on a (reported) CUDA device
    with pytest.raises(ValueError, match="\\[V, D\\] table"):
        psparse.gather_rows_to_host(_OnCuda(torch.zeros(8)), [0])
    with pytest.raises(ValueError, match="unit stride"):
        psparse.gather_rows_to_host(_OnCuda(torch.zeros(4, 8).t()), [0])
    # the plain version raises for ids outside the table; K11 writes zeros
    with pytest.raises(IndexError):
        psparse.gather_rows_to_host(t, [8])
    assert psparse.gather_rows.launches == 0


def test_host_rows_share_the_tensor_memory_and_keep_bfloat16():
    """The entry's numpy result is the output tensor's memory (on the
    card, the pinned buffer K11 wrote), bfloat16 included."""
    rows = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    arr = pgather._host_numpy(rows)
    assert arr.ctypes.data == rows.data_ptr()
    half = rows.to(torch.bfloat16)
    got = pgather._host_numpy(half)
    assert got.ctypes.data == half.data_ptr() and str(got.dtype) == \
        "bfloat16"
    np.testing.assert_array_equal(got.astype(np.float32), rows.numpy())
