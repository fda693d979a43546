// Row gather (K11) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paddle_tpu/sparse/gather.py::_pallas_gather
// (:54), which reaches pl.pallas_call at :75 and serves the sharded
// embedding engine's lookups: SparseShardServer.lookup_local
// (paddle_tpu/sparse/shard_server.py:90-107) gathers the deduped,
// bucket-padded shard-local ids of one batch from the shard's device
// table, for the colocated shard and for every sparse_lookup RPC, and
// returns them to the host.  It computes
//
//     out[i, :] = table[ids[i], :]      (zeros where ids[i] is not in [0, V))
//
// for a table [V, D] of any dtype with unit stride along D, ids int64 [N]
// (what the client sends), out [N, D] dense.  The TPU kernel took one
// (1, D) row per grid step through a scalar-prefetched BlockSpec.  Ids are
// the caller's contract (the server's _check_local raises the named
// IndexError first); the kernel still never reads outside the table.
//
// Where the ids and the rows live.  `ids` and `out` may lie in device
// memory or in pinned host memory: the entry resolves each to the address
// the device reaches it by (cudaPointerGetAttributes) and refuses memory
// the device cannot reach.  The shard lookup hands it pinned host buffers
// (sparse/gather.py::gather_rows_to_host): the kernel reads the ids over
// PCIe and writes the rows straight into the host's buffer, so a lookup
// is one launch and one synchronisation, with no copy before or after.
//
// Design.  A gather is a byte copy, so one kernel serves every dtype: each
// thread moves W bytes at a time, W = 16 (int4) where the row's byte
// width, the table's row stride and both base addresses are multiples of
// 16, else 4, 2 or 1.  A row of R = row_bytes / W vectors gets TPR = the
// next power of two >= R threads, at most 32, so a warp covers 32 / TPR
// rows in one pass (the deep table's 64-byte fp32 row: 4 threads, 8 rows
// a pass; the wide table's 4-byte row: 1 thread, 32 rows).  Each warp
// takes PASSES passes at once: its lanes load the ids of all its rows in
// one or a few coalesced loads, hand each row's id to the row's threads by
// a shuffle, then every thread issues the loads of all its PASSES rows
// before it stores any, so PASSES independent loads are in flight a
// thread where the first version had one behind an id load.  Each pass's
// store is one contiguous run of the output (32 / TPR whole rows), which
// keeps writes into pinned host memory in full PCIe-sized lines.  A row
// wider than 32 vectors is walked by its 32 threads in chunks, each chunk
// again loading PASSES rows before storing them (D = 129 fp32: W = 4).
//
// What bounds it.  Bytes: N·D·s read, N·D·s written and 8N of ids.  At
// the CTR slice's deep-table lookup (N = 65,536 padded ids, D = 16 fp32)
// that is 8.9 MB, 2.7 us at the H100 SXM's published 3.35 TB/s; the wide
// table (D = 1) 1.0 MB, 0.3 us.  Into pinned host memory the ids and rows
// cross PCIe instead (5.0 x16: 64 GB/s each way, a fiftieth of device
// memory's rate); chip_smoke.py prints the kernel's time both ways, warm
// and with L2 flushed, beside the bound and index_select's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int PASSES = 4;  // rows each thread has in flight

template <typename Vec, int TPR_LOG2>
__global__ void __launch_bounds__(THREADS)
    gather_rows_kernel(const char* __restrict__ table, long long V,
                       long long stride_vecs, long long row_vecs,
                       const long long* __restrict__ ids, long long N,
                       char* __restrict__ out) {
  constexpr int TPR = 1 << TPR_LOG2;          // threads a row
  constexpr int RPP = 32 / TPR;               // rows a pass
  constexpr int RPW = PASSES * RPP;           // rows a warp
  constexpr int IDS = (RPW + 31) / 32;        // ids a lane loads
  const int lane = threadIdx.x & 31;
  const long long row0 =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * RPW;
  // the warp's ids, coalesced: lane l holds the ids of rows l, l + 32, ...
  long long held[IDS];
#pragma unroll
  for (int i = 0; i < IDS; ++i) {
    const int k = i * 32 + lane;
    held[i] = (k < RPW && row0 + k < N) ? ids[row0 + k] : -1;
  }
  const int slot = lane >> TPR_LOG2;          // row of this lane in a pass
  const int sub = lane & (TPR - 1);           // vector of this lane in a row
  // row p * RPP + slot of the warp: its id sits in lane (p * RPP) % 32 +
  // slot of held[p * RPP / 32] (RPP divides 32)
  long long id[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p)
    id[p] = __shfl_sync(0xffffffffu, held[p * RPP / 32],
                        (p * RPP) % 32 + slot);
  const Vec* src = reinterpret_cast<const Vec*>(table);
  Vec* dst = reinterpret_cast<Vec*>(out);
  for (long long v0 = 0; v0 < row_vecs; v0 += TPR) {
    const long long v = v0 + sub;
    Vec val[PASSES];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      val[p] = Vec{};
      if (v < row_vecs && id[p] >= 0 && id[p] < V)
        val[p] = __ldg(src + id[p] * stride_vecs + v);
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const long long row = row0 + p * RPP + slot;
      if (row < N && v < row_vecs) dst[row * row_vecs + v] = val[p];
    }
  }
}

template <typename Vec, int TPR_LOG2>
int launch_tpr(const void* table, long long V, long long row_vecs,
               long long stride_vecs, const void* ids, long long N,
               void* out, cudaStream_t stream) {
  constexpr long long rows_per_block = (long long)WARPS * PASSES *
                                       (32 >> TPR_LOG2);
  const long long blocks = (N + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gather_rows_kernel<Vec, TPR_LOG2><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const char*>(table), V, stride_vecs, row_vecs,
      static_cast<const long long*>(ids), N, static_cast<char*>(out));
  return cudaGetLastError();
}

template <typename Vec>
int launch(const void* table, long long V, long long row_bytes,
           long long stride_bytes, const void* ids, long long N, void* out,
           cudaStream_t stream) {
  const long long w = sizeof(Vec);
  const long long rv = row_bytes / w, sv = stride_bytes / w;
  int t = 0;
  while ((1LL << t) < rv && t < 5) ++t;
  switch (t) {
    case 0: return launch_tpr<Vec, 0>(table, V, rv, sv, ids, N, out, stream);
    case 1: return launch_tpr<Vec, 1>(table, V, rv, sv, ids, N, out, stream);
    case 2: return launch_tpr<Vec, 2>(table, V, rv, sv, ids, N, out, stream);
    case 3: return launch_tpr<Vec, 3>(table, V, rv, sv, ids, N, out, stream);
    case 4: return launch_tpr<Vec, 4>(table, V, rv, sv, ids, N, out, stream);
    default: return launch_tpr<Vec, 5>(table, V, rv, sv, ids, N, out, stream);
  }
}

// The address by which the current device reaches `p`: `p` itself for
// device or managed memory, the mapped address for pinned host memory;
// an error for memory the device cannot reach (pageable host memory).
int device_address(const void* p, const void** dev) {
  cudaPointerAttributes a;
  const cudaError_t err = cudaPointerGetAttributes(&a, p);
  if (err != cudaSuccess) return err;
  if (a.type == cudaMemoryTypeDevice || a.type == cudaMemoryTypeManaged) {
    *dev = p;
    return cudaSuccess;
  }
  if (a.type == cudaMemoryTypeHost && a.devicePointer != nullptr) {
    *dev = a.devicePointer;
    return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// table [V, D] of any dtype in device memory: row_bytes = D * element
// size, stride_bytes = the byte distance between rows; ids int64 [N] and
// out [N, D] dense, each in device memory or pinned host memory.  Returns
// a cudaError_t (0 on success); the launch is asynchronous on `stream`.
extern "C" int gather_rows_fwd(const void* table, long long V,
                               long long row_bytes, long long stride_bytes,
                               const void* ids, long long N, void* out,
                               void* stream) {
  if (N <= 0 || row_bytes <= 0 || V < 0 || !ids || !out ||
      (V > 0 && (!table || stride_bytes < row_bytes)))
    return cudaErrorInvalidValue;
  // the pointer queries below need the device's context current in this
  // thread (a server thread may not have touched the device yet)
  int dev = 0;
  int err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  const void* ids_d = nullptr;
  const void* out_d = nullptr;
  err = device_address(ids, &ids_d);
  if (err == cudaSuccess) err = device_address(out, &out_d);
  if (err != cudaSuccess) return err;
  void* o = const_cast<void*>(out_d);
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(o) |
                          static_cast<uintptr_t>(row_bytes) |
                          static_cast<uintptr_t>(stride_bytes);
  if (align % 16 == 0)
    return launch<int4>(table, V, row_bytes, stride_bytes, ids_d, N, o, s);
  if (align % 4 == 0)
    return launch<int>(table, V, row_bytes, stride_bytes, ids_d, N, o, s);
  if (align % 2 == 0)
    return launch<short>(table, V, row_bytes, stride_bytes, ids_d, N, o, s);
  return launch<char>(table, V, row_bytes, stride_bytes, ids_d, N, o, s);
}

extern "C" const char* gather_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
