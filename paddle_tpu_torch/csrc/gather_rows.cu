// Row gather (K11) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paddle_tpu/sparse/gather.py::_pallas_gather
// (:54), which reaches pl.pallas_call at :75 and serves the sharded
// embedding engine's lookups: SparseShardServer.lookup_local
// (paddle_tpu/sparse/shard_server.py:90-107) gathers the deduped,
// bucket-padded shard-local ids of one batch from the shard's device
// table, for the colocated shard and for every sparse_lookup RPC.  It
// computes
//
//     out[i, :] = table[ids[i], :]      (zeros where ids[i] is not in [0, V))
//
// for a table [V, D] of any dtype with unit stride along D, ids int64 [N]
// (what the client sends), out [N, D] dense.  The TPU kernel took one
// (1, D) row per grid step through a scalar-prefetched BlockSpec.  Ids are
// the caller's contract (the server's _check_local raises the named
// IndexError first); the kernel still never reads outside the table.
//
// Design.  A gather is a byte copy, so one kernel serves every dtype: each
// thread moves W bytes at a time, W = 16 (int4) where the row's byte
// width, the table's row stride and both base pointers are multiples of
// 16, else 4, 2 or 1.  A row of R = row_bytes / W vectors gets the next
// power of two >= R threads, at most 32; rows narrower than a warp's 512
// bytes are packed several to a warp (the deep table's 64-byte fp32 row
// takes 4 threads, 8 rows a warp; the wide table's 4-byte row 1 thread,
// 32 rows a warp), and a row wider than 32 vectors is walked by its 32
// threads in a strided loop (D = 129 fp32: W = 4, each lane 4-5 words).
// Neighbouring threads copy neighbouring bytes of a row, so each row's
// read and write are coalesced.  Each row's id is read once, by one lane
// of the warp (lanes 0..rows_per_warp-1 read consecutive ids in one
// coalesced load), and handed to the row's threads by a warp shuffle.
//
// What bounds it.  Bytes: N·D·s read, N·D·s written and 8N of ids.  At
// the CTR slice's deep-table lookup (N = 65,536 padded ids, D = 16 fp32)
// that is 8.9 MB, 2.7 us at the H100 SXM's published 3.35 TB/s; the wide
// table (D = 1) 1.0 MB, 0.3 us.  At those sizes the launch (~5 us between
// CUDA events) dominates; chip_smoke.py prints the measured time beside
// the bound and index_select's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename Vec>
__global__ void __launch_bounds__(THREADS)
    gather_rows_kernel(const char* __restrict__ table, long long V,
                       long long stride_vecs, long long row_vecs,
                       const long long* __restrict__ ids, long long N,
                       char* __restrict__ out, int tpr_log2) {
  const int lane = threadIdx.x & 31;
  const int tpr = 1 << tpr_log2;               // threads per row
  const int rows_per_warp = 32 >> tpr_log2;
  const long long warp =
      (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long row0 = warp * rows_per_warp;
  // one coalesced load of this warp's ids, one id per lane
  long long my_id = -1;
  if (lane < rows_per_warp && row0 + lane < N)
    my_id = __ldg(ids + row0 + lane);
  const int slot = lane >> tpr_log2;           // row of this lane in the warp
  const long long id = __shfl_sync(0xffffffffu, my_id, slot);
  const long long row = row0 + slot;
  if (row >= N) return;
  Vec* dst = reinterpret_cast<Vec*>(out) + row * row_vecs;
  const int sub = lane & (tpr - 1);
  if (id < 0 || id >= V) {
    const Vec zero{};
    for (long long v = sub; v < row_vecs; v += tpr) dst[v] = zero;
    return;
  }
  const Vec* src = reinterpret_cast<const Vec*>(table) + id * stride_vecs;
  for (long long v = sub; v < row_vecs; v += tpr) dst[v] = __ldg(src + v);
}

template <typename Vec>
int launch(const void* table, long long V, long long row_bytes,
           long long stride_bytes, const void* ids, long long N, void* out,
           cudaStream_t stream) {
  const long long w = sizeof(Vec);
  const long long row_vecs = row_bytes / w;
  int tpr_log2 = 0;
  while ((1LL << tpr_log2) < row_vecs && tpr_log2 < 5) ++tpr_log2;
  const long long rows_per_block = (long long)WARPS * (32 >> tpr_log2);
  const long long blocks = (N + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gather_rows_kernel<Vec><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const char*>(table), V, stride_bytes / w, row_vecs,
      static_cast<const long long*>(ids), N, static_cast<char*>(out),
      tpr_log2);
  return cudaGetLastError();
}

}  // namespace

// table [V, D] of any dtype: row_bytes = D * element size, stride_bytes =
// the byte distance between rows; ids int64 [N]; out [N, D] dense.
// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int gather_rows_fwd(const void* table, long long V,
                               long long row_bytes, long long stride_bytes,
                               const void* ids, long long N, void* out,
                               void* stream) {
  if (N <= 0 || row_bytes <= 0 || V < 0 || !ids || !out ||
      (V > 0 && (!table || stride_bytes < row_bytes)))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes) |
                          static_cast<uintptr_t>(stride_bytes);
  if (align % 16 == 0)
    return launch<int4>(table, V, row_bytes, stride_bytes, ids, N, out, s);
  if (align % 4 == 0)
    return launch<int>(table, V, row_bytes, stride_bytes, ids, N, out, s);
  if (align % 2 == 0)
    return launch<short>(table, V, row_bytes, stride_bytes, ids, N, out, s);
  return launch<char>(table, V, row_bytes, stride_bytes, ids, N, out, s);
}

extern "C" const char* gather_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
