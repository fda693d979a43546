// int8 x int8 -> int32 matmul with a per-column fp32 scale in the epilogue,
// for Hopper (sm_90a) on warpgroup MMA (wgmma) fed by TMA, plain C
// interface.
//
// Replaces the TPU kernel paddle_tpu/ops/quant_kernels.py::
// _quant_matmul_kernel (:64), reached through _quant_matmul_call ->
// pl.pallas_call (:82) from quant_matmul (:132), the kernel every
// __quant__-annotated mul/matmul of a quantized inference program runs. It
// computes
//
//     out[m, n] = float(sum_k xq[m, k] * wq[k, n]) * colscale[n]
//
// over xq int8 [M, K] and wq int8 [K, N] and colscale fp32 [N], into out
// fp32 [M, N]: the exact int32 sum, converted once to fp32 (round to
// nearest), times the scale (one multiply, no FMA), as the TPU kernel's
// acc.astype(f32) * s (:68-71).  The plain version,
// (xq.double() @ wq.double()).float() * colscale, gives the same bits.
//
// Operands.  8-bit wgmma reads both A and B K-major from shared memory (the
// transpose bits exist only for 16-bit types), so the kernel takes xq as
// rows of K bytes and the weight as wt [N, K], K-major: the layout the
// quantize pass stores at load (passes/quantize.py apply_to_scope keeps a
// K-major [N, Kp] buffer and gives the scope its [K, N] view), so the
// serving path never transposes a weight.  Each operand is read by TMA
// through a tensor map of its own row stride (a multiple of 16 bytes:
// quantize_activation and the weight layout pad K to it): rows past M or
// N and k past K arrive as zeros (TMA's out-of-bounds fill), which add
// nothing to an integer sum.
//
// Design.
//   * One CTA per 64 x 64 output tile (192 CTAs at M 1024, N 768): a
//     consumer warpgroup (warps 0-3) and a producer warp (warp 4).  Of the
//     tiles measured on the H100 (one or two warpgroups by 64 or 128
//     columns, PERF.md), 64 x 64 was the fastest or within 1% of it at
//     every serving shape but ffn2 (K 3072).
//   * A ring of STAGES = 4 shared-memory stages, each the xq tile [64][128
//     bytes] and the weight tile [64][128 bytes] in TMA's 128-byte swizzle.
//     The producer's one thread waits for a stage to be free (its "empty"
//     mbarrier), arms its "full" mbarrier with the stage's bytes and issues
//     the two TMA loads.
//   * The consumers wait on "full", run four wgmma.m64n64k32.s32.s8.s8
//     over the stage's 128 bytes of k, commit, and release the previous
//     stage once its products are done (one group stays in flight).
//   * Epilogue: each int32 sum to fp32 (__int2float_rn) times its column's
//     scale (__fmul_rn); neighbouring lanes swap halves of their fragments
//     so each stores 4 consecutive floats of one row (16 bytes) where N % 4
//     == 0, else scalar stores under masks.
//
// What bounds it.  One call does 2*M*K*N int8 operations and must read
// xq, wq and colscale once and write out once: M*K + K*N + 4*N + 4*M*N
// bytes.  At the BERT-base serving shape M = 1024, K = 768, N = 768 that is
// 1.21 G operations (0.61 us at the H100 SXM's 1979 dense int8 TOP/s)
// against 4.5 MB (1.3 us at 3.35 TB/s): memory-bound, with the fp32 output
// the largest term.  At these sizes a call is mostly its pipeline's fill
// and drain; chip_smoke.py prints each serving shape beside its bound.

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BK = 128;             // k bytes a stage: one swizzled row
constexpr int STAGES = 4;           // shared-memory ring
constexpr unsigned FULL = 0xffffffffu;

// A CTA's tile: one consumer warpgroup of BM rows by BN columns, and one
// producer warp after it.
constexpr int BM = 64, BN = 64;
constexpr int CONSUMER_WARPS = 4;
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);
constexpr int A_BYTES = BM * BK;    // xq [BM][128]
constexpr int B_BYTES = BN * BK;    // wt [BN][128]
constexpr int STAGE = A_BYTES + B_BYTES;
// the ring, 1024-byte aligned (the swizzle's period), then the barriers
constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// The box at (k0, r0) of a tensor map into shared memory; completion is
// counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0),
      "r"(r0)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// byte offset); the leading byte offset is unused in this layout.  A step
// of 32 bytes of k within the row adds 2 to the start address.
__device__ __forceinline__ uint64_t desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += a.b over one m64n64k32 step: A [64 x 32] and B [64 x 32], both
// K-major in shared memory (descriptors), into 32 int32 accumulators a
// thread.
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(THREADS)
    quant_matmul_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w,
                        const float* __restrict__ colscale,
                        float* __restrict__ out, int M, int N, int K,
                        int vec4) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // the producer: one thread keeps the ring full
    if (lane == 0) {
      for (int ks = 0; ks < nk; ++ks) {
        const int s = ks % STAGES;
        if (ks >= STAGES) mbar_wait(&empty[s], (ks / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], STAGE);
        uint8_t* a = smem + s * STAGE;
        tma_load(a, &tm_x, &full[s], ks * BK, m0);
        tma_load(a + A_BYTES, &tm_w, &full[s], ks * BK, n0);
      }
    }
    return;
  }

  // the consumer warpgroup: m64n64k32 products
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  fence_acc(acc);
  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(&full[s], (ks / STAGES) & 1);
    const uint8_t* a = smem + s * STAGE;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_n64(acc, desc(a + 32 * kk), desc(a + A_BYTES + 32 * kk));
    wg_commit();
    wg_wait<1>();  // the previous step's products are done: free its stage
    if (ks > 0 && lane == 0) mbar_arrive(&empty[(ks - 1) % STAGES]);
  }
  wg_wait<0>();
  fence_acc(acc);

  // acc[4j + r]: row 16 warp + g + 8 (r / 2), column 8 j + 2 t + r % 2
  const int g = lane >> 2, t = lane & 3;
  const int row0 = m0 + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    const float s0 = col < N ? __ldg(colscale + col) : 0.f;
    const float s1 = col + 1 < N ? __ldg(colscale + col + 1) : 0.f;
    const float v[4] = {__fmul_rn(__int2float_rn(acc[4 * j]), s0),
                        __fmul_rn(__int2float_rn(acc[4 * j + 1]), s1),
                        __fmul_rn(__int2float_rn(acc[4 * j + 2]), s0),
                        __fmul_rn(__int2float_rn(acc[4 * j + 3]), s1)};
    if (vec4) {
      // even t keeps row g and takes its neighbour's two columns of it;
      // odd t keeps row g + 8 and takes its neighbour's two of that
      const bool odd = t & 1;
      const float x0 = __shfl_xor_sync(FULL, odd ? v[0] : v[2], 1);
      const float x1 = __shfl_xor_sync(FULL, odd ? v[1] : v[3], 1);
      const int row = odd ? row0 + 8 : row0;
      const int c = odd ? col - 2 : col;
      const float4 o = odd ? make_float4(x0, x1, v[2], v[3])
                           : make_float4(v[0], v[1], x0, x1);
      if (row < M && c < N)
        *reinterpret_cast<float4*>(out + (size_t)row * N + c) = o;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row0 + 8 * (r >> 1), c = col + (r & 1);
        if (row < M && c < N) out[(size_t)row * N + c] = v[r];
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (so the library
// needs no -lcuda); null where it is missing.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of an int8 [rows, K] matrix with row stride `ld` bytes,
// read in boxes of BK bytes of k by `box_rows` rows, 128-byte swizzled.
cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int K,
                     long long ld, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch(const void* xq, long long ldx, const void* wt,
                   long long ldw, const float* colscale, float* out, int M,
                   int N, int K, int vec4, cudaStream_t stream) {
  const int m_tiles = (M + BM - 1) / BM;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  // Both maps are encoded and the attribute set every call: a cache of
  // them saved no measurable host time of a ~0.022 ms wrapper call
  // (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W).
  CUtensorMap tm_x, tm_w;
  cudaError_t err = make_map(&tm_x, xq, M, K, ldx, BM);
  if (err == cudaSuccess) err = make_map(&tm_w, wt, N, K, ldw, BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(quant_matmul_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
  if (err != cudaSuccess) return err;
  quant_matmul_kernel<<<dim3((N + BN - 1) / BN, m_tiles), THREADS, SMEM,
                        stream>>>(tm_x, tm_w, colscale, out, M, N, K, vec4);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// xq int8 [M, K] with row stride ldx bytes, wt int8 [N, K] (the weight
// K-major) with row stride ldw bytes, both strides multiples of 16 and
// both bases 16-byte aligned (what TMA reads); colscale fp32 [N]; out fp32
// [M, N] dense.  Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int quant_matmul_int8(const void* xq, long long ldx,
                                 const void* wt, long long ldw,
                                 const void* colscale, void* out, int M,
                                 int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || ldw < K)
    return cudaErrorInvalidValue;
  if ((ldx & 15) || (ldw & 15) || !aligned16(xq) || !aligned16(wt))
    return cudaErrorMisalignedAddress;
  const int vec4 = N % 4 == 0 && aligned16(out);
  const auto* cs = static_cast<const float*>(colscale);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(xq, ldx, wt, ldw, cs, o, M, N, K, vec4, st);
}

extern "C" const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
