// int8 x int8 -> int32 matmul with a per-column fp32 scale in the epilogue,
// for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/quant_kernels.py::
// _quant_matmul_kernel (:64), reached through _quant_matmul_call ->
// pl.pallas_call (:82) from quant_matmul (:132), the kernel every
// __quant__-annotated mul/matmul of a quantized inference program runs. It
// computes
//
//     out[m, n] = float(sum_k xq[m, k] * wq[k, n]) * colscale[n]
//
// over xq int8 [M, K] and wq int8 [K, N] (both row-major, dense) and
// colscale fp32 [N], into out fp32 [M, N]: the exact int32 sum, converted
// once to fp32 (round to nearest), times the scale (one multiply, no FMA),
// as the TPU kernel's acc.astype(f32) * s (:68-71). The plain version,
// (xq.double() @ wq.double()).float() * colscale, gives the same bits.
//
// Design.  One CTA of 128 threads (4 warps, 2 x 2) per 64 x 64 output
// tile; a loop inside the CTA walks K in 64-byte steps (the TPU held a
// whole [bm, K] row block and a [K, bn] column block in VMEM and ran one
// dot per grid step).  Each step stages the xq tile [64 m][64 k] and the wq
// tile in shared memory, and each warp runs
// mma.sync.m16n8k32.s32.s8.s8.s32 on its 32 x 32 sub-tile (2 x 4 MMAs per
// 32-deep slice), accumulating in int32 registers.  A thread issues all 16
// of its global loads for the NEXT step into registers before this step's
// MMAs, so one load latency per step overlaps the math (a first version
// that stored each word to shared memory right after its load serialised
// the loads: 0.042 ms at M = 1024, K = N = 768).
//   * weight layout: wq stays [K, N] row-major as the quantize pass stores
//     it (paddle_tpu/passes/quantize.py:252), so K is not contiguous per
//     output column, while the MMA's B operand wants 4 consecutive k per
//     32-bit register.  Each thread reads a 4 (k) x 4 (n) block of wq as
//     four 32-bit row words (coalesced along n), transposes the 16 bytes in
//     registers with __byte_perm, and stores four k-contiguous words into
//     the tile's [n][k] layout: the repack happens in shared memory, never
//     in the scope.
//   * shared rows are 80 bytes (64 + 16 of padding), so the fragment reads
//     of the eight row groups of a warp fall in distinct banks.
//   * ragged shapes: rows past M, columns past N and k past K load as 0 and
//     nothing past M or N is written, so every shape runs: the serving
//     path's M = rows * 128 and M = rows (the pooler), N = 2 (the logits
//     head), K = 768 or 3072, and any other.  The TPU kernel served only
//     m % 32 = k % 128 = n % 128 = 0 and fell back to the dequant-then-dot
//     form otherwise (:158-159).
//
// What bounds it.  One call does 2*M*K*N int8 operations and must read
// xq, wq and colscale once and write out once: M*K + K*N + 4*N + 4*M*N
// bytes.  At the BERT-base serving shape M = 1024, K = 768, N = 768 that is
// 1.21 G operations (0.61 us at the H100 SXM's 1979 dense int8 TOP/s)
// against 4.5 MB (1.3 us at 3.35 TB/s): memory-bound, with the fp32 output
// the largest term.
//
// What this simple design leaves on the table: no wgmma (mma.sync reaches
// a fraction of Hopper's tensor-core rate), no TMA or cp.async ring of
// several stages (one step of register prefetch only, and two CTA barriers
// per step), 4 warps per 64 x 64 tile (M = 8 launches 12 CTAs), a
// bank-conflicted transposing store of the weight tile, and one scalar
// fp32 store per output.  Those are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;          // output rows per CTA
constexpr int BN = 64;          // output columns per CTA
constexpr int BK = 64;          // k bytes per step
constexpr int THREADS = 128;    // 4 warps, 2 (m) x 2 (n), 32 x 32 each
constexpr int LDS = BK + 16;    // bytes per shared row

// Four consecutive bytes base[row * ld + col + i], i = 0..3, packed
// little-endian into a word; bytes past `rows` or `cols` read as 0.
__device__ __forceinline__ uint32_t load4(const int8_t* base, int row,
                                          int col, int rows, int cols,
                                          long long ld) {
  if (row >= rows) return 0u;
  const int8_t* p = base + (long long)row * ld + col;
  if (col + 4 <= cols && (reinterpret_cast<uintptr_t>(p) & 3) == 0)
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t v = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < cols) v |= (uint32_t)(uint8_t)__ldg(p + i) << (8 * i);
  return v;
}

// d += a . b over one 16 x 8 x 32 int8 slice, int32 accumulate.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int A_WORDS = BM * BK / 4 / THREADS;             // 8
constexpr int B_BLOCKS = (BK / 4) * (BN / 4) / THREADS;    // 2

// One step's global loads into registers: the xq tile as 8 words per
// thread (k contiguous), the wq tile as 2 blocks of 4 (k) x 4 (n) bytes,
// each held as its four row words.  All 16 loads issue before any is used.
__device__ __forceinline__ void load_tiles(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq, int m0,
    int n0, int k0, int M, int N, int K, int tid, uint32_t (&ra)[A_WORDS],
    uint32_t (&rb)[B_BLOCKS][4]) {
#pragma unroll
  for (int i = 0; i < A_WORDS; ++i) {
    const int w = tid + i * THREADS;
    ra[i] = load4(xq, m0 + w / (BK / 4), k0 + (w % (BK / 4)) * 4, M, K, K);
  }
#pragma unroll
  for (int i = 0; i < B_BLOCKS; ++i) {
    const int b = tid + i * THREADS;
    const int bn = (b % (BN / 4)) * 4, bk = (b / (BN / 4)) * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      rb[i][r] = load4(wq, k0 + bk + r, n0 + bn, K, N, N);
  }
}

// The registers of load_tiles into shared memory: xq words as they are;
// each wq block transposed in registers into four k-contiguous words of
// Bs[n][k].
__device__ __forceinline__ void store_tiles(uint8_t* As, uint8_t* Bs,
                                            int tid,
                                            const uint32_t (&ra)[A_WORDS],
                                            const uint32_t (&rb)[B_BLOCKS][4]) {
#pragma unroll
  for (int i = 0; i < A_WORDS; ++i) {
    const int w = tid + i * THREADS;
    *reinterpret_cast<uint32_t*>(
        &As[(w / (BK / 4)) * LDS + (w % (BK / 4)) * 4]) = ra[i];
  }
#pragma unroll
  for (int i = 0; i < B_BLOCKS; ++i) {
    const int b = tid + i * THREADS;
    const int bn = (b % (BN / 4)) * 4, bk = (b / (BN / 4)) * 4;
    // t0 = (r0.b0, r1.b0, r0.b1, r1.b1), t1 = (r0.b2, r1.b2, r0.b3,
    // r1.b3), t2 and t3 the same of r2, r3; then column j's word is
    // (r0.bj, r1.bj, r2.bj, r3.bj)
    const uint32_t t0 = __byte_perm(rb[i][0], rb[i][1], 0x5140);
    const uint32_t t1 = __byte_perm(rb[i][0], rb[i][1], 0x7362);
    const uint32_t t2 = __byte_perm(rb[i][2], rb[i][3], 0x5140);
    const uint32_t t3 = __byte_perm(rb[i][2], rb[i][3], 0x7362);
    uint8_t* dst = &Bs[bn * LDS + bk];
    *reinterpret_cast<uint32_t*>(dst + 0 * LDS) = __byte_perm(t0, t2, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 1 * LDS) = __byte_perm(t0, t2, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * LDS) = __byte_perm(t1, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * LDS) = __byte_perm(t1, t3, 0x7632);
  }
}

__global__ void __launch_bounds__(THREADS)
    quant_matmul_kernel(const int8_t* __restrict__ xq,
                        const int8_t* __restrict__ wq,
                        const float* __restrict__ colscale,
                        float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) uint8_t As[BM * LDS];   // [m][k]
  __shared__ __align__(16) uint8_t Bs[BN * LDS];   // [n][k], wq repacked
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;           // MMA fragment coords
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  uint32_t ra[A_WORDS], rb[B_BLOCKS][4];
  load_tiles(xq, wq, m0, n0, 0, M, N, K, tid, ra, rb);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_tiles(As, Bs, tid, ra, rb);
    __syncthreads();
    // the next step's loads are in flight while this step's MMAs run
    if (k0 + BK < K) load_tiles(xq, wq, m0, n0, k0 + BK, M, N, K, tid, ra, rb);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      // A fragment (16 x 32, row): a0 row g, k 4t..4t+3; a1 row g+8;
      // a2 row g, k 16+4t..; a3 row g+8, k 16+4t..
      uint32_t a[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint8_t* p = &As[(wm + mi * 16 + g) * LDS + kk + 4 * t];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
      // B fragment (32 x 8, col): b0 column g, k 4t..4t+3; b1 k 16+4t..
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* p = &Bs[(wn + ni * 8 + g) * LDS + kk + 4 * t];
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], bf[ni]);
    }
    __syncthreads();
  }

  // C fragment (16 x 8): c0, c1 row g, columns 2t, 2t+1; c2, c3 row g+8.
  // The int32 sum converts to fp32 once, then one multiply by the scale.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + mi * 16 + g + (r >> 1) * 8;
        const int col = n0 + wn + ni * 8 + 2 * t + (r & 1);
        if (row < M && col < N)
          out[(long long)row * N + col] = __fmul_rn(
              __int2float_rn(acc[mi][ni][r]), __ldg(colscale + col));
      }
}

}  // namespace

// xq int8 [M, K], wq int8 [K, N], colscale fp32 [N], out fp32 [M, N], all
// dense row-major on the device.  Returns a cudaError_t (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int quant_matmul_int8(const void* xq, const void* wq,
                                 const void* colscale, void* out, int M,
                                 int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  const int m_tiles = (M + BM - 1) / BM;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, m_tiles);
  quant_matmul_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(colscale), static_cast<float*>(out), M, N,
      K);
  return cudaGetLastError();
}

extern "C" const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
