// Paged decode attention (K4) and its int8-arena arm (K5) for Hopper
// (sm_90a), plain C interface.  One templated device loop serves both.
//
// Replaces two TPU kernels that share one flash loop in the JAX package,
// paddle_tpu/ops/pallas_kernels.py::_paged_attn_kernel_impl (:958):
//   K4  _paged_attention_call (:1033) -> pl.pallas_call (:1064), float32
//       or bfloat16 K/V arenas;
//   K5  paddle_tpu/ops/quant_kernels.py::_paged_attn_quant_call (:257) ->
//       pl.pallas_call (:299), int8 K/V arenas with float32 per-token
//       scale rows, dequantized inside the tile.
// Over q [S, H, D] (one decode query per slot), arenas [N, Bs, H, D], an
// int32 block table [S, MB] and int32 lengths [S] it computes, for each
// slot s and head h, with L = min(lengths[s], MB * Bs) and token t living
// at position t % Bs of block table[s, t / Bs]:
//
//     k_t = k_arena[blk, pos, h, :] (* k_scale[blk, pos] in the int8 arm)
//     v_t = v_arena[blk, pos, h, :] (* v_scale[blk, pos])
//     s_t = (q[s, h, :] * scale) . k_t                       for t < L
//     out[s, h, :] = sum_t softmax(s)_t v_t                  (0 when L = 0)
//
// in float32, written in q's dtype.  The TPU kernel walked a (slot, block)
// grid whose sequential block axis carried the online-softmax state in
// VMEM scratch; its index map fetched the table-named block for each step.
//
// Design.  One CTA of 4 warps per (slot, head).  Each warp owns every
// fourth block of the slot's chain (blocks past the length are never
// visited; the tail block is cut at the length, position by position) and
// keeps its own online softmax: running max m, denominator l and the
// accumulator, with q (pre-scaled) and the accumulator in registers, lane
// i holding elements i, i + 32, ... of the head dimension (D <= 256, so at
// most 8 a lane).  Above D 256 a second grid axis splits the head dim into
// column groups of 256: each CTA forms every token's full-D score (q read
// from global memory, where it stays in L1) and accumulates only its
// group's columns (paged_attention_wide_kernel).  A token's score is one dot product per lane and a
// 5-step shuffle reduction; its K and V rows are read by the warp as
// coalesced strided loads.  In the int8 arm each element is multiplied by
// its token's fp32 scale in registers as it is loaded: no dequantized copy
// of the arena is ever written.  At the end the four warps' (m, l, acc)
// are merged through shared memory by the usual rescale by exp(m_w - M).
// A block id outside [0, N) contributes nothing (the kernel never reads
// outside the arena; the pool's tables always name real blocks).
//
// What bounds it.  Bytes: every live token's K and V row read once (2 B a
// value in bf16, 4 in fp32, 1 in int8 plus two fp32 scales a token), q read
// and out written once.  At bench_kernels.py's decode shape (S 64, H 8,
// D 128, Bs 16, lengths 192-256) in bf16 that is ~59 MB, ~17.5 us at the
// H100 SXM's published 3.35 TB/s; the 4 flops a value (~59 MFLOP) take
// under 1 us at 67 TFLOP/s fp32.  chip_smoke.py's paged_kernel_phase
// prints the measured time beside that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_D = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// NPER: head-dimension elements a lane holds (ceil(D / 32) rounded up to a
// power of two).  k_scale/v_scale are null for float arenas.
template <typename TQ, typename TKV, int NPER>
__global__ void __launch_bounds__(THREADS)
    paged_attention_kernel(const TQ* __restrict__ q,
                           const TKV* __restrict__ k_arena,
                           const TKV* __restrict__ v_arena,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ table,
                           const int* __restrict__ lengths,
                           TQ* __restrict__ out, int H, int D, int Bs,
                           int MB, int N, float scale) {
  __shared__ float sh_acc[WARPS][MAX_D];
  __shared__ float sh_m[WARPS];
  __shared__ float sh_l[WARPS];

  const long long row = blockIdx.x;  // s * H + h
  const int s = static_cast<int>(row / H);
  const int h = static_cast<int>(row % H);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = min(max(lengths[s], 0), MB * Bs);

  float qr[NPER], acc[NPER];
#pragma unroll
  for (int i = 0; i < NPER; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? to_f(q[row * D + d]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  const long long tok = static_cast<long long>(H) * D;  // position stride
  const int nblk = (len + Bs - 1) / Bs;
  for (int b = warp; b < nblk; b += WARPS) {
    const int blk = table[static_cast<long long>(s) * MB + b];
    if (blk < 0 || blk >= N) continue;
    const int fill = min(Bs, len - b * Bs);
    const long long first = static_cast<long long>(blk) * Bs;
    for (int p = 0; p < fill; ++p) {
      const long long off = (first + p) * tok + static_cast<long long>(h) * D;
      float ks = 1.f, vs = 1.f;
      if (k_scale != nullptr) {
        ks = k_scale[first + p];
        vs = v_scale[first + p];
      }
      float dot = 0.f, vr[NPER];
#pragma unroll
      for (int i = 0; i < NPER; ++i) {
        const int d = lane + 32 * i;
        vr[i] = 0.f;
        if (d < D) {
          float kk = to_f(k_arena[off + d]);
          float vv = to_f(v_arena[off + d]);
          if (k_scale != nullptr) {
            kk *= ks;
            vv *= vs;
          }
          dot += qr[i] * kk;
          vr[i] = vv;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
      const float m_new = fmaxf(m, dot);
      const float corr = expf(m - m_new);  // 0 while m is -inf
      const float pr = expf(dot - m_new);
      l = l * corr + pr;
#pragma unroll
      for (int i = 0; i < NPER; ++i) acc[i] = acc[i] * corr + pr * vr[i];
      m = m_new;
    }
  }

  // merge the four warps' online-softmax states
  if (lane == 0) {
    sh_m[warp] = m;
    sh_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < NPER; ++i) {
    const int d = lane + 32 * i;
    if (d < D) sh_acc[warp][d] = acc[i];
  }
  __syncthreads();
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sh_m[w]);
  float wt[WARPS], denom = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    wt[w] = sh_m[w] == -CUDART_INF_F ? 0.f : expf(sh_m[w] - mx);
    denom += sh_l[w] * wt[w];
  }
  denom = fmaxf(denom, 1e-20f);
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += sh_acc[w][d] * wt[w];
    store(out + row * D + d, a / denom);
  }
}

// Head dims above MAX_D: CTA (slot * H + head, group) forms each token's
// score over the whole head dim and accumulates the group's MAX_D columns
// c0 .. c0 + MAX_D - 1; otherwise the loop of paged_attention_kernel.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
    paged_attention_wide_kernel(const TQ* __restrict__ q,
                                const TKV* __restrict__ k_arena,
                                const TKV* __restrict__ v_arena,
                                const float* __restrict__ k_scale,
                                const float* __restrict__ v_scale,
                                const int* __restrict__ table,
                                const int* __restrict__ lengths,
                                TQ* __restrict__ out, int H, int D, int Bs,
                                int MB, int N, float scale) {
  constexpr int NPER = MAX_D / 32;
  __shared__ float sh_acc[WARPS][MAX_D];
  __shared__ float sh_m[WARPS];
  __shared__ float sh_l[WARPS];

  const long long row = blockIdx.x;  // s * H + h
  const int s = static_cast<int>(row / H);
  const int h = static_cast<int>(row % H);
  const int c0 = blockIdx.y * MAX_D;
  const int ncols = min(MAX_D, D - c0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = min(max(lengths[s], 0), MB * Bs);
  const TQ* qrow = q + row * D;

  float acc[NPER];
#pragma unroll
  for (int i = 0; i < NPER; ++i) acc[i] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  const long long tok = static_cast<long long>(H) * D;  // position stride
  const int nblk = (len + Bs - 1) / Bs;
  for (int b = warp; b < nblk; b += WARPS) {
    const int blk = table[static_cast<long long>(s) * MB + b];
    if (blk < 0 || blk >= N) continue;
    const int fill = min(Bs, len - b * Bs);
    const long long first = static_cast<long long>(blk) * Bs;
    for (int p = 0; p < fill; ++p) {
      const long long off = (first + p) * tok + static_cast<long long>(h) * D;
      float ks = 1.f, vs = 1.f;
      if (k_scale != nullptr) {
        ks = k_scale[first + p];
        vs = v_scale[first + p];
      }
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) {
        float kk = to_f(k_arena[off + d]);
        if (k_scale != nullptr) kk *= ks;
        dot += to_f(qrow[d]) * scale * kk;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
      const float m_new = fmaxf(m, dot);
      const float corr = expf(m - m_new);  // 0 while m is -inf
      const float pr = expf(dot - m_new);
      l = l * corr + pr;
#pragma unroll
      for (int i = 0; i < NPER; ++i) {
        const int c = lane + 32 * i;
        float vv = 0.f;
        if (c < ncols) {
          vv = to_f(v_arena[off + c0 + c]);
          if (v_scale != nullptr) vv *= vs;
        }
        acc[i] = acc[i] * corr + pr * vv;
      }
      m = m_new;
    }
  }

  // merge the four warps' online-softmax states
  if (lane == 0) {
    sh_m[warp] = m;
    sh_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < NPER; ++i) sh_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sh_m[w]);
  float wt[WARPS], denom = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    wt[w] = sh_m[w] == -CUDART_INF_F ? 0.f : expf(sh_m[w] - mx);
    denom += sh_l[w] * wt[w];
  }
  denom = fmaxf(denom, 1e-20f);
  for (int c = threadIdx.x; c < ncols; c += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += sh_acc[w][c] * wt[w];
    store(out + row * D + c0 + c, a / denom);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* lengths,
           void* out, int S, int H, int D, int Bs, int MB, int N,
           float scale, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(S) * H));
  const auto* qq = static_cast<const TQ*>(q);
  const auto* kk = static_cast<const TKV*>(k);
  const auto* vv = static_cast<const TKV*>(v);
  const auto* kss = static_cast<const float*>(ks);
  const auto* vss = static_cast<const float*>(vs);
  const auto* tab = static_cast<const int*>(table);
  const auto* len = static_cast<const int*>(lengths);
  auto* o = static_cast<TQ*>(out);
  const int nper = (D + 31) / 32;
  if (D > MAX_D) {
    const int groups = (D + MAX_D - 1) / MAX_D;
    if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
    paged_attention_wide_kernel<TQ, TKV>
        <<<dim3(grid.x, groups), THREADS, 0, stream>>>(
            qq, kk, vv, kss, vss, tab, len, o, H, D, Bs, MB, N, scale);
  } else if (nper <= 1)
    paged_attention_kernel<TQ, TKV, 1><<<grid, THREADS, 0, stream>>>(
        qq, kk, vv, kss, vss, tab, len, o, H, D, Bs, MB, N, scale);
  else if (nper <= 2)
    paged_attention_kernel<TQ, TKV, 2><<<grid, THREADS, 0, stream>>>(
        qq, kk, vv, kss, vss, tab, len, o, H, D, Bs, MB, N, scale);
  else if (nper <= 4)
    paged_attention_kernel<TQ, TKV, 4><<<grid, THREADS, 0, stream>>>(
        qq, kk, vv, kss, vss, tab, len, o, H, D, Bs, MB, N, scale);
  else
    paged_attention_kernel<TQ, TKV, 8><<<grid, THREADS, 0, stream>>>(
        qq, kk, vv, kss, vss, tab, len, o, H, D, Bs, MB, N, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_q(int kv_dtype, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* table,
             const void* lengths, void* out, int S, int H, int D, int Bs,
             int MB, int N, float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<TQ, float>(q, k, v, ks, vs, table, lengths, out, S, H, D,
                               Bs, MB, N, scale, stream);
    case 1:
      return launch<TQ, __nv_bfloat16>(q, k, v, ks, vs, table, lengths, out,
                                       S, H, D, Bs, MB, N, scale, stream);
    default:
      return launch<TQ, int8_t>(q, k, v, ks, vs, table, lengths, out, S, H,
                                D, Bs, MB, N, scale, stream);
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (arenas only).  The int8 arm
// takes both scale planes; the float arms take neither.  Returns a
// cudaError_t (0 on success).
extern "C" int paged_attention_fwd(const void* q, int q_dtype, const void* k,
                                   const void* v, int kv_dtype,
                                   const void* k_scale, const void* v_scale,
                                   const void* table, const void* lengths,
                                   void* out, int S, int H, int D, int Bs,
                                   int MB, int N, float scale, void* stream) {
  if (S <= 0 || H <= 0 || D <= 0 || Bs <= 0 || MB <= 0 ||
      N <= 0 || q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 2 ||
      !q || !k || !v || !table || !lengths || !out ||
      (kv_dtype == 2) != (k_scale != nullptr) ||
      (kv_dtype == 2) != (v_scale != nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_q<float>(kv_dtype, q, k, v, k_scale, v_scale, table,
                           lengths, out, S, H, D, Bs, MB, N, scale, s);
  return launch_q<__nv_bfloat16>(kv_dtype, q, k, v, k_scale, v_scale, table,
                                 lengths, out, S, H, D, Bs, MB, N, scale, s);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
