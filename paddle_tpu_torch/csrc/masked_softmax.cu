// Masked row softmax (K7) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py::
// _masked_softmax_kernel (:1340), reached through _masked_softmax_p ->
// pl.pallas_call (:1376) from masked_softmax (:1358), which the
// `sequence_softmax` op runs over a lod input (paddle_tpu/ops/
// sequence_ops.py:88-100).  Over x fp32 [B, T] it computes, row by row,
//
//     xm  = valid ? x : -FLT_MAX            mx = max_t xm
//     p   = valid ? exp(xm - mx) : 0        out = p / max(sum_t p, 1e-20)
//
// so a row with no valid position gives 0.  A position is valid when
// t < lens[row]: the lengths the sequence op holds, from which the TPU
// kernel's caller built its [B, T] mask.
//
// Design.  Each row is read from device memory once (the TPU kernel held
// a [bb, T] block in VMEM per grid step and served only T % 128 == 0,
// composing in XLA otherwise, :1363; here every T runs).  Rows are held
// in registers with each thread holding one or two values (or float4s),
// since a thread's exponentials and IEEE divisions run in series.
//
// - T <= 64: a warp a row, ROW_WARPS rows a CTA (lane l holds elements
//   l and l + 32).  The row's length is loaded with its values, not
//   before them.  The max and the sum are taken in each lane, then by a
//   butterfly of warp shuffles (offsets 16, 8, 4, 2, 1); no barrier.
// - Up to 2048 vectors (T 8192): a CTA a row of THREADS = 128, 256, 512
//   or 1024, thread i holding vectors i and i + THREADS of W floats in
//   registers: W = 4 (16-byte loads) from T 1025 where T, the row stride
//   and the base address allow it, else W = 1.  Per-thread sums in
//   order, the warp butterfly, then the warps' sums added in warp order
//   by every thread: two barriers in all.
// - Longer rows: a CTA of 1024 a row, each thread walking vectors i,
//   i + 1024, ... with the same arithmetic; the row goes into shared
//   memory as it is loaded (T up to ~58,000), the exponentials overwrite
//   it, and the output is written from there.  A row longer than shared
//   memory is read again from device memory (or L2) for the sum and the
//   write.
//
// Measured on the H100 (PERF.md): a warp a row holding up to 32
// values a lane ran [16, 1000] slower than the earlier three-pass kernel,
// and one holding up to 8 ran [16, 128] slower; rows of one or two values
// a thread staged in shared memory ran slower than in registers.
//
// Accurate expf and IEEE division, no fast-math intrinsics.  tests/
// test_torch_masked_softmax.py holds a float32 model of every arm's
// summation order to the JAX kernel and the plain version.
//
// What bounds it.  One call reads x and the lengths once and writes out
// once: 8 B an element.  At the sequence-softmax program's [16, 128]
// that is 16 KB, 5 ns at the H100 SXM's published 3.35 TB/s: a single
// launch cannot come near it, so chip_smoke.py prints the launch floor
// (a one-element Tensor.zero_, timed the same way) beside its time.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int ROW_WARPS = 4;          // rows a CTA of the warp arm
constexpr int WARP_ROW_MAX = 64;      // the warp arm's longest row
constexpr int VEC_ROW_MIN = 1025;     // the shortest row read in float4s
constexpr int REG_VECTORS = 2048;     // the most vectors held in registers
constexpr int LONG_THREADS = 1024;    // threads a row above REG_VECTORS

template <int W>
__device__ __forceinline__ void load(const float* p, long long i,
                                     float* v) {
  if constexpr (W == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = __ldg(p + i);
  }
}

template <int W>
__device__ __forceinline__ void store(float* p, long long i,
                                      const float* v) {
  if constexpr (W == 4)
    reinterpret_cast<float4*>(p)[i] = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[i] = v[0];
}

template <int W>
__device__ __forceinline__ void load_shared(const float* p, int i, float* v) {
  if constexpr (W == 4) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = p[i];
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The CTA's max (SUM false) or sum of `v`, every thread getting it: the
// warp butterfly, then the warps' values folded in warp order.  `red`
// ([WARPS] in shared memory) is not reused, so no trailing barrier.
template <int WARPS, bool SUM>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = SUM ? warp_sum(v) : warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w)
    v = SUM ? __fadd_rn(v, red[w]) : fmaxf(v, red[w]);
  return v;
}

// T <= WARP_ROW_MAX: lane l holds elements c * 32 + l, c < NC, of its row.
template <int NC>
__global__ void __launch_bounds__(ROW_WARPS * 32)
    softmax_warp_kernel(const float* __restrict__ x, long long ld_x,
                        const int* __restrict__ lens,
                        float* __restrict__ out, int B, int T) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROW_WARPS +
                        (threadIdx.x >> 5);
  if (row >= B) return;                   // the whole warp
  const int n = __ldg(lens + row);
  const float* xr = x + row * ld_x;
  float v[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c)
    v[c] = c * 32 + lane < T ? __ldg(xr + c * 32 + lane) : -FLT_MAX;
  const int lim = min(n, T);
  float mx = -FLT_MAX;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (c * 32 + lane < lim) mx = fmaxf(mx, v[c]);
  mx = warp_max(mx);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    v[c] = c * 32 + lane < lim ? expf(v[c] - mx) : 0.0f;
    sum = __fadd_rn(sum, v[c]);
  }
  sum = fmaxf(warp_sum(sum), 1e-20f);
  float* orow = out + row * (long long)T;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (c * 32 + lane < T) orow[c * 32 + lane] = __fdiv_rn(v[c], sum);
}

// Above WARP_ROW_MAX, at most 2 * THREADS vectors: a CTA a row, thread i
// holding vectors i and i + THREADS in registers.
template <int W, int THREADS>
__global__ void __launch_bounds__(THREADS)
    softmax_cta_kernel(const float* __restrict__ x, long long ld_x,
                       const int* __restrict__ lens,
                       float* __restrict__ out, int T) {
  constexpr int WARPS = THREADS / 32;
  __shared__ float red_max[WARPS], red_sum[WARPS];
  const long long row = blockIdx.x;
  const int n = __ldg(lens + row);
  const float* xr = x + row * ld_x;
  const int nv = T / W;
  const int lim = min(n, T);
  float v[2 * W];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < nv) {
      load<W>(xr, i, v + k * W);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) v[k * W + j] = -FLT_MAX;
    }
  }
  float mx = -FLT_MAX;
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int j = 0; j < W; ++j)
      if ((threadIdx.x + k * THREADS) * W + j < lim)
        mx = fmaxf(mx, v[k * W + j]);
  mx = block_reduce<WARPS, false>(mx, red_max);
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const bool valid = (threadIdx.x + k * THREADS) * W + j < lim;
      v[k * W + j] = valid ? expf(v[k * W + j] - mx) : 0.0f;
      sum = __fadd_rn(sum, v[k * W + j]);
    }
  sum = fmaxf(block_reduce<WARPS, true>(sum, red_sum), 1e-20f);
  float* orow = out + row * (long long)T;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < nv) {
#pragma unroll
      for (int j = 0; j < W; ++j)
        v[k * W + j] = __fdiv_rn(v[k * W + j], sum);
      store<W>(orow, i, v + k * W);
    }
  }
}

// More than REG_VECTORS vectors: a CTA of LONG_THREADS a row; `staged`
// holds the row in dynamic shared memory (T floats), else the row is read
// again for the sum and the write.
template <int W>
__global__ void __launch_bounds__(LONG_THREADS)
    softmax_long_kernel(const float* __restrict__ x, long long ld_x,
                        const int* __restrict__ lens,
                        float* __restrict__ out, int T, bool staged) {
  constexpr int THREADS = LONG_THREADS, WARPS = THREADS / 32;
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  __shared__ float red_max[WARPS], red_sum[WARPS];
  const long long row = blockIdx.x;
  const int n = __ldg(lens + row);
  const float* xr = x + row * ld_x;
  float* orow = out + row * (long long)T;
  const int nv = T / W;
  const int lim = min(n, T);

  float mx = -FLT_MAX;
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += THREADS) {
    float v[W];
    load<W>(xr, i, v);
    if (staged) store<W>(stage, i, v);
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (i * W + k < lim) mx = fmaxf(mx, v[k]);
  }
  mx = block_reduce<WARPS, false>(mx, red_max);

  // each thread reads back only what it staged: no barrier before this
  float sum = 0.0f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += THREADS) {
    float v[W];
    if (staged)
      load_shared<W>(stage, i, v);
    else
      load<W>(xr, i, v);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      v[k] = i * W + k < lim ? expf(v[k] - mx) : 0.0f;
      sum = __fadd_rn(sum, v[k]);
    }
    if (staged) store<W>(stage, i, v);
  }
  sum = fmaxf(block_reduce<WARPS, true>(sum, red_sum), 1e-20f);

#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += THREADS) {
    float v[W];
    if (staged) {
      load_shared<W>(stage, i, v);
    } else {
      load<W>(xr, i, v);
#pragma unroll
      for (int k = 0; k < W; ++k)
        v[k] = i * W + k < lim ? expf(v[k] - mx) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = __fdiv_rn(v[k], sum);
    store<W>(orow, i, v);
  }
}

template <int NC>
int launch_warp(const float* x, long long ld_x, const int* lens, float* out,
                int B, int T, cudaStream_t s) {
  softmax_warp_kernel<NC><<<(B + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32,
                            0, s>>>(x, ld_x, lens, out, B, T);
  return cudaGetLastError();
}

template <int W>
int launch_long(const float* x, long long ld_x, const int* lens, float* out,
                int B, int T, cudaStream_t s) {
  // the row goes into shared memory where it fits beside the CTA's
  // static bytes (227 KB a CTA on the H100: T up to ~58,000)
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const long long bytes = (long long)T * sizeof(float);
  const bool staged = bytes <= optin - 1024;
  if (staged && bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(softmax_long_kernel<W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
  }
  softmax_long_kernel<W><<<B, LONG_THREADS, staged ? bytes : 0, s>>>(
      x, ld_x, lens, out, T, staged);
  return cudaGetLastError();
}

template <int W, int THREADS>
int launch_cta(const float* x, long long ld_x, const int* lens, float* out,
               int B, int T, cudaStream_t s) {
  softmax_cta_kernel<W, THREADS><<<B, THREADS, 0, s>>>(x, ld_x, lens, out,
                                                      T);
  return cudaGetLastError();
}

template <int W>
int launch(const float* x, long long ld_x, const int* lens, float* out,
           int B, int T, cudaStream_t s) {
  const int nv = T / W;
  if (nv > REG_VECTORS) return launch_long<W>(x, ld_x, lens, out, B, T, s);
  if (nv > 1024) return launch_cta<W, 1024>(x, ld_x, lens, out, B, T, s);
  if (nv > 512) return launch_cta<W, 512>(x, ld_x, lens, out, B, T, s);
  if (nv > 128) return launch_cta<W, 256>(x, ld_x, lens, out, B, T, s);
  if (T > WARP_ROW_MAX)
    return launch_cta<W, 128>(x, ld_x, lens, out, B, T, s);
  return T > 32 ? launch_warp<2>(x, ld_x, lens, out, B, T, s)
                : launch_warp<1>(x, ld_x, lens, out, B, T, s);
}

}  // namespace

// x fp32 [B, T] (row stride ld_x floats), lens int32 [B]; out fp32 [B, T]
// dense.
// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int masked_softmax_fwd(const void* x, long long ld_x,
                                  const void* lens, void* out, int B, int T,
                                  void* stream) {
  if (B <= 0 || T <= 0 || !lens) return cudaErrorInvalidValue;
  const auto xp = static_cast<const float*>(x);
  const auto lp = static_cast<const int*>(lens);
  const auto op = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = T >= VEC_ROW_MIN && T % 4 == 0 && ld_x % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec4 ? launch<4>(xp, ld_x, lp, op, B, T, s)
              : launch<1>(xp, ld_x, lp, op, B, T, s);
}

extern "C" const char* masked_softmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
