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
// Design.  One CTA of 256 threads per row; a strided loop inside the CTA
// walks T (the TPU kernel held a [bb, T] block in VMEM per grid step and
// served only T % 128 == 0, composing in XLA otherwise, :1363; here every T
// runs).  Three passes over the row, each a coalesced strided read: the
// max, then the sum of exponentials, then the normalised write, with a
// warp-shuffle and shared-memory block reduction after the first two; the
// second and third passes find the row in L1/L2.  Accurate expf and IEEE
// division, no fast-math intrinsics.
//
// What bounds it.  One call reads x and the lengths once and writes out
// once: 8 B an element.  At the sequence-softmax program's
// [16, 128] that is 16 KB, 5 ns at the H100 SXM's published 3.35 TB/s;
// chip_smoke.py measures about 0.006 ms a call ("NVIDIA H100 80GB HBM3,
// 700.00 W"): launch latency, as for any single small row softmax.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Reduce `v` over the CTA with `op`; every thread gets the result.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* scratch,
                                              Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) v = op(v, scratch[w]);
  __syncthreads();            // scratch is reused by the next reduction
  return v;
}

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Add {
  __device__ float operator()(float a, float b) const { return a + b; }
};

__global__ void __launch_bounds__(THREADS)
    masked_softmax_kernel(const float* __restrict__ x, long long ld_x,
                          const int* __restrict__ lens,
                          float* __restrict__ out, int T) {
  __shared__ float scratch[WARPS];
  const long long row = blockIdx.x;
  const float* xr = x + row * ld_x;
  float* orow = out + row * (long long)T;
  const int n = __ldg(lens + row);

  float mx = -FLT_MAX;
  for (int t = threadIdx.x; t < n && t < T; t += THREADS)
    mx = fmaxf(mx, __ldg(xr + t));
  mx = block_reduce(mx, scratch, Max());

  float sum = 0.0f;
  for (int t = threadIdx.x; t < n && t < T; t += THREADS)
    sum += expf(__ldg(xr + t) - mx);
  sum = fmaxf(block_reduce(sum, scratch, Add()), 1e-20f);

  for (int t = threadIdx.x; t < T; t += THREADS)
    orow[t] = t < n ? __fdiv_rn(expf(__ldg(xr + t) - mx), sum) : 0.0f;
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
  masked_softmax_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ld_x, static_cast<const int*>(lens),
      static_cast<float*>(out), T);
  return cudaGetLastError();
}

extern "C" const char* masked_softmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
