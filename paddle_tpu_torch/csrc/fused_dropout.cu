// Fused dropout (K10) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py::
// _dropout_kernel (:1405), reached through _dropout_call ->
// pl.pallas_call (:1426) from fused_dropout (:1454), which the `dropout`
// op runs in training under FLAGS_use_fused_dropout (paddle_tpu/ops/
// nn_ops.py:311-330); its vjp (_dropout_fused_bwd, :1445) runs the same
// kernel on the cotangent with the same seed.  Over x [n] (any shape,
// row-major) it computes
//
//     out[i] = keep(i) ? x[i] * scale : 0
//
// with scale = 1/(1-p) (upscale_in_train; the float32 rounding the
// wrapper passes) or 1 (downgrade_in_infer), in float32, rounded to the
// element type.  keep(i): word i % 4 of Philox4x32-10 at counter
// (i / 4 low word, i / 4 high word, 0, 0) under key (k0, k1) is below
// `threshold` = round((1-p) * 2^32) — the bits registry.dropout_keep
// draws in torch, so the kernel equals its plain version bit for bit.
//
// Design.  The TPU kernel drew its bits from the TPU's hardware generator
// per (seed, tile) in VMEM, over a 2-D view it needed n % 128 == 0 for;
// here the bits are keyed by the element index, so every shape runs, the
// tiling is free, and the backward regenerates the same mask from the
// seed.  One thread takes four consecutive elements from one Philox call
// (the four words): a 16-byte (fp32) or 8-byte (bf16) load and store when
// both pointers are aligned, element by element for the ragged tail or a
// misaligned pointer.  The keep bits stay in registers: no mask tensor is
// read or written.  A grid-stride loop over the groups of four, at most
// 32 blocks of 256 threads per SM.
//
// What bounds it.  One call reads x once and writes out once: 8 B an
// element in fp32, 4 B in bf16.  At BERT-base's [32, 128, 768] fp32 that
// is 25.2 MB, 7.5 us at the H100 SXM's published 3.35 TB/s.  Philox costs
// about 20 integer operations an element, which the memory time covers.

#include "flash_attention_common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float apply(float v, bool keep, float scale) {
  return keep ? v * scale : 0.0f;
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ float4 apply4(float4 v, const bool* keep,
                                         float scale) {
  return make_float4(apply(v.x, keep[0], scale), apply(v.y, keep[1], scale),
                     apply(v.z, keep[2], scale), apply(v.w, keep[3], scale));
}

__device__ __forceinline__ uint2 apply4(uint2 v, const bool* keep,
                                        float scale) {
  __nv_bfloat16 e[4];
  *reinterpret_cast<uint2*>(e) = v;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    e[i] = __float2bfloat16_rn(apply(__bfloat162float(e[i]), keep[i], scale));
  return *reinterpret_cast<const uint2*>(e);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fused_dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                         long long n, uint32_t threshold, uint32_t k0,
                         uint32_t k1, const long long* step, float scale,
                         int vec) {
  using V = typename Vec<T>::type;
  flash::key_at_step(step, k0, k1);
  const long long groups = (n + 3) >> 2;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
       j < groups; j += stride) {
    const uint4 w = flash::philox4((uint32_t)j, (uint32_t)(j >> 32), 0u, 0u,
                                   k0, k1);
    const bool keep[4] = {w.x < threshold, w.y < threshold, w.z < threshold,
                          w.w < threshold};
    const long long base = j << 2;
    if (vec && base + 4 <= n) {
      const V v = __ldg(reinterpret_cast<const V*>(x + base));
      *reinterpret_cast<V*>(out + base) = apply4(v, keep, scale);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (base + e < n)
          flash::store(out + base + e,
                       apply(flash::to_float(x[base + e]), keep[e], scale));
    }
  }
}

template <typename T>
int launch(const void* x, void* out, long long n, uint32_t threshold,
           uint32_t k0, uint32_t k1, const long long* step, float scale,
           int vec, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long groups = (n + 3) >> 2;
  long long blocks = (groups + THREADS - 1) / THREADS;
  const long long cap = 32LL * (sms > 0 ? sms : 132);
  if (blocks > cap) blocks = cap;
  fused_dropout_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, threshold, k0, k1,
      step, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// x and out dense [n] of one type: dtype 0 = float32, 1 = bfloat16.  The
// key is (k0, k1), or, when `step` (an int64 in device memory) is not
// null, the key at that step (flash::key_at_step).  `vec` is set when
// both pointers are aligned to four elements (16 B fp32, 8 B bf16).
// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int fused_dropout_fwd(const void* x, void* out, long long n,
                                 int dtype, unsigned threshold, unsigned k0,
                                 unsigned k1, const void* step, float scale,
                                 int vec, void* stream) {
  if (n <= 0 || !x || !out) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = static_cast<const long long*>(step);
  if (dtype == 0)
    return launch<float>(x, out, n, threshold, k0, k1, st, scale, vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, out, n, threshold, k0, k1, st, scale,
                                 vec, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* fused_dropout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
