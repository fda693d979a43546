// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): fp32/bf16 loads and stores, the additive bias
// as a pointer plus four element strides, and the dropout arm's
// counter-based random bits (Philox, which fused_dropout.cu draws from
// too).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Any float32 tensor that broadcasts to [B,H,Tq,Tk], as a base pointer and
// four element strides (0 on a broadcast dim); ptr is null for no bias.
struct Bias {
  const float* ptr;
  long long sb, sh, sq, sk;
};

// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32): the four
// output words (registry.philox4x32 computes the same in torch).
__device__ __forceinline__ uint4 philox4(uint32_t c0, uint32_t c1,
                                         uint32_t c2, uint32_t c3,
                                         uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The first output word.  The counter is an element's coordinates, so
// every kernel regenerates the same bit for the same (k, q, b*h) whatever
// its tiling.
__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
  return philox4(c0, c1, c2, c3, k0, k1).x;
}

// Dropout on the softmax weights: element (q, k) of head bh is kept when
// word 0 of Philox at counter (k, q, bh, 0) under key (k0, k1) is below
// `threshold` = round((1-p) * 2^32); kept weights are scaled by inv_keep.
struct Dropout {
  int on;
  uint32_t threshold, k0, k1;
  float inv_keep;
  __device__ __forceinline__ bool keep(int kj, int qi, int bh) const {
    return philox_word0((uint32_t)kj, (uint32_t)qi, (uint32_t)bh, 0u, k0,
                        k1) < threshold;
  }
};

}  // namespace flash

extern "C" const char* flash_attention_error_string(int err);
