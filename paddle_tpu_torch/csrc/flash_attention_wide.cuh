// The wide arm of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): head dims above kMaxHeadDim (256), which the
// reference's kernels take as a block's last dimension and the HeadWidths
// kernels cannot hold in registers or shared memory.
//
// Every CTA owns one column group of GC = 256 output columns (a third grid
// axis of ceil(dp / GC) groups) and 32 resident rows.  It forms the score
// tile S = q.k^T (and in the backward dP = dO.v^T) over the FULL head dim
// by streaming both operands through shared memory in 32-column chunks,
// then computes and writes only its group's columns of out (K1), dK and dV
// (K2a) or dQ (K2b); only group 0 writes the lse and dBias.  Dropout bits
// are keyed by element coordinates, so every group draws the same mask.
// Products run on the CUDA cores in fp32 (fmaf), a simple arm that is
// exact to fp32; its times are in PERF.md.
#pragma once

#include "flash_attention_common.cuh"

namespace flash {
namespace wide {

constexpr int ROWS = 32;      // resident and streamed rows a tile
constexpr int CH = 32;        // head-dim columns a staged chunk
constexpr int CLD = CH + 1;   // a chunk row in shared memory, padded
constexpr int GC = 256;       // output columns a CTA: one column group
constexpr int NG = GC / CH;   // chunks of a column group

__host__ __device__ constexpr int groups(int dp) { return (dp + GC - 1) / GC; }

// Rows [r0, r0 + ROWS) and columns [c0, c0 + CH) of a row-major [n, dp]
// tensor into a [ROWS][CLD] fp32 chunk, by NT threads: rows past n and
// columns past dp as zeros.  Neighbouring threads read neighbouring
// columns.
template <int NT, typename T>
__device__ __forceinline__ void chunk(float* dst, const T* __restrict__ src,
                                      int r0, int n, int c0, int dp) {
  static_assert((ROWS * CH) % NT == 0, "whole passes");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / CH, c = i % CH;
    const bool in = (r0 + r < n) & (c0 + c < dp);
    dst[r * CLD + c] =
        in ? to_float(src[(size_t)(r0 + r) * dp + c0 + c]) : 0.f;
  }
}

// Element (qi, kj) of the bias, read from global memory (0 with no bias);
// qi and kj clamped into the tensor, as the HeadWidths kernels read it.
__device__ __forceinline__ float bias_at(const float* brow, const Bias& bias,
                                         int qi, int kj, int Tq, int Tk) {
  return brow == nullptr
             ? 0.f
             : brow[(size_t)min(qi, Tq - 1) * bias.sq +
                    (size_t)min(kj, Tk - 1) * bias.sk];
}

}  // namespace wide
}  // namespace flash
