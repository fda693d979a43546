// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py::_flash_kernel
// (:74), reached through _flash_call -> pl.pallas_call (:481) from
// flash_attention (:188) and from the custom_vjp forward _flash_fwd (:539).
// It computes
//
//     out = softmax(q . k^T * scale + bias [+ causal mask]) . v
//
// over q [B,H,Tq,D], k and v [B,H,Tk,D] (dense, fp32 or bf16), with the
// running max, the denominator and the accumulator in fp32 registers
// (online softmax over 64-row K/V tiles), and writes out [B,H,Tq,D] in the
// input dtype, and, when asked (the training forward), the per-row
// log-sum-exp lse [B*H,Tq] in fp32 that the backward kernels recompute P
// from: lse = m + log(max(l, 1e-20)), -inf for a row with every score at
// -inf (:135-142).
//
// Design.  One CTA of 256 threads per (b*h, 64-row Q tile); the TPU ran the
// grid (B*H, Tq/block_q) in order and held a whole row's K and V in VMEM,
// here the CTAs run in parallel and a loop inside the CTA walks 64-row K/V
// tiles staged in shared memory (Q, K and V tiles are converted to fp32 on
// load; at D=64 each tile is 16 KB).  The threads form a 16 x 16 grid: a
// thread owns 4 query rows and 1/16 of the tile's columns, both for the
// score tile and for the output accumulator, so the row max and row sum of
// the online softmax are reduced with warp shuffles inside a half-warp and
// the rescale factor never leaves registers.
//   * bias: any float32 tensor that broadcasts to [B,H,Tq,Tk], passed as
//     a base pointer plus four element strides (0 on a broadcast dim).
//     BERT's padding mask [B|1,1,1,Tk] has stride 0 over heads and query
//     rows: it is read per K tile from its [B|1,1,Tk] storage and never
//     broadcast to [B,H,Tq,Tk]; a full bias is read per (q, k) tile.
//   * causal: query i sees keys j <= i (top-left aligned, as the
//     reference), and K tiles wholly above the diagonal are skipped.
//   * ragged Tq and Tk are masked inside the kernel (rows past Tq are not
//     written, keys past Tk score -inf), so every T runs, where the TPU
//     kernel fell back to the composed form for shapes that did not tile.
//   * rows whose every score is -inf give 0, as the TPU kernel's isfinite
//     guards and max(l, 1e-20) give (pallas_kernels.py:107-113, :134).
//   * dropout (:114-124): the denominator l sums the undropped weights;
//     only the weights that enter the accumulator are dropped and scaled
//     by 1/(1-p).  The TPU drew a tile's bits from its hardware generator
//     seeded by (seed, bh, q-tile, k-tile); here each element's bit is
//     Philox at counter (k, q, bh, 0) (flash_attention_common.cuh), so the
//     backward kernels, which tile differently, regenerate it exactly.
//
// What bounds it.  One call does 4*B*H*Tq*Tk*D FLOP and must move q, k, v
// (read once) and out (written once).  At the BERT-base training shape
// (B=32, H=12, T=128, D=64, fp32) that is 1.61 GFLOP against 50 MB: ~24 us
// of fp32 CUDA-core work at 67 TFLOP/s against ~15 us of memory traffic at
// 3.35 TB/s on an H100 SXM, so compute-bound on the fp32 CUDA cores.  With
// dropout each element also costs one Philox4x32-10 (20 32-bit multiplies).
//
// What this simple design leaves on the table: it uses no tensor cores
// (the products are fp32 FMAs on CUDA cores, even for bf16 inputs), no
// asynchronous copies (cp.async / TMA) to overlap the next tile's load with
// this tile's math, and no warp specialisation.  Those are later work.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr size_t smem_bytes() {
  // Q [BQ][D+1], K [BK][D+1], V [BK][D], P [BQ][BK+1], all fp32
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PP);
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, Bias bias, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Tq, int Tk, float scale,
                 int causal, Dropout drop) {
  constexpr int DP = D + 1;       // padded: column reads hit distinct banks
  constexpr int OCOLS = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][DP]
  float* Ks = Qs + BQ * DP;       // [BK][DP]
  float* Vs = Ks + BK * DP;       // [BK][D]
  float* Ps = Vs + BK * D;        // [BQ][PP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;        // column group
  const int ty = tid >> 4;        // row group: rows ty*ROWS .. +ROWS-1
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const size_t q_base = (size_t)bh * Tq * D;
  const size_t kv_base = (size_t)bh * Tk * D;
  const float* brow = bias.ptr ? bias.ptr + b * bias.sb + h * bias.sh
                               : nullptr;

  // stage the Q tile; rows past Tq read as zeros and are never written
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    Qs[r * DP + c] =
        q0 + r < Tq ? to_float(q[q_base + (size_t)(q0 + r) * D + c]) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][OCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Tk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      const bool in = k0 + r < Tk;
      const size_t g = kv_base + (size_t)(k0 + r) * D + c;
      Ks[r * DP + c] = in ? to_float(k[g]) : 0.f;
      Vs[r * D + c] = in ? to_float(v[g]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 rows x 4 columns (tx + 16 j)
    float s[ROWS][KCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[KCOLS];
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float qv = Qs[(ty * ROWS + i) * DP + d];
#pragma unroll
        for (int j = 0; j < KCOLS; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

    // online softmax: scale, bias, masks, then the row max and row sum
    // over the 16 threads of the row (one half-warp)
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = ty * ROWS + i;
      const int qi = q0 + r;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kj >= Tk || (causal && kj > qi)) {
          x = -INFINITY;
        } else if (brow != nullptr && qi < Tq) {
          x += brow[qi * bias.sq + kj * bias.sk];
        }
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      // a row with every score so far at -inf keeps p = 0 and corr = 0
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float p = isfinite(s[i][j]) ? expf(s[i][j] - m_safe) : 0.f;
        ls += p;    // the denominator sums the undropped weights
        float pa = p;
        if (drop.on) pa = drop.keep(kj, qi, bh) ? p * drop.inv_keep : 0.f;
        Ps[r * PP + tx + 16 * j] = pa;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, off);
      l[i] = l[i] * corr + ls;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V for this thread's 4 rows x D/16 columns (tx + 16 c)
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[OCOLS];
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = Ps[(ty * ROWS + i) * PP + kk];
#pragma unroll
        for (int c = 0; c < OCOLS; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + ty * ROWS + i;
    if (qi >= Tq) continue;
    const float lc = fmaxf(l[i], 1e-20f);
    const float inv = 1.f / lc;
    T* o = out + q_base + (size_t)qi * D;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) store(o + tx + 16 * c, acc[i][c] * inv);
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * Tq + qi] = isfinite(m[i]) ? m[i] + logf(lc)
                                                 : -INFINITY;
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, Bias bias,
                   void* out, float* lse, int B, int H, int Tq, int Tk,
                   float scale, int causal, Dropout drop,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB of shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (Tq + BQ - 1) / BQ;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * H, q_tiles);
  flash_fwd_kernel<D, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), lse, H, Tq, Tk,
      scale, causal, drop);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bias and lse may be null.  The
// dropout arm is on when `dropout` is non-zero: keep when Philox word 0 <
// threshold, kept weights times inv_keep.  Returns a cudaError_t (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias,
    void* out, void* lse, int B, int H, int Tq, int Tk, int D, int dtype,
    long long sb, long long sh, long long sq, long long sk, float scale,
    int causal, int dropout, unsigned threshold, unsigned key0,
    unsigned key1, float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return cudaErrorInvalidValue;
  const Bias bb{static_cast<const float*>(bias), sb, sh, sq, sk};
  const Dropout dr{dropout, threshold, key0, key1, inv_keep};
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<64, float>(q, k, v, bb, out, lp, B, H, Tq, Tk, scale,
                             causal, dr, st);
  if (dtype == 0 && D == 128)
    return launch<128, float>(q, k, v, bb, out, lp, B, H, Tq, Tk, scale,
                              causal, dr, st);
  if (dtype == 1 && D == 64)
    return launch<64, __nv_bfloat16>(q, k, v, bb, out, lp, B, H, Tq, Tk,
                                     scale, causal, dr, st);
  if (dtype == 1 && D == 128)
    return launch<128, __nv_bfloat16>(q, k, v, bb, out, lp, B, H, Tq, Tk,
                                      scale, causal, dr, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
