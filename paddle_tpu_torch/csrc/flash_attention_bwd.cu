// FlashAttention-2 backward for Hopper (sm_90a), plain C interface: two
// kernels, as the TPU had.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels.py::
// _flash_bwd_impl (:733), the backward of the custom_vjp _flash_p (:495):
//   * flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel (:558, pl.pallas_call
//     :791): dK and dV, one CTA per (b*h, 64-row K tile), looping over Q
//     tiles (causal: from the diagonal tile, :619);
//   * flash_bwd_dq_kernel <- _flash_bwd_dq_kernel (:625, pl.pallas_call
//     :835): dQ, one CTA per (b*h, 64-row Q tile), looping over K tiles
//     (causal: up to the diagonal), and dBias.
// Both recompute the score tile S = q.k^T*scale + bias and P = exp(S -
// lse) from the forward's per-row lse, with dP = dO.V^T and, from delta =
// rowsum(dO.O) computed before the kernels in fp32,
//     dV += drop(P)^T dO,  dS = P * (drop(dP) - delta),
//     dK += dS^T Q * scale,  dQ += dS K * scale,  dBias = dS,
// where drop() zeroes the elements the forward dropped and scales the kept
// ones by 1/(1-p): the same Philox bit per element (k, q, bh) as the
// forward kernel draws (flash_attention_common.cuh), whatever the tiling.
// Rows whose lse is -inf (every score masked) and masked scores give P = 0,
// as the TPU kernels' isfinite guards (:596-600, :640-642).
//
// dBias.  The TPU's grid ran in order, so one resident (1,1,Tk) block was
// revisited by every head and q tile of a batch row and summed there
// (:646-658, :684-688).  Here CTAs run in parallel in no order, so:
//   * row bias [B|1,1,1,Tk] (dbias_mode 1): each CTA sums dS over its 64
//     q rows per key column in shared memory, then adds the column sums to
//     a zeroed [B, Tk] fp32 buffer with atomicAdd; the wrapper sums over
//     the batch for a [1,1,1,Tk] bias.  Atomics add in a different order
//     on every run, so the result varies in its last bits (the tolerance
//     against the plain version is stated where it is checked).
//   * any other bias (dbias_mode 2): dS is written whole, [B*H, Tq, Tk]
//     fp32, by the CTA that owns the q rows, into a zeroed buffer (a
//     causal run never visits the tiles above the diagonal), and the
//     wrapper sums it down to the bias's shape.
//
// What bounds them.  K2a does 8*B*H*Tq*Tk*D FLOP (four products per tile:
// S, dP, dV, dK), K2b 6*B*H*Tq*Tk*D (S, dP, dQ).  At the BERT-base
// training shape (B=32, H=12, T=128, D=64, fp32) that is 3.22 and 2.42
// GFLOP, ~48 and ~36 us of fp32 CUDA-core work at 67 TFLOP/s on an H100
// SXM, against ~25 us each of memory traffic (q, k, v, dO read once, two
// gradients written once): compute-bound.
//
// What this simple design leaves on the table, as the forward: no tensor
// cores, no asynchronous copies, no warp specialisation; and K2a and K2b
// each recompute S and dP, where one kernel with atomic dQ would do it
// once.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO [64][D+1]; P, dS [64][BK+1]; lse, delta [64]; all fp32
  return sizeof(float) *
         (size_t)(4 * 64 * (D + 1) + 2 * BQ * PP + 2 * BQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V [64][D+1]; dS [64][BK+1]; column partials [16][BK]
  return sizeof(float) * (size_t)(4 * 64 * (D + 1) + BQ * PP + 16 * BK);
}

// Stage `rows` rows of a [*, D] tensor from row r0 into shared [64][D+1],
// rows past `n` as zeros.
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int n) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    dst[r * DP + c] = r0 + r < n ? to_float(src[(size_t)(r0 + r) * D + c])
                                 : 0.f;
  }
}

// s = A B^T and dp = C E^T for this thread's 4 rows (ty*4+i of A, C) x 4
// columns (tx+16j of B, E), all four operands [64][D+1] in shared memory.
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* B,
                                             const float* C, const float* E,
                                             float s[ROWS][KCOLS],
                                             float dp[ROWS][KCOLS]) {
  constexpr int DP = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < KCOLS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float bv[KCOLS], ev[KCOLS];
#pragma unroll
    for (int j = 0; j < KCOLS; ++j) {
      bv[j] = B[(tx + 16 * j) * DP + d];
      ev[j] = E[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float av = A[(ty * ROWS + i) * DP + d];
      const float cv = C[(ty * ROWS + i) * DP + d];
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        s[i][j] = fmaf(av, bv[j], s[i][j]);
        dp[i][j] = fmaf(cv, ev[j], dp[i][j]);
      }
    }
  }
}

// The score of (qi, kj) from its raw product: scale, bias, masks.
__device__ __forceinline__ float score(float raw, int qi, int kj, int Tq,
                                       int Tk, float scale, int causal,
                                       const float* brow, const Bias& bias) {
  if (kj >= Tk || (causal && kj > qi)) return -INFINITY;
  float x = raw * scale;
  if (brow != nullptr && qi < Tq) x += brow[qi * bias.sq + kj * bias.sk];
  return x;
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, Bias bias,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk, float scale,
                     int causal, Dropout drop) {
  constexpr int DP = D + 1;
  constexpr int OCOLS = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;               // [BK][DP]
  float* Vs = Ks + BK * DP;       // [BK][DP]
  float* Qs = Vs + BK * DP;       // [BQ][DP]
  float* dOs = Qs + BQ * DP;      // [BQ][DP]
  float* Ps = dOs + BQ * DP;      // [BQ][PP]: drop(P), dV's operand
  float* dSs = Ps + BQ * PP;      // [BQ][PP]
  float* lse_s = dSs + BQ * PP;   // [BQ]
  float* dl_s = lse_s + BQ;       // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * BK;
  const T* qb = q + (size_t)bh * Tq * D;
  const T* dob = dout + (size_t)bh * Tq * D;
  const size_t kv_base = (size_t)bh * Tk * D;
  const float* brow = bias.ptr ? bias.ptr + b * bias.sb + h * bias.sh
                               : nullptr;

  stage<D>(Ks, k + kv_base, k0, Tk);
  stage<D>(Vs, v + kv_base, k0, Tk);

  float dk_acc[ROWS][OCOLS], dv_acc[ROWS][OCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: q tiles wholly above this K tile's first key see none of it
  const int t0 = causal ? k0 / BQ : 0;
  const int n_q_tiles = (Tq + BQ - 1) / BQ;
  for (int t = t0; t < n_q_tiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous tile's readers are done
    stage<D>(Qs, qb, q0, Tq);
    stage<D>(dOs, dob, q0, Tq);
    if (tid < BQ) {
      const bool in = q0 + tid < Tq;
      lse_s[tid] = in ? lse[(size_t)bh * Tq + q0 + tid] : -INFINITY;
      dl_s[tid] = in ? delta[(size_t)bh * Tq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // rows of S and dP are q (ty*4+i), columns are k (tx+16j)
    float s[ROWS][KCOLS], dp[ROWS][KCOLS];
    two_products<D>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = ty * ROWS + i;
      const int qi = q0 + r;
      const float ls = lse_s[r], dl = dl_s[r];
      const bool lse_fin = isfinite(ls);
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float x = score(s[i][j], qi, kj, Tq, Tk, scale, causal, brow,
                              bias);
        const float p = isfinite(x) && lse_fin ? expf(x - ls) : 0.f;
        float pd = p, dpe = dp[i][j];
        if (drop.on) {
          const bool kp = drop.keep(kj, qi, bh);
          pd = kp ? p * drop.inv_keep : 0.f;
          dpe = kp ? dpe * drop.inv_keep : 0.f;
        }
        Ps[r * PP + tx + 16 * j] = pd;
        dSs[r * PP + tx + 16 * j] = p * (dpe - dl);
      }
    }
    __syncthreads();

    // dV += drop(P)^T dO, dK += dS^T Q for this thread's 4 K rows x D/16
    // columns (tx + 16 c)
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float ov[OCOLS], qv[OCOLS];
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) {
        ov[c] = dOs[qq * DP + tx + 16 * c];
        qv[c] = Qs[qq * DP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float pv = Ps[qq * PP + ty * ROWS + i];
        const float sv = dSs[qq * PP + ty * ROWS + i];
#pragma unroll
        for (int c = 0; c < OCOLS; ++c) {
          dv_acc[i][c] = fmaf(pv, ov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sv, qv[c], dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int kr = k0 + ty * ROWS + i;
    if (kr >= Tk) continue;
    T* dkr = dk + kv_base + (size_t)kr * D;
    T* dvr = dv + kv_base + (size_t)kr * D;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) {
      store(dkr + tx + 16 * c, dk_acc[i][c] * scale);
      store(dvr + tx + 16 * c, dv_acc[i][c]);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, Bias bias,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    float* __restrict__ dbias, int dbias_mode, int H,
                    int Tq, int Tk, float scale, int causal, Dropout drop) {
  constexpr int DP = D + 1;
  constexpr int OCOLS = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][DP]
  float* dOs = Qs + BQ * DP;      // [BQ][DP]
  float* Ks = dOs + BQ * DP;      // [BK][DP]
  float* Vs = Ks + BK * DP;       // [BK][DP]
  float* dSs = Vs + BK * DP;      // [BQ][PP]
  float* red = dSs + BQ * PP;     // [16][BK]: row-dBias column partials

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const size_t q_base = (size_t)bh * Tq * D;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const float* brow = bias.ptr ? bias.ptr + b * bias.sb + h * bias.sh
                               : nullptr;

  stage<D>(Qs, q + q_base, q0, Tq);
  stage<D>(dOs, dout + q_base, q0, Tq);
  float ls[ROWS], dl[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + ty * ROWS + i;
    ls[i] = qi < Tq ? lse[(size_t)bh * Tq + qi] : -INFINITY;
    dl[i] = qi < Tq ? delta[(size_t)bh * Tq + qi] : 0.f;
  }

  float dq_acc[ROWS][OCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) dq_acc[i][c] = 0.f;

  int n_tiles = (Tk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    stage<D>(Ks, kb, k0, Tk);
    stage<D>(Vs, vb, k0, Tk);
    __syncthreads();

    float s[ROWS][KCOLS], dp[ROWS][KCOLS];
    two_products<D>(Qs, Ks, dOs, Vs, s, dp);
    float colsum[KCOLS];
#pragma unroll
    for (int j = 0; j < KCOLS; ++j) colsum[j] = 0.f;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = ty * ROWS + i;
      const int qi = q0 + r;
      const bool lse_fin = isfinite(ls[i]);
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float x = score(s[i][j], qi, kj, Tq, Tk, scale, causal, brow,
                              bias);
        const float p = isfinite(x) && lse_fin ? expf(x - ls[i]) : 0.f;
        float dpe = dp[i][j];
        if (drop.on) dpe = drop.keep(kj, qi, bh) ? dpe * drop.inv_keep : 0.f;
        const float ds = p * (dpe - dl[i]);
        dSs[r * PP + tx + 16 * j] = ds;
        colsum[j] += ds;
        if (dbias_mode == 2 && qi < Tq && kj < Tk)
          dbias[((size_t)bh * Tq + qi) * Tk + kj] = ds;
      }
    }
    if (dbias_mode == 1) {
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) red[ty * BK + tx + 16 * j] = colsum[j];
    }
    __syncthreads();

    if (dbias_mode == 1 && tid < BK && k0 + tid < Tk) {
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < 16; ++g) sum += red[g * BK + tid];
      atomicAdd(dbias + (size_t)b * Tk + k0 + tid, sum);
    }
    // dQ += dS K for this thread's 4 rows x D/16 columns (tx + 16 c)
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float kv[OCOLS];
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) kv[c] = Ks[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float dsv = dSs[(ty * ROWS + i) * PP + kk];
#pragma unroll
        for (int c = 0; c < OCOLS; ++c)
          dq_acc[i][c] = fmaf(dsv, kv[c], dq_acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + ty * ROWS + i;
    if (qi >= Tq) continue;
    T* dqr = dq + q_base + (size_t)qi * D;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c)
      store(dqr + tx + 16 * c, dq_acc[i][c] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, Tq, Tk;
  float scale;
  int causal;
  Bias bias;
  Dropout drop;
};

template <int D, typename T>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t st) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.Tk + BK - 1) / BK;
  if (tiles > 65535) return cudaErrorInvalidValue;
  flash_bwd_dkv_kernel<D, T><<<dim3(a.B * a.H, tiles), THREADS, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.Tq,
      a.Tk, a.scale, a.causal, a.drop);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dq(const Args& a, void* dq, float* dbias, int mode,
                      cudaStream_t st) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.Tq + BQ - 1) / BQ;
  if (tiles > 65535) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<D, T><<<dim3(a.B * a.H, tiles), THREADS, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(dq), dbias, mode, a.H, a.Tq, a.Tk,
      a.scale, a.causal, a.drop);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* bias,
               const void* dout, const void* lse, const void* delta, int B,
               int H, int Tq, int Tk, long long sb, long long sh,
               long long sq, long long sk, float scale, int causal,
               int dropout, unsigned threshold, unsigned key0,
               unsigned key1, float inv_keep) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), B, H, Tq, Tk, scale, causal,
              Bias{static_cast<const float*>(bias), sb, sh, sq, sk},
              Dropout{dropout, threshold, key0, key1, inv_keep}};
}

}  // namespace

// Both entry points: dtype 0 = float32, 1 = bfloat16; bias may be null;
// lse and delta are [B*H, Tq] fp32.  Return a cudaError_t (0 on success);
// the launch is asynchronous on `stream`.
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int D, int dtype, long long sb,
    long long sh, long long sq, long long sk, float scale, int causal,
    int dropout, unsigned threshold, unsigned key0, unsigned key1,
    float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, bias, dout, lse, delta, B, H, Tq, Tk,
                           sb, sh, sq, sk, scale, causal, dropout, threshold,
                           key0, key1, inv_keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_dkv<64, float>(a, dk, dv, st);
  if (dtype == 0 && D == 128) return launch_dkv<128, float>(a, dk, dv, st);
  if (dtype == 1 && D == 64)
    return launch_dkv<64, __nv_bfloat16>(a, dk, dv, st);
  if (dtype == 1 && D == 128)
    return launch_dkv<128, __nv_bfloat16>(a, dk, dv, st);
  return cudaErrorInvalidValue;
}

// dbias_mode: 0 none, 1 row ([B, Tk] fp32, zeroed, summed atomically),
// 2 full ([B*H, Tq, Tk] fp32, zeroed).
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dq,
    void* dbias, int dbias_mode, int B, int H, int Tq, int Tk, int D,
    int dtype, long long sb, long long sh, long long sq, long long sk,
    float scale, int causal, int dropout, unsigned threshold, unsigned key0,
    unsigned key1, float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return cudaErrorInvalidValue;
  if (dbias_mode < 0 || dbias_mode > 2 || (dbias_mode && !dbias))
    return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, bias, dout, lse, delta, B, H, Tq, Tk,
                           sb, sh, sq, sk, scale, causal, dropout, threshold,
                           key0, key1, inv_keep);
  float* db = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dq<64, float>(a, dq, db, dbias_mode, st);
  if (dtype == 0 && D == 128)
    return launch_dq<128, float>(a, dq, db, dbias_mode, st);
  if (dtype == 1 && D == 64)
    return launch_dq<64, __nv_bfloat16>(a, dq, db, dbias_mode, st);
  if (dtype == 1 && D == 128)
    return launch_dq<128, __nv_bfloat16>(a, dq, db, dbias_mode, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
