// Flash-attention forward for Hopper (sm_90a), plain C interface, on the
// tensor cores.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py::_flash_kernel
// (:74), reached through _flash_call -> pl.pallas_call (:481) from
// flash_attention (:188), from the custom_vjp forward _flash_fwd (:539)
// and from flash_attention_with_lse (:883).  It computes
//
//     out = softmax(q . k^T * scale + bias [+ causal mask]) . v
//
// over q [B,H,Tq,d], k and v [B,H,Tk,d] (dense, fp32 or bf16, any head
// dim; see flash_attention_mma.cuh for how d <= 256 maps onto the
// instantiated widths, and flash_attention_wide.cuh for the arm that
// takes d > 256), with the running max, the denominator and the
// accumulator in fp32 registers (an online softmax over K/V tiles), and
// writes out [B,H,Tq,d] in the input dtype and, when asked (the training
// forward, K3), the per-row log-sum-exp lse [B*H,Tq] in fp32 that the
// backward kernels recompute P from: lse = m + log(max(l, 1e-20)), -inf
// for a row with every score at -inf (:135-142).
//
// Semantics kept from the reference kernel:
//   * bias: any float32 tensor that broadcasts to [B,H,Tq,Tk], as a base
//     pointer plus four element strides (0 on a broadcast dim).  A bias
//     that does not vary over query rows (BERT's padding mask [B|1,1,1,Tk])
//     is staged per K tile with the tile, never broadcast in memory; a
//     full bias is read per (q, k) fragment from global memory.
//   * causal: query i sees keys j <= i (top-left aligned, as the
//     reference); K tiles wholly right of a warp's last row are skipped.
//   * ragged Tq and Tk are masked inside the kernel, so every T runs,
//     where the TPU kernel fell back to the composed form off-tile.
//   * rows whose every score is -inf give 0, as the TPU kernel's isfinite
//     guards and max(l, 1e-20) give (:107-113, :134).
//   * dropout (:114-124): the denominator l sums the undropped weights;
//     only the weights that enter the accumulator are dropped and scaled
//     by 1/(1-p).  Each element's bit is Philox at counter (k, q, bh, 0)
//     (flash_attention_common.cuh), so the backward kernels, which tile
//     differently, regenerate it exactly.
//
// What bounds it.  One call does 4*B*H*Tq*Tk*d FLOP and must move q, k, v,
// the bias (read once) and out, lse (written once).  At the BERT-base
// training shape (B=32, H=12, T=128, d=64, fp32, row bias) that is 1.61
// GFLOP against 50 MB: ~15 us of memory traffic at 3.35 TB/s on an H100
// SXM, ~10 us of 3xTF32 products at a third of the 495 TFLOP/s TF32 peak
// (bf16: ~7.5 us of bytes, the products ~2 us).  With dropout each
// element also costs one Philox4x32-10 (~36 instructions).
//
// The design (as the backward kernels, flash_attention_bwd.cu):
//   * CTAs of 4 warps, one per (b*h, 64 query rows); each warp owns 16
//     rows.  Causal grids start with the longest Q tiles.  K/V tiles of 32
//     rows and registers for 3 CTAs an SM (55 KB of shared memory at W 64
//     fp32), so the ring shard's 384 CTAs fill one wave (the tile
//     measurements are in PERF.md).
//   * Products on the tensor cores through warp-level mma.sync: fp32
//     operands in 3xTF32 (m16n8k8; x = hi + lo, hi rounded to TF32 in two
//     integer operations, a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in
//     fp32), which keeps fp32's accuracy; bf16 operands in m16n8k16 with
//     fp32 accumulation.
//   * Q is loaded once.  Its A fragments stay in registers where they
//     take at most 64 a thread: bf16 up to W 128 (W / 4 registers), fp32,
//     whose hi/lo pair takes W, up to W 64; otherwise each tile reads them
//     from the Q tile in shared memory (and splits them).
//   * S = Q.K^T stays in the accumulator registers.  The online softmax
//     reduces the row max over the 4 threads of a row (quad shuffles); the
//     row sum stays per thread until the end; the rescale multiplies the
//     accumulator fragments.  The elementwise step is branch-free (masks
//     are selects), with one uniform branch for the dropout arm.
//   * P enters P.V from the S accumulators.  fp32: split in 3xTF32, with
//     the k order permuted as in the backward (an accumulator's columns
//     2t, 2t+1 are an A fragment's k = t, t+4).  bf16: the m16n8k16
//     accumulator layout is the A layout as it stands; P is carried as a
//     bf16 hi + lo pair (P = hi + lo to ~2^-17 relative, two products), so
//     the bf16 arm's only rounding beyond fp32 is its inputs' and its
//     output's.  V's B fragments come by ldmatrix.trans.
//   * The tensor cores sum with truncation, so each K/V tile's P.V part is
//     summed in a fresh accumulator and added to the running one in fp32
//     round-to-nearest.
//   * K and V tiles (and the row bias) are double-buffered with 16-byte
//     cp.async into rows padded by 8 elements (fp32 rows XOR-swizzled), so
//     tile t+1 loads while tile t's products run and every fragment load
//     is free of bank conflicts.

#include "flash_attention_mma.cuh"
#include "flash_attention_wide.cuh"

namespace {

using namespace flash;

template <int W, typename T>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int NT = 128;  // 4 warps
  static constexpr int BM = 64;   // query rows, 16 a warp
  static constexpr int BN = 32;   // K/V rows a tile
  static constexpr int LD = ld<W>();
  // Q's A fragments in registers: at most 64 a thread
  static constexpr bool QREG = F32 ? W <= 64 : W <= 128;
  // Q [BM], K and V two stages of [BN] rows, the row bias two of [BN]
  static constexpr size_t SMEM =
      sizeof(T) * (size_t)(BM + 4 * BN) * LD + sizeof(float) * 2 * BN;
  // CTAs an SM that the registers are sized for: 3 (a thread then has 170
  // registers), as far as shared memory fits
  static constexpr int FIT = (int)(232448 / (SMEM + 1024));
  static constexpr int MINB = FIT < 3 ? (FIT > 0 ? FIT : 1) : 3;
};

// The bf16 A fragment (16 x 16) of rows r0.. and columns c0.. of a tile.
template <int LD>
__device__ __forceinline__ void load_a_bf16(uint32_t (&a)[4],
                                            const __nv_bfloat16* X, int r0,
                                            int c0, int g, int t) {
  a[0] = ld_b32<LD>(X, r0 + g, c0 + 2 * t);
  a[1] = ld_b32<LD>(X, r0 + g + 8, c0 + 2 * t);
  a[2] = ld_b32<LD>(X, r0 + g, c0 + 8 + 2 * t);
  a[3] = ld_b32<LD>(X, r0 + g + 8, c0 + 8 + 2 * t);
}

// x, y as bf16 pairs hi + lo (hi rounded to nearest, lo the rounded rest).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - f.x, y - f.y);
}

template <int W, typename T>
__global__ void __launch_bounds__(Cfg<W, T>::NT, Cfg<W, T>::MINB)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, Bias bias, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Tq, int Tk, int d,
                 float scale, int causal, Dropout drop_arg) {
  const Dropout drop = drop_arg.at_step();
  using C = Cfg<W, T>;
  constexpr int NT = C::NT, BM = C::BM, BN = C::BN, LD = C::LD;
  constexpr bool F32 = C::F32, QREG = C::QREG;
  constexpr int NJ = BN / 8;  // 8-key blocks of S a tile
  constexpr int ND = W / 8;   // 8-column blocks of the output
  constexpr int NQ = QREG ? (F32 ? W / 8 : W / 16) : 1;  // Q fragments
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [BM][LD]
  T* Ks = Qs + BM * LD;                // [2][BN][LD]
  T* Vs = Ks + 2 * BN * LD;            // [2][BN][LD]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * BN * LD);  // [2][BN]

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  // causal: the longest rows (the last Q tile) start first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  const size_t q_base = (size_t)bh * Tq * d;
  const T* kb = k + (size_t)bh * Tk * d;
  const T* vb = v + (size_t)bh * Tk * d;
  const float* brow = bias.ptr ? bias.ptr + b * bias.sb + h * bias.sh
                               : nullptr;
  // a bias constant over query rows ([B|1,1,1,Tk]) is staged per K tile
  const bool row_bias = brow != nullptr && bias.sq == 0;

  auto stage_kv = [&](int tile, int st) {
    const int k0 = tile * BN;
    stage<BN, W, NT>(Ks + st * BN * LD, kb, k0, Tk, d);
    stage<BN, W, NT>(Vs + st * BN * LD, vb, k0, Tk, d);
    if (row_bias && threadIdx.x < BN)
      stage_entry(Bs + st * BN, brow, k0, Tk, threadIdx.x, bias.sk);
  };

  int nt = (Tk + BN - 1) / BN;
  if (causal) nt = min(nt, (q0 + BM - 1) / BN + 1);
  stage<BM, W, NT>(Qs, q + q_base, q0, Tq, d);
  cp_commit();
  stage_kv(0, 0);
  cp_commit();

  const int r0 = 16 * w;       // the warp's rows of the tile
  const int qr = q0 + r0 + g;  // this thread's rows: qr and qr + 8

  // Q's A fragments, loaded (and split) once where registers allow
  uint32_t qh[NQ][4], ql[NQ][4];
  if constexpr (QREG) {
    cp_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      if constexpr (F32) {
        float a[4];
        load_a<LD>(a, Qs, r0, 8 * kk, g, t);
        split<true>(a, qh[kk], ql[kk]);
      } else {
        load_a_bf16<LD>(qh[kk], Qs, r0, 16 * kk, g, t);
      }
    }
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = 0, st = 0; tile < nt; ++tile, st ^= 1) {
    if (tile + 1 < nt) stage_kv(tile + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int k0 = tile * BN;
    const T* Kt = Ks + st * BN * LD;
    const T* Vt = Vs + st * BN * LD;
    const float* bt = Bs + st * BN;
    // causal: a tile wholly right of the warp's last row adds nothing
    if (!causal || k0 <= q0 + r0 + 15) {
      // S = Q K^T: 16 rows x BN keys a warp, in the accumulators
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (F32) {
#pragma unroll
        for (int kk = 0; kk < W / 8; ++kk) {
          if (8 * kk >= d) break;
          uint32_t ah[4], al[4];
          if constexpr (QREG) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ah[i] = qh[kk][i];
              al[i] = ql[kk][i];
            }
          } else {
            float a[4];
            load_a<LD>(a, Qs, r0, 8 * kk, g, t);
            split<true>(a, ah, al);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            float bf[2];
            uint32_t bh2[2], bl2[2];
            load_bt<LD>(bf, Kt, 8 * j, 8 * kk, g, t);
            split<true>(bf, bh2, bl2);
            mma(s[j], al, bh2);
            mma(s[j], ah, bl2);
            mma(s[j], ah, bh2);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk) {
          if (16 * kk >= d) break;
          uint32_t a[4];
          if constexpr (QREG) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = qh[kk][i];
          } else {
            load_a_bf16<LD>(a, Qs, r0, 16 * kk, g, t);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mma_bf16(s[j], a, ld_b32<LD>(Kt, 8 * j + g, 16 * kk + 2 * t),
                     ld_b32<LD>(Kt, 8 * j + g, 16 * kk + 8 + 2 * t));
        }
      }

      // scale, bias and masks; element (qi, kj) at s[j][e]: row r = e / 2
      // (qr + 8 r), column 8 j + 2 t + e % 2
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * j + 2 * t + (e & 1);
          const int qi = qr + 8 * r, kj = k0 + c;
          const bool valid = (kj < Tk) & !(causal & (kj > qi));
          float x = s[j][e] * scale;
          if (brow != nullptr)
            x += row_bias ? bt[c]
                          : brow[(size_t)min(qi, Tq - 1) * bias.sq +
                                 (size_t)min(kj, Tk - 1) * bias.sk];
          s[j][e] = valid ? x : -INFINITY;
          mt[r] = fmaxf(mt[r], s[j][e]);
        }
      }
      // the online softmax: row max over the quad, rescale factor
      float ms[2], corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float mn = fmaxf(m[r], mt[r]);
        // a row with every score so far at -inf keeps p = 0 and corr = 0
        ms[r] = mn == -INFINITY ? 0.f : mn;
        corr[r] = expf(m[r] - ms[r]);
        m[r] = mn;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - ms[e >> 1]);
          ls[e >> 1] += p;  // the denominator sums the undropped weights
          s[j][e] = p;
        }
      // this thread's part of the row sums; the quad's are summed at the end
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ls[r];
      if (drop.on) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool kp = drop.keep(k0 + 8 * j + 2 * t + (e & 1),
                                      qr + 8 * (e >> 1), bh);
            s[j][e] = kp ? s[j][e] * drop.inv_keep : 0.f;
          }
      }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

      // acc += P V, this tile's part summed in fresh accumulators, two
      // 8-column blocks at a time, then added in round-to-nearest
      if constexpr (F32) {
        uint32_t ph[NJ][4], pl[NJ][4];
        as_a(s, ph, pl);
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          if (8 * n >= d) break;
          float t0[4] = {}, t1[4] = {};
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            float f0[2], f1[2];
            uint32_t h0[2], l0[2], h1[2], l1[2];
            load_bp<LD>(f0, Vt, 8 * j, 8 * n, g, t);
            load_bp<LD>(f1, Vt, 8 * j, 8 * n + 8, g, t);
            split<true>(f0, h0, l0);
            split<true>(f1, h1, l1);
            mma2x3<true, true>(t0, ph[j], pl[j], h0, l0, t1, ph[j], pl[j],
                               h1, l1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[n][e] += t0[e];
            acc[n + 1][e] += t1[e];
          }
        }
      } else {
        // A fragments of P: keys 16 kk.. are S blocks 2 kk and 2 kk + 1
        uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float* sj = s[2 * kk + (i >> 1)];
            split_bf16(sj[2 * (i & 1)], sj[2 * (i & 1) + 1], ph[kk][i],
                       pl[kk][i]);
          }
#pragma unroll
        for (int np = 0; np < W / 16; ++np) {
          if (16 * np >= d) break;
          float t0[4] = {}, t1[4] = {};
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, Vt + (16 * kk + (lane & 15)) * LD + 16 * np +
                                  (lane >> 4) * 8);
            mma_bf16(t0, pl[kk], bv[0], bv[1]);
            mma_bf16(t1, pl[kk], bv[2], bv[3]);
            mma_bf16(t0, ph[kk], bv[0], bv[1]);
            mma_bf16(t1, ph[kk], bv[2], bv[3]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[2 * np][e] += t0[e];
            acc[2 * np + 1][e] += t1[e];
          }
        }
      }
    }
    __syncthreads();  // this stage's readers are done before its refill
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qr + 8 * r;
    if (qi >= Tq) continue;
    const float lc = fmaxf(l[r], 1e-20f);
    const float inv = 1.f / lc;
    T* o = out + q_base + (size_t)qi * d;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < d) store2(o + c, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * Tq + qi] =
          m[r] == -INFINITY ? -INFINITY : m[r] + logf(lc);
  }
}

template <int W, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, Bias bias,
                   void* out, float* lse, int B, int H, int Tq, int Tk,
                   int d, float scale, int causal, Dropout drop,
                   cudaStream_t stream) {
  using C = Cfg<W, T>;
  // above 48 KB of shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<W, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const int q_tiles = (Tq + C::BM - 1) / C::BM;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  flash_fwd_kernel<W, T><<<dim3(B * H, q_tiles), C::NT, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), lse, H, Tq, Tk,
      d, scale, causal, drop);
  return cudaGetLastError();
}

// The kernel at the smallest instantiated width >= d.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, Bias bias,
                     void* out, float* lse, int B, int H, int Tq, int Tk,
                     int d, float scale, int causal, Dropout drop,
                     cudaStream_t st) {
  return with_width(d, [&](auto w) {
    return launch<decltype(w)::value, T>(q, k, v, bias, out, lse, B, H, Tq,
                                         Tk, d, scale, causal, drop, st);
  });
}

// ---------------------------------------------------------------------------
// The wide arm: head dims above kMaxHeadDim (flash_attention_wide.cuh)
// ---------------------------------------------------------------------------

constexpr int WIDE_NT = 128;  // 16 row pairs x 8 key (and column) lanes

// One CTA per (b*h, 32 query rows, column group).  Thread (rq, cq) holds
// S rows 2rq, 2rq+1 at keys cq + 8j (j < 4) and the output rows 2rq, 2rq+1
// at the group's columns 4cq + 32jj + e (jj < 8, e < 4).  Per K/V tile: S
// over the whole head dim from 32-column chunks of Q and K, the online
// softmax (row max over the 8 lanes of a row, sums per thread until the
// end), P (dropped) into shared memory beside V's rows of the group's
// columns, then acc += P.V.
template <typename T>
__global__ void __launch_bounds__(WIDE_NT)
wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, Bias bias, T* __restrict__ out,
                float* __restrict__ lse, int H, int Tq, int Tk, int dp,
                float scale, int causal, Dropout drop_arg) {
  const Dropout drop = drop_arg.at_step();
  using namespace wide;
  constexpr int NT = WIDE_NT, NJ = 4, NA = GC / 8;
  __shared__ float Qc[ROWS * CLD], Kc[ROWS * CLD], Ps[ROWS * CLD];
  __shared__ __align__(16) float Vs[ROWS * GC];

  const int tid = threadIdx.x;
  const int rq = tid >> 3, cq = tid & 7;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * ROWS, c0 = blockIdx.z * GC;
  const size_t q_base = (size_t)bh * Tq * dp;
  const T* kb = k + (size_t)bh * Tk * dp;
  const T* vb = v + (size_t)bh * Tk * dp;
  const float* brow = bias.ptr ? bias.ptr + b * bias.sb + h * bias.sh
                               : nullptr;

  int nt = (Tk + ROWS - 1) / ROWS;
  if (causal) nt = min(nt, (q0 + ROWS - 1) / ROWS + 1);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[2][NA];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[i][a] = 0.f;

  for (int tile = 0; tile < nt; ++tile) {
    const int k0 = tile * ROWS;
    float s[2][NJ] = {};
    for (int cc = 0; cc < dp; cc += CH) {
      __syncthreads();  // the last chunk's (and tile's) readers are done
      chunk<NT>(Qc, q + q_base, q0, Tq, cc, dp);
      chunk<NT>(Kc, kb, k0, Tk, cc, dp);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < CH; ++kk) {
        const float a0 = Qc[(2 * rq) * CLD + kk];
        const float a1 = Qc[(2 * rq + 1) * CLD + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float kv = Kc[(cq + 8 * j) * CLD + kk];
          s[0][j] = fmaf(a0, kv, s[0][j]);
          s[1][j] = fmaf(a1, kv, s[1][j]);
        }
      }
    }
    // V's rows of this tile at the group's columns
#pragma unroll 4
    for (int i = tid; i < ROWS * GC; i += NT) {
      const int r = i / GC, c = i % GC;
      const bool in = (k0 + r < Tk) & (c0 + c < dp);
      Vs[i] = in ? to_float(vb[(size_t)(k0 + r) * dp + c0 + c]) : 0.f;
    }
    // scale, bias, masks, the online softmax; P (dropped) into Ps
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + 2 * rq + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kj = k0 + cq + 8 * j;
        const bool valid = (kj < Tk) & !(causal & (kj > qi));
        const float x = s[i][j] * scale + bias_at(brow, bias, qi, kj, Tq, Tk);
        s[i][j] = valid ? x : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float mn = fmaxf(m[i], mt);
      // a row with every score so far at -inf keeps p = 0 and corr = 0
      const float ms = mn == -INFINITY ? 0.f : mn;
      corr[i] = expf(m[i] - ms);
      m[i] = mn;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float p = expf(s[i][j] - ms);
        ls += p;  // the denominator sums the undropped weights
        if (drop.on)
          p = drop.keep(k0 + cq + 8 * j, qi, bh) ? p * drop.inv_keep : 0.f;
        Ps[(2 * rq + i) * CLD + cq + 8 * j] = p;
      }
      l[i] = l[i] * corr[i] + ls;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int a = 0; a < NA; ++a) acc[i][a] *= corr[i];
    __syncthreads();
    // acc += P V over the tile's keys
#pragma unroll 4
    for (int kj = 0; kj < ROWS; ++kj) {
      const float p0 = Ps[(2 * rq) * CLD + kj];
      const float p1 = Ps[(2 * rq + 1) * CLD + kj];
#pragma unroll
      for (int jj = 0; jj < NA / 4; ++jj) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[kj * GC + 4 * cq + 32 * jj]);
        const float e[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[0][4 * jj + c] = fmaf(p0, e[c], acc[0][4 * jj + c]);
          acc[1][4 * jj + c] = fmaf(p1, e[c], acc[1][4 * jj + c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 2 * rq + i;
    if (qi >= Tq) continue;
    const float lc = fmaxf(l[i], 1e-20f);
    const float inv = 1.f / lc;
    T* o = out + q_base + (size_t)qi * dp;
#pragma unroll
    for (int jj = 0; jj < NA / 4; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + 4 * cq + 32 * jj + c;
        if (col < dp) store(o + col, acc[i][4 * jj + c] * inv);
      }
    if (lse != nullptr && blockIdx.z == 0 && cq == 0)
      lse[(size_t)bh * Tq + qi] =
          m[i] == -INFINITY ? -INFINITY : m[i] + logf(lc);
  }
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        Bias bias, void* out, float* lse, int B, int H,
                        int Tq, int Tk, int d, float scale, int causal,
                        Dropout drop, cudaStream_t stream) {
  const int q_tiles = (Tq + wide::ROWS - 1) / wide::ROWS;
  const int groups = wide::groups(d);
  if (q_tiles > 65535 || groups > 65535) return cudaErrorInvalidValue;
  wide_fwd_kernel<T><<<dim3(B * H, q_tiles, groups), WIDE_NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), lse, H, Tq, Tk,
      d, scale, causal, drop);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D, the head dim, a multiple of 4
// (fp32) or 8 (bf16): at most 256 runs the HeadWidths kernels, above 256
// the wide arm; q, k, v and out 16-byte aligned
// (cp.async copies 16 bytes).  bias and lse may be null.  The dropout arm
// is on when `dropout` is non-zero: keep when Philox word 0 < threshold,
// kept weights times inv_keep; the key is (key0, key1), or, when `step`
// (an int64 in device memory) is not null, the key at that step
// (key_at_step).  Returns a cudaError_t (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias,
    void* out, void* lse, int B, int H, int Tq, int Tk, int D, int dtype,
    long long sb, long long sh, long long sq, long long sk, float scale,
    int causal, int dropout, unsigned threshold, unsigned key0,
    unsigned key1, const void* step, float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return cudaErrorInvalidValue;
  if ((dtype != 0 && dtype != 1) || !head_dim_ok(D, dtype == 0 ? 4 : 2))
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return cudaErrorMisalignedAddress;
  const Bias bb{static_cast<const float*>(bias), sb, sh, sq, sk};
  const Dropout dr{dropout, threshold, key0, key1, inv_keep,
                   static_cast<const long long*>(step)};
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > kMaxHeadDim)
    return dtype == 0 ? launch_wide<float>(q, k, v, bb, out, lp, B, H, Tq, Tk,
                                           D, scale, causal, dr, st)
                      : launch_wide<__nv_bfloat16>(q, k, v, bb, out, lp, B,
                                                   H, Tq, Tk, D, scale,
                                                   causal, dr, st);
  if (dtype == 0)
    return dispatch<float>(q, k, v, bb, out, lp, B, H, Tq, Tk, D, scale,
                           causal, dr, st);
  return dispatch<__nv_bfloat16>(q, k, v, bb, out, lp, B, H, Tq, Tk, D,
                                 scale, causal, dr, st);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
