// FlashAttention-2 backward for Hopper (sm_90a), plain C interface: two
// kernels, as the TPU had, on the tensor cores.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels.py::
// _flash_bwd_impl (:733), the backward of the custom_vjp _flash_p (:495),
// and with them the backward of flash_attention_with_lse (:883-913),
// whose lse cotangent arrives here folded into delta:
//   * flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel (:558, pl.pallas_call
//     :791): dK and dV, one CTA per (b*h, 64-row K tile), K and V resident,
//     looping over 32-row Q tiles (causal: from the diagonal tile, :619);
//   * flash_bwd_dq_kernel <- _flash_bwd_dq_kernel (:625, pl.pallas_call
//     :835): dQ and dBias, one CTA per (b*h, 64-row Q tile), Q and dO
//     resident, looping over 32-row K tiles (causal: up to the diagonal).
// Both recompute the score tile S = q.k^T*scale + bias and P = exp(S -
// lse) from the forward's per-row lse, with dP = dO.V^T and, from delta =
// rowsum(dO.O) (minus the lse cotangent for K3) computed before the
// kernels in fp32,
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
//     q rows per key column (shuffles, then four warps' partials in shared
//     memory) and adds the column sums to a zeroed [B, Tk] fp32 buffer with
//     atomicAdd; the wrapper sums over the batch for a [1,1,1,Tk] bias.
//     Atomics add in a different order on every run, so the result varies
//     in its last bits (the tolerance is stated where it is checked).
//   * any other bias (dbias_mode 2): dS is written whole, [B*H, Tq, Tk]
//     fp32, by the CTA that owns the q rows, into a zeroed buffer (a
//     causal run never visits the tiles above the diagonal), and the
//     wrapper sums it down to the bias's shape.
//
// What bounds them.  K2a does 8*B*H*Tq*Tk*D FLOP (four products per tile:
// S, dP, dV, dK), K2b 6*B*H*Tq*Tk*D (S, dP, dQ).  At the BERT-base
// training shape (B=32, H=12, T=128, D=64, fp32) that is 3.22 and 2.42
// GFLOP: 48 and 36 us at the 67 TFLOP/s of fp32 CUDA cores, but 19.5 and
// 14.7 us at 165 TFLOP/s, a third of the 495 TFLOP/s of TF32 tensor cores,
// against 23 and 19 us of memory traffic (q, k, v, dO read once, the
// gradients written once): on the tensor cores they are bound by bytes.
// What holds them back in practice is issue: every tensor-core product
// also needs its operands loaded and split (about one split a product),
// and the elementwise work between the products (exp, masks, and under
// dropout a 10-round Philox per element, in both kernels).
//
// The design.
//   * Tensor cores through warp-level mma.sync m16n8k8 TF32.  fp32
//     operands take the 3xTF32 scheme: x = hi + lo with hi = x rounded to
//     TF32 (to nearest, ties away, as cvt.rna.tf32.f32, in two integer
//     operations) and lo = x - hi, exact in fp32, of which the tensor core
//     reads the top 19 bits (CUTLASS's OpMultiplyAddFastF32 does the same);
//     a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi summed in fp32, the dropped
//     terms ~2^-21 relative, so the gradients keep fp32's accuracy where
//     one TF32 product a term would lose three decimal digits.  bf16
//     operands are exact in TF32 and take one product (P and dS, computed
//     in fp32, are still split in two), so both types share one path and
//     the bf16 arm keeps P and dS in fp32 as the plain version does.
//   * Each warp owns 16 rows of the resident tile.  S and dP accumulate in
//     registers; P, dS and the dropout bits are computed in the
//     accumulator layout, branch-free, so every element's loads and
//     exponentials overlap; and P and dS feed the dV/dK (or dQ) products
//     as A operands straight from those registers.  An accumulator holds
//     columns 2t and 2t+1 where an A fragment wants k = t and t+4, so each
//     product's k order is permuted (k = t <-> column 2t, k = t+4 <->
//     column 2t+1): the S and dP fragments then read two neighbouring
//     floats at once, and the dV/dK/dQ B fragments read rows 2t and 2t+1.
//   * The tensor cores sum with truncation, so a long accumulation chain
//     drifts: each streamed tile's dV/dK (or dQ) contribution is summed in
//     a fresh accumulator and added to the running sum in fp32 round-to-
//     nearest.  Independent accumulation chains are interleaved.
//   * Asynchronous copies: the streamed tiles (Q, dO, lse, delta in K2a;
//     K, V in K2b) are double-buffered with 16-byte cp.async, so the next
//     tile's loads overlap this tile's products.  Shared rows are padded by
//     8 elements and fp32 rows XOR-swizzled, which leaves every fragment
//     load free of bank conflicts.
//   * Fill: 74 KB of shared memory and at most 168 registers a thread at
//     D 64 fp32, so three CTAs (12 warps) share an SM and the ring shard's
//     384 CTAs fit one wave; a causal K2a's grid starts with the longest K
//     tiles and a causal K2b's with the longest Q tiles.
//   * Head dims above 256 run the wide arm (flash_attention_wide.cuh, at
//     the end of this file); every d <= 256, at the instantiated widths
//     (flash_attention_mma.cuh's HeadWidths: columns past d zero-filled on
//     load and not written; the products run over all W columns: a
//     runtime bound on them costs registers, and the W 64 kernels would
//     spill).  At W 256 a streamed tile has 16 rows, so resident and
//     streamed tiles fit 203 KB of shared memory, and two CTAs split the
//     gradient columns.
//   * Two kernels, no atomics on dQ: dQ, dK and dV are deterministic.

#include "flash_attention_mma.cuh"
#include "flash_attention_wide.cuh"

namespace {

using namespace flash;

constexpr int WARPS = 4;
constexpr int NTHREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;  // resident rows a CTA: 16 a warp

// Rows of a streamed tile: 32, and 16 at W 256, where resident and
// streamed rows of 264 elements would not fit shared memory otherwise.
template <int W>
__host__ __device__ constexpr int bn() {
  return W > 128 ? 16 : 32;
}

// The gradient columns a CTA owns: all of them up to W 128; at W 256 two
// CTAs share a tile, 128 columns each (accumulators of 256 columns would
// not fit the registers: K2a holds dK and dV), and each recomputes S and
// dP; K2b's second CTA writes no dBias.
template <int W>
__host__ __device__ constexpr int out_cols() {
  return W > 128 ? 128 : W;
}

// Resident [BM] rows of two tensors, two stages of [BN] rows of two
// tensors, and 4*BN floats (K2a: lse and delta, two stages; K2b: the
// row-dBias partials of four warps).
template <typename T, int W>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)(2 * BM + 4 * bn<W>()) * ld<W>() +
         sizeof(float) * 4 * bn<W>();
}

// c1 = A1.B1^T and c2 = A2.B2^T for the warp's 16 rows r0.. of the
// resident A1, A2 and the BN rows of the streamed B1, B2 (S and dP), over
// all W columns (those past d are zero).
template <int W, int NJ, typename T>
__device__ __forceinline__ void two_products(const T* A1, const T* A2,
                                             const T* B1, const T* B2,
                                             int r0, int g, int t,
                                             float (&c1)[NJ][4],
                                             float (&c2)[NJ][4]) {
  constexpr int LD = ld<W>();
  constexpr bool SPLIT = std::is_same<T, float>::value;
#pragma unroll
  for (int kk = 0; kk < W / 8; ++kk) {
    float a1[4], a2[4];
    uint32_t a1h[4], a1l[4], a2h[4], a2l[4];
    load_a<LD>(a1, A1, r0, 8 * kk, g, t);
    load_a<LD>(a2, A2, r0, 8 * kk, g, t);
    split<SPLIT>(a1, a1h, a1l);
    split<SPLIT>(a2, a2h, a2l);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float b1[2], b2[2];
      uint32_t b1h[2], b1l[2], b2h[2], b2l[2];
      load_bt<LD>(b1, B1, 8 * j, 8 * kk, g, t);
      load_bt<LD>(b2, B2, 8 * j, 8 * kk, g, t);
      split<SPLIT>(b1, b1h, b1l);
      split<SPLIT>(b2, b2h, b2l);
      mma2x3<SPLIT, SPLIT>(c1[j], a1h, a1l, b1h, b1l, c2[j], a2h, a2l, b2h,
                           b2l);
    }
  }
}

// exp(x - lse), 0 where the row's lse is -inf (every score masked) or x
// is -inf.
__device__ __forceinline__ float exp_lse(float x, float lse) {
  return expf(x - (isfinite(lse) ? lse : INFINITY));
}

// ---------------------------------------------------------------------------
// K2a: dK, dV
// ---------------------------------------------------------------------------

// Two CTAs an SM for fp32 at W <= 64: its 3xTF32 products fill the 168
// registers three would leave a thread, and the dropout key taken at the
// step word's step (registry.DeviceSeed) then spilled; at two it runs as
// fast (NVIDIA H100, BERT-base's attention with dropout).
template <int W, typename T>
constexpr int dkv_min_ctas() {
  return W <= 64 ? (std::is_same<T, float>::value ? 2 : 3) : 1;
}

template <int W, typename T>
__global__ void __launch_bounds__(NTHREADS, (dkv_min_ctas<W, T>()))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, Bias bias,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk, int d,
                     float scale, int causal, Dropout drop) {
  constexpr int LD = ld<W>();
  constexpr int BN = bn<W>();
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int NJ = BN / 8;              // 8-column blocks of S^T (q) a tile
  constexpr int ND = out_cols<W>() / 8;   // 8-column blocks of dK, dV
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // [BM][LD]
  T* Vs = Ks + BM * LD;                // [BM][LD]
  T* Qs = Vs + BM * LD;                // [2][BN][LD]
  T* dOs = Qs + 2 * BN * LD;           // [2][BN][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BN * LD);  // [2][BN]
  float* dl_s = lse_s + 2 * BN;                                // [2][BN]

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * BM;
  // this CTA's dK, dV columns: 0 up to W 128 (one CTA holds them all)
  const int c0 = W > 128 ? blockIdx.z * out_cols<W>() : 0;
  const T* qb = q + (size_t)bh * Tq * d;
  const T* dob = dout + (size_t)bh * Tq * d;
  const float* lseb = lse + (size_t)bh * Tq;
  const float* dlb = delta + (size_t)bh * Tq;
  const size_t kv_base = (size_t)bh * Tk * d;
  const float* brow = bias.ptr ? bias.ptr + b * bias.sb + h * bias.sh
                               : nullptr;

  auto stage_q = [&](int tile, int st) {
    const int q0 = tile * BN;
    stage<BN, W, NTHREADS>(Qs + st * BN * LD, qb, q0, Tq, d);
    stage<BN, W, NTHREADS>(dOs + st * BN * LD, dob, q0, Tq, d);
    if (threadIdx.x < BN)
      stage_entry(lse_s + st * BN, lseb, q0, Tq, threadIdx.x);
    else if (threadIdx.x < 2 * BN)
      stage_entry(dl_s + st * BN, dlb, q0, Tq, threadIdx.x - BN);
  };

  // causal: q tiles wholly above this K tile's first key see none of it
  const int t0 = causal ? k0 / BN : 0;
  const int nt = (Tq + BN - 1) / BN;
  stage<BM, W, NTHREADS>(Ks, k + kv_base, k0, Tk, d);
  stage<BM, W, NTHREADS>(Vs, v + kv_base, k0, Tk, d);
  if (t0 < nt) stage_q(t0, 0);
  cp_commit();

  // this thread's K rows: accumulator rows g and g + 8 of the warp's 16
  const int kr = 16 * w + g;
  // a row bias [B|1,1,1,Tk] depends on the key only: this thread's two
  const bool row_bias = brow != nullptr && bias.sq == 0;
  float bk[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (row_bias) bk[r] = brow[(size_t)min(k0 + kr + 8 * r, Tk - 1) * bias.sk];
  float dk_acc[ND][4] = {}, dv_acc[ND][4] = {};

  for (int tile = t0, st = 0; tile < nt; ++tile, st ^= 1) {
    if (tile + 1 < nt) stage_q(tile + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int q0 = tile * BN;
    const T* Qt = Qs + st * BN * LD;
    const T* dOt = dOs + st * BN * LD;
    const float* ls = lse_s + st * BN;
    const float* dl = dl_s + st * BN;
    // the causal mask may hide the warp's whole block: no products then
    const bool live = !causal || k0 + 16 * w <= q0 + BN - 1;
    // this tile's keep bits (bit 4 j + e: element (kj, qi) of s[j][e]
    // below), drawn before S^T and dP^T are: the 4 NJ Philox chains then
    // run beside the accumulators alone, and the key taken at the step
    // word's step (a register pair) lives only through them
    uint32_t keep = 0u;
    if (drop.on) {
      const Dropout dr = drop.at_step();
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          keep |= (uint32_t)dr.keep(k0 + kr + 8 * (e >> 1),
                                    q0 + 8 * j + 2 * t + (e & 1), bh)
                  << (4 * j + e);
    }

    // S^T = K Q^T and dP^T = V dO^T: 16 K rows x BN q columns a warp
    float s[NJ][4] = {}, dp[NJ][4] = {};
    if (live) two_products<W, NJ>(Ks, Vs, Qt, dOt, 16 * w, g, t, s, dp);

    // P^T into s, element (kj, qi) at s[j][e]: row r = e / 2, column c =
    // e % 2 of the accumulator layout
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int qc = 8 * j + 2 * t;
      const float2 lsv = *reinterpret_cast<const float2*>(ls + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = e & 1;
        const int qi = q0 + qc + c, kj = k0 + kr + 8 * r;
        const bool valid = (qi < Tq) & (kj < Tk) & !(causal & (kj > qi));
        float x = s[j][e] * scale;
        if (brow != nullptr)
          x += row_bias ? bk[r]
                        : brow[(size_t)min(qi, Tq - 1) * bias.sq +
                               (size_t)min(kj, Tk - 1) * bias.sk];
        s[j][e] = valid ? exp_lse(x, c ? lsv.y : lsv.x) : 0.f;
      }
    }
    // drop(P)^T into s, dS^T = P (drop(dP) - delta) into dp (a uniform
    // branch outside the loops, so the elements' Philox chains overlap)
    if (drop.on) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int qc = 8 * j + 2 * t;
        const float2 dlv = *reinterpret_cast<const float2*>(dl + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool kp = (keep >> (4 * j + e)) & 1u;
          const float p = s[j][e];
          s[j][e] = kp ? p * drop.inv_keep : 0.f;
          dp[j][e] = p * ((kp ? dp[j][e] * drop.inv_keep : 0.f) -
                          ((e & 1) ? dlv.y : dlv.x));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 dlv = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - ((e & 1) ? dlv.y : dlv.x));
      }
    }

    // dV += drop(P)^T dO and dK += dS^T Q, this tile's part summed in a
    // fresh accumulator per 8 columns, then added in round-to-nearest
    if (live) {
      uint32_t ph[NJ][4], pl[NJ][4], sh[NJ][4], sl[NJ][4];
      as_a(s, ph, pl);
      as_a(dp, sh, sl);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        float tv[4] = {}, tk[4] = {};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float of[2], qf[2];
          uint32_t oh[2], ol[2], qh[2], ql[2];
          load_bp<LD>(of, dOt, 8 * j, c0 + 8 * n, g, t);
          load_bp<LD>(qf, Qt, 8 * j, c0 + 8 * n, g, t);
          split<SPLIT>(of, oh, ol);
          split<SPLIT>(qf, qh, ql);
          mma2x3<true, SPLIT>(tv, ph[j], pl[j], oh, ol, tk, sh[j], sl[j], qh,
                              ql);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv_acc[n][e] += tv[e];
          dk_acc[n][e] += tk[e];
        }
      }
    }
    __syncthreads();  // this stage's readers are done before its refill
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + kr + 8 * r;
    if (kj >= Tk) continue;
    T* dkr = dk + kv_base + (size_t)kj * d;
    T* dvr = dv + kv_base + (size_t)kj * d;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = c0 + 8 * n + 2 * t;
      if (c >= d) break;
      store2(dkr + c, dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
      store2(dvr + c, dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2b: dQ, dBias
// ---------------------------------------------------------------------------

template <int W, typename T>
__global__ void __launch_bounds__(NTHREADS, W <= 64 ? 3 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, Bias bias,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    float* __restrict__ dbias, int dbias_mode, int H,
                    int Tq, int Tk, int d, float scale, int causal,
                    Dropout drop_arg) {
  const Dropout drop = drop_arg.at_step();
  constexpr int LD = ld<W>();
  constexpr int BN = bn<W>();
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int NJ = BN / 8;              // 8-column blocks of S (k) a tile
  constexpr int ND = out_cols<W>() / 8;   // 8-column blocks of dQ
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [BM][LD]
  T* dOs = Qs + BM * LD;               // [BM][LD]
  T* Ks = dOs + BM * LD;               // [2][BN][LD]
  T* Vs = Ks + 2 * BN * LD;            // [2][BN][LD]
  float* red = reinterpret_cast<float*>(Vs + 2 * BN * LD);  // [WARPS][BN]

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  // causal: the longest rows (the last Q tile) start first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  // this CTA's dQ columns: 0 up to W 128 (one CTA holds them all)
  const int c0 = W > 128 ? blockIdx.z * out_cols<W>() : 0;
  const size_t q_base = (size_t)bh * Tq * d;
  const T* kb = k + (size_t)bh * Tk * d;
  const T* vb = v + (size_t)bh * Tk * d;
  const float* brow = bias.ptr ? bias.ptr + b * bias.sb + h * bias.sh
                               : nullptr;
  const bool row_bias = brow != nullptr && bias.sq == 0;

  auto stage_kv = [&](int tile, int st) {
    stage<BN, W, NTHREADS>(Ks + st * BN * LD, kb, tile * BN, Tk, d);
    stage<BN, W, NTHREADS>(Vs + st * BN * LD, vb, tile * BN, Tk, d);
  };

  int nt = (Tk + BN - 1) / BN;
  if (causal) nt = min(nt, (q0 + BM - 1) / BN + 1);
  stage<BM, W, NTHREADS>(Qs, q + q_base, q0, Tq, d);
  stage<BM, W, NTHREADS>(dOs, dout + q_base, q0, Tq, d);
  stage_kv(0, 0);
  cp_commit();

  // this thread's Q rows: accumulator rows g and g + 8 of the warp's 16
  const int qr = 16 * w + g;
  float ls[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + qr + 8 * r;
    ls[r] = qi < Tq ? lse[(size_t)bh * Tq + qi] : -INFINITY;
    dl[r] = qi < Tq ? delta[(size_t)bh * Tq + qi] : 0.f;
  }
  float dq_acc[ND][4] = {};

  for (int tile = 0, st = 0; tile < nt; ++tile, st ^= 1) {
    if (tile + 1 < nt) stage_kv(tile + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int k0 = tile * BN;
    const T* Kt = Ks + st * BN * LD;
    const T* Vt = Vs + st * BN * LD;
    const bool live = !causal || k0 <= q0 + 16 * w + 15;

    // S = Q K^T and dP = dO V^T: 16 q rows x BN key columns a warp
    float s[NJ][4] = {}, dp[NJ][4] = {};
    if (live) two_products<W, NJ>(Qs, dOs, Kt, Vt, 16 * w, g, t, s, dp);

    // P into s, element (qi, kj) at s[j][e]: row r = e / 2, column c = e % 2
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kj = k0 + 8 * j + 2 * t + c;
        const size_t kcol = (size_t)min(kj, Tk - 1) * bias.sk;
        const float bc = row_bias ? brow[kcol] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c, qi = q0 + qr + 8 * r;
          const bool valid = (qi < Tq) & (kj < Tk) & !(causal & (kj > qi));
          float x = s[j][e] * scale;
          if (brow != nullptr)
            x += row_bias ? bc
                          : brow[(size_t)min(qi, Tq - 1) * bias.sq + kcol];
          s[j][e] = valid ? exp_lse(x, ls[r]) : 0.f;
        }
      }
    }
    // dS = P (drop(dP) - delta) into dp (a uniform branch outside the
    // loops, so the elements' Philox chains overlap)
    if (drop.on) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool kp = drop.keep(k0 + 8 * j + 2 * t + (e & 1),
                                    q0 + qr + 8 * (e >> 1), bh);
          dp[j][e] = s[j][e] * ((kp ? dp[j][e] * drop.inv_keep : 0.f) -
                                dl[e >> 1]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - dl[e >> 1]);
    }

    if (dbias_mode == 2 && c0 == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          const int qi = q0 + qr + 8 * (e >> 1);
          if (qi < Tq && kj < Tk)
            dbias[((size_t)bh * Tq + qi) * Tk + kj] = dp[j][e];
        }
    } else if (dbias_mode == 1 && c0 == 0) {
      // column sums over the warp's 16 rows, then over the four warps
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float c0 = dp[j][0] + dp[j][2], c1 = dp[j][1] + dp[j][3];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          c0 += __shfl_xor_sync(0xffffffffu, c0, off);
          c1 += __shfl_xor_sync(0xffffffffu, c1, off);
        }
        if (g == 0) {
          red[w * BN + 8 * j + 2 * t] = c0;
          red[w * BN + 8 * j + 2 * t + 1] = c1;
        }
      }
      __syncthreads();
      const int c = threadIdx.x;
      if (c < BN && k0 + c < Tk) {
        float sum = 0.f;
#pragma unroll
        for (int ww = 0; ww < WARPS; ++ww) sum += red[ww * BN + c];
        atomicAdd(dbias + (size_t)b * Tk + k0 + c, sum);
      }
    }

    // dQ += dS K, this tile's part summed in a fresh accumulator per 8
    // columns, two column blocks at a time, then added in round-to-nearest
    if (live) {
      uint32_t sh[NJ][4], sl[NJ][4];
      as_a(dp, sh, sl);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        float t0[4] = {}, t1[4] = {};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float f0[2], f1[2];
          uint32_t h0[2], l0[2], h1[2], l1[2];
          load_bp<LD>(f0, Kt, 8 * j, c0 + 8 * n, g, t);
          load_bp<LD>(f1, Kt, 8 * j, c0 + 8 * n + 8, g, t);
          split<SPLIT>(f0, h0, l0);
          split<SPLIT>(f1, h1, l1);
          mma2x3<true, SPLIT>(t0, sh[j], sl[j], h0, l0, t1, sh[j], sl[j], h1,
                              l1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dq_acc[n][e] += t0[e];
          dq_acc[n + 1][e] += t1[e];
        }
      }
    }
    __syncthreads();  // this stage's readers are done before its refill
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + qr + 8 * r;
    if (qi >= Tq) continue;
    T* dqr = dq + q_base + (size_t)qi * d;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = c0 + 8 * n + 2 * t;
      if (c >= d) break;
      store2(dqr + c, dq_acc[n][2 * r] * scale, dq_acc[n][2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// The wide arm: head dims above kMaxHeadDim (flash_attention_wide.cuh)
// ---------------------------------------------------------------------------

constexpr int WIDE_NT = 256;  // 16 row pairs x 16 column lanes

// The score-shaped products of a resident and a streamed tile over the
// whole head dim: c1 = A1.B1^T and c2 = A2.B2^T for A rows 2rq, 2rq+1 and
// B rows cq, cq+16, from 32-column chunks staged in A1c, A2c, B1c, B2c.
template <typename T>
__device__ __forceinline__ void wide_products(
    const T* __restrict__ a1, const T* __restrict__ a2, int ra, int na,
    const T* __restrict__ b1, const T* __restrict__ b2, int rb, int nb,
    int dp, float* A1c, float* A2c, float* B1c, float* B2c, int rq, int cq,
    float (&c1)[2][2], float (&c2)[2][2]) {
  using namespace wide;
  for (int cc = 0; cc < dp; cc += CH) {
    __syncthreads();  // the last chunk's (and pass's) readers are done
    chunk<WIDE_NT>(A1c, a1, ra, na, cc, dp);
    chunk<WIDE_NT>(A2c, a2, ra, na, cc, dp);
    chunk<WIDE_NT>(B1c, b1, rb, nb, cc, dp);
    chunk<WIDE_NT>(B2c, b2, rb, nb, cc, dp);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < CH; ++kk) {
      float x1[2], x2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        x1[i] = A1c[(2 * rq + i) * CLD + kk];
        x2[i] = A2c[(2 * rq + i) * CLD + kk];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float y1 = B1c[(cq + 16 * j) * CLD + kk];
        const float y2 = B2c[(cq + 16 * j) * CLD + kk];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          c1[i][j] = fmaf(x1[i], y1, c1[i][j]);
          c2[i][j] = fmaf(x2[i], y2, c2[i][j]);
        }
      }
    }
  }
}

// K2a's wide arm: one CTA per (b*h, 32 K rows, column group).  Per 32-row
// Q tile: S^T = K.Q^T and dP^T = V.dO^T over the whole head dim, P^T and
// dS^T (thread (rq, cq): K rows 2rq, 2rq+1 at q columns cq, cq+16) into
// shared memory, then dV += drop(P)^T.dO and dK += dS^T.Q over the
// group's columns, chunk by chunk (thread (rq, cq): rows 2rq, 2rq+1 at
// columns 2cq, 2cq+1 of each chunk).
template <typename T>
__global__ void __launch_bounds__(WIDE_NT)
wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, Bias bias,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int H, int Tq, int Tk, int dp,
                float scale, int causal, Dropout drop_arg) {
  const Dropout drop = drop_arg.at_step();
  using namespace wide;
  __shared__ float Kc[ROWS * CLD], Vc[ROWS * CLD], Qc[ROWS * CLD],
      Oc[ROWS * CLD], Pt[ROWS * CLD], St[ROWS * CLD], ls_s[ROWS],
      dl_s[ROWS];
  const int tid = threadIdx.x;
  const int rq = tid >> 4, cq = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * ROWS, c0 = blockIdx.z * GC;
  const T* qb = q + (size_t)bh * Tq * dp;
  const T* dob = dout + (size_t)bh * Tq * dp;
  const size_t kv_base = (size_t)bh * Tk * dp;
  const float* brow = bias.ptr ? bias.ptr + b * bias.sb + h * bias.sh
                               : nullptr;
  float dk_acc[NG][2][2] = {}, dv_acc[NG][2][2] = {};

  // causal: q tiles wholly above this K tile's first key see none of it
  const int nt = (Tq + ROWS - 1) / ROWS;
  for (int tile = causal ? k0 / ROWS : 0; tile < nt; ++tile) {
    const int q0 = tile * ROWS;
    __syncthreads();  // the last tile's readers of ls_s, dl_s are done
    if (tid < ROWS)
      ls_s[tid] = q0 + tid < Tq ? lse[(size_t)bh * Tq + q0 + tid] : -INFINITY;
    else if (tid < 2 * ROWS)
      dl_s[tid - ROWS] =
          q0 + tid - ROWS < Tq ? delta[(size_t)bh * Tq + q0 + tid - ROWS] : 0.f;
    float s[2][2] = {}, dpv[2][2] = {};
    wide_products(k + kv_base, v + kv_base, k0, Tk, qb, dob, q0, Tq, dp, Kc,
                  Vc, Qc, Oc, rq, cq, s, dpv);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = cq + 16 * j, kr = 2 * rq + i;
        const int qi = q0 + qc, kj = k0 + kr;
        const bool valid = (qi < Tq) & (kj < Tk) & !(causal & (kj > qi));
        const float x = s[i][j] * scale + bias_at(brow, bias, qi, kj, Tq, Tk);
        const float p = valid ? exp_lse(x, ls_s[qc]) : 0.f;
        float pd = p, dpd = dpv[i][j];
        if (drop.on) {
          const bool kp = drop.keep(kj, qi, bh);
          pd = kp ? p * drop.inv_keep : 0.f;
          dpd = kp ? dpd * drop.inv_keep : 0.f;
        }
        Pt[kr * CLD + qc] = pd;
        St[kr * CLD + qc] = p * (dpd - dl_s[qc]);
      }
    // dV += drop(P)^T dO and dK += dS^T Q over the group's columns
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int cc = c0 + g * CH;
      if (cc >= dp) break;
      __syncthreads();  // Pt, St written; the last chunk's readers done
      chunk<WIDE_NT>(Qc, qb, q0, Tq, cc, dp);
      chunk<WIDE_NT>(Oc, dob, q0, Tq, cc, dp);
      __syncthreads();
#pragma unroll 8
      for (int qq = 0; qq < ROWS; ++qq) {
        float pr[2], sr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pr[i] = Pt[(2 * rq + i) * CLD + qq];
          sr[i] = St[(2 * rq + i) * CLD + qq];
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float o = Oc[qq * CLD + 2 * cq + e];
          const float x = Qc[qq * CLD + 2 * cq + e];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dv_acc[g][i][e] = fmaf(pr[i], o, dv_acc[g][i][e]);
            dk_acc[g][i][e] = fmaf(sr[i], x, dk_acc[g][i][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + 2 * rq + i;
    if (kj >= Tk) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + g * CH + 2 * cq + e;
        if (c < dp) {
          store(dk + kv_base + (size_t)kj * dp + c, dk_acc[g][i][e] * scale);
          store(dv + kv_base + (size_t)kj * dp + c, dv_acc[g][i][e]);
        }
      }
  }
}

// K2b's wide arm: one CTA per (b*h, 32 Q rows, column group).  Per 32-row
// K tile: S = Q.K^T and dP = dO.V^T over the whole head dim, dS (thread
// (rq, cq): q rows 2rq, 2rq+1 at keys cq, cq+16) into shared memory and,
// in group 0, into dBias; then dQ += dS.K over the group's columns.
template <typename T>
__global__ void __launch_bounds__(WIDE_NT)
wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, Bias bias,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq,
               float* __restrict__ dbias, int dbias_mode, int H, int Tq,
               int Tk, int dp, float scale, int causal, Dropout drop_arg) {
  const Dropout drop = drop_arg.at_step();
  using namespace wide;
  __shared__ float Qc[ROWS * CLD], Oc[ROWS * CLD], Kc[ROWS * CLD],
      Vc[ROWS * CLD], Ss[ROWS * CLD];
  const int tid = threadIdx.x;
  const int rq = tid >> 4, cq = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * ROWS, c0 = blockIdx.z * GC;
  const size_t q_base = (size_t)bh * Tq * dp;
  const T* kb = k + (size_t)bh * Tk * dp;
  const T* vb = v + (size_t)bh * Tk * dp;
  const float* brow = bias.ptr ? bias.ptr + b * bias.sb + h * bias.sh
                               : nullptr;
  float ls[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 2 * rq + i;
    ls[i] = qi < Tq ? lse[(size_t)bh * Tq + qi] : -INFINITY;
    dl[i] = qi < Tq ? delta[(size_t)bh * Tq + qi] : 0.f;
  }
  float dq_acc[NG][2][2] = {};

  int nt = (Tk + ROWS - 1) / ROWS;
  if (causal) nt = min(nt, (q0 + ROWS - 1) / ROWS + 1);
  for (int tile = 0; tile < nt; ++tile) {
    const int k0 = tile * ROWS;
    float s[2][2] = {}, dpv[2][2] = {};
    wide_products(q + q_base, dout + q_base, q0, Tq, kb, vb, k0, Tk, dp, Qc,
                  Oc, Kc, Vc, rq, cq, s, dpv);
    float ds[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = q0 + 2 * rq + i, kj = k0 + cq + 16 * j;
        const bool valid = (qi < Tq) & (kj < Tk) & !(causal & (kj > qi));
        const float x = s[i][j] * scale + bias_at(brow, bias, qi, kj, Tq, Tk);
        const float p = valid ? exp_lse(x, ls[i]) : 0.f;
        float dpd = dpv[i][j];
        if (drop.on)
          dpd = drop.keep(kj, qi, bh) ? dpd * drop.inv_keep : 0.f;
        ds[i][j] = p * (dpd - dl[i]);
        Ss[(2 * rq + i) * CLD + cq + 16 * j] = ds[i][j];
      }
    if (c0 == 0 && dbias_mode == 2) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qi = q0 + 2 * rq + i, kj = k0 + cq + 16 * j;
          if (qi < Tq && kj < Tk)
            dbias[((size_t)bh * Tq + qi) * Tk + kj] = ds[i][j];
        }
    } else if (c0 == 0 && dbias_mode == 1) {
      // the row bias's grad, summed over q rows (and heads) by atomics
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + cq + 16 * j;
        if (kj < Tk) atomicAdd(dbias + (size_t)b * Tk + kj, ds[0][j] + ds[1][j]);
      }
    }
    // dQ += dS K over the group's columns
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int cc = c0 + g * CH;
      if (cc >= dp) break;
      __syncthreads();  // Ss written; the last chunk's readers done
      chunk<WIDE_NT>(Kc, kb, k0, Tk, cc, dp);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < ROWS; ++kk) {
        const float d0 = Ss[(2 * rq) * CLD + kk];
        const float d1 = Ss[(2 * rq + 1) * CLD + kk];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float kv = Kc[kk * CLD + 2 * cq + e];
          dq_acc[g][0][e] = fmaf(d0, kv, dq_acc[g][0][e]);
          dq_acc[g][1][e] = fmaf(d1, kv, dq_acc[g][1][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 2 * rq + i;
    if (qi >= Tq) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + g * CH + 2 * cq + e;
        if (c < dp)
          store(dq + q_base + (size_t)qi * dp + c, dq_acc[g][i][e] * scale);
      }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, Tq, Tk, d;
  float scale;
  int causal;
  Bias bias;
  Dropout drop;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, int tiles) {
  if (tiles > 65535) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int W, typename T>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, W>();
  const int tiles = (a.Tk + BM - 1) / BM;
  cudaError_t err = prepare(flash_bwd_dkv_kernel<W, T>, smem, tiles);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, tiles, (a.d + out_cols<W>() - 1) / out_cols<W>());
  flash_bwd_dkv_kernel<W, T><<<grid, NTHREADS, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.Tq,
      a.Tk, a.d, a.scale, a.causal, a.drop);
  return cudaGetLastError();
}

template <int W, typename T>
cudaError_t launch_dq(const Args& a, void* dq, float* dbias, int mode,
                      cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, W>();
  const int tiles = (a.Tq + BM - 1) / BM;
  cudaError_t err = prepare(flash_bwd_dq_kernel<W, T>, smem, tiles);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, tiles, (a.d + out_cols<W>() - 1) / out_cols<W>());
  flash_bwd_dq_kernel<W, T><<<grid, NTHREADS, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(dq), dbias, mode, a.H, a.Tq, a.Tk,
      a.d, a.scale, a.causal, a.drop);
  return cudaGetLastError();
}

// The wide arm's grid: (b*h, 32-row tiles of `rows`, column groups).
cudaError_t wide_grid(const Args& a, int rows, dim3* grid) {
  const int tiles = (rows + wide::ROWS - 1) / wide::ROWS;
  const int groups = wide::groups(a.d);
  if (tiles > 65535 || groups > 65535) return cudaErrorInvalidValue;
  *grid = dim3(a.B * a.H, tiles, groups);
  return cudaSuccess;
}

// The kernels at the smallest instantiated width >= d, or the wide arm
// above kMaxHeadDim.
template <typename T>
cudaError_t dispatch_dkv(const Args& a, void* dk, void* dv, cudaStream_t st) {
  if (a.d > kMaxHeadDim) {
    dim3 grid;
    const cudaError_t err = wide_grid(a, a.Tk, &grid);
    if (err != cudaSuccess) return err;
    wide_dkv_kernel<T><<<grid, WIDE_NT, 0, st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
        a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.Tq,
        a.Tk, a.d, a.scale, a.causal, a.drop);
    return cudaGetLastError();
  }
  return with_width(a.d, [&](auto w) {
    return launch_dkv<decltype(w)::value, T>(a, dk, dv, st);
  });
}

template <typename T>
cudaError_t dispatch_dq(const Args& a, void* dq, float* dbias, int mode,
                        cudaStream_t st) {
  if (a.d > kMaxHeadDim) {
    dim3 grid;
    const cudaError_t err = wide_grid(a, a.Tq, &grid);
    if (err != cudaSuccess) return err;
    wide_dq_kernel<T><<<grid, WIDE_NT, 0, st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
        a.lse, a.delta, static_cast<T*>(dq), dbias, mode, a.H, a.Tq, a.Tk,
        a.d, a.scale, a.causal, a.drop);
    return cudaGetLastError();
  }
  return with_width(a.d, [&](auto w) {
    return launch_dq<decltype(w)::value, T>(a, dq, dbias, mode, st);
  });
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

Args make_args(const void* q, const void* k, const void* v, const void* bias,
               const void* dout, const void* lse, const void* delta, int B,
               int H, int Tq, int Tk, int D, long long sb, long long sh,
               long long sq, long long sk, float scale, int causal,
               int dropout, unsigned threshold, unsigned key0,
               unsigned key1, const void* step, float inv_keep) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), B, H, Tq, Tk, D, scale,
              causal, Bias{static_cast<const float*>(bias), sb, sh, sq, sk},
              Dropout{dropout, threshold, key0, key1, inv_keep,
                      static_cast<const long long*>(step)}};
}

}  // namespace

// Both entry points: dtype 0 = float32, 1 = bfloat16; D, the head dim, a
// multiple of 4 (fp32) or 8 (bf16), above 256 in the wide arm; bias may be
// null; lse
// and delta are [B*H, Tq] fp32; q, k, v, dout and the gradients are
// 16-byte aligned (cp.async copies 16 bytes).  The dropout key is (key0,
// key1), or, when `step` (an int64 in device memory) is not null, the key
// at that step (key_at_step).  Return a cudaError_t (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int D, int dtype, long long sb,
    long long sh, long long sq, long long sk, float scale, int causal,
    int dropout, unsigned threshold, unsigned key0, unsigned key1,
    const void* step, float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return cudaErrorInvalidValue;
  if ((dtype != 0 && dtype != 1) || !head_dim_ok(D, dtype == 0 ? 4 : 2))
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dk) || !aligned16(dv))
    return cudaErrorMisalignedAddress;
  const Args a = make_args(q, k, v, bias, dout, lse, delta, B, H, Tq, Tk, D,
                           sb, sh, sq, sk, scale, causal, dropout, threshold,
                           key0, key1, step, inv_keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dkv<float>(a, dk, dv, st);
  return dispatch_dkv<__nv_bfloat16>(a, dk, dv, st);
}

// dbias_mode: 0 none, 1 row ([B, Tk] fp32, zeroed, summed atomically),
// 2 full ([B*H, Tq, Tk] fp32, zeroed).
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dq,
    void* dbias, int dbias_mode, int B, int H, int Tq, int Tk, int D,
    int dtype, long long sb, long long sh, long long sq, long long sk,
    float scale, int causal, int dropout, unsigned threshold, unsigned key0,
    unsigned key1, const void* step, float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return cudaErrorInvalidValue;
  if ((dtype != 0 && dtype != 1) || !head_dim_ok(D, dtype == 0 ? 4 : 2))
    return cudaErrorInvalidValue;
  if (dbias_mode < 0 || dbias_mode > 2 || (dbias_mode && !dbias))
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dq))
    return cudaErrorMisalignedAddress;
  const Args a = make_args(q, k, v, bias, dout, lse, delta, B, H, Tq, Tk, D,
                           sb, sh, sq, sk, scale, causal, dropout, threshold,
                           key0, key1, step, inv_keep);
  float* db = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dq<float>(a, dq, db, dbias_mode, st);
  return dispatch_dq<__nv_bfloat16>(a, dq, db, dbias_mode, st);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
