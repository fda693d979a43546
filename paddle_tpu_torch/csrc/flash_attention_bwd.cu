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
//   * Two kernels, no atomics on dQ: dQ, dK and dV are deterministic.

#include <type_traits>

#include "flash_attention_common.cuh"

namespace {

using flash::Bias;
using flash::Dropout;
using flash::to_float;

constexpr int WARPS = 4;
constexpr int NTHREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;  // resident rows a CTA: 16 a warp
constexpr int BN = 32;          // rows of a streamed tile

// A shared row: D elements and 8 more (32 bytes of fp32, 16 of bf16).
template <int D>
__host__ __device__ constexpr int ld() {
  return D + 8;
}

// Resident [BM] rows of two tensors, two stages of [BN] rows of two
// tensors, and 4*BN floats (K2a: lse and delta, two stages; K2b: the
// row-dBias partials of four warps).
template <typename T, int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)(2 * BM + 4 * BN) * ld<D>() +
         sizeof(float) * 4 * BN;
}

// Element (r, c) of a shared tile [.][LD].  fp32 rows are 72 or 136 words,
// 8 banks apart, and their columns are XOR-swizzled by 8 on rows with bit
// 2 set: the float2 fragment loads (rows g, columns 2t) and the scalar
// ones (rows 2t and 2t+1, columns g) then hit 32 distinct banks.  bf16
// rows (36 or 68 words) need no swizzle.
template <typename T, int LD>
__device__ __forceinline__ int at(int r, int c) {
  return r * LD + (sizeof(T) == 4 ? c ^ ((r & 4) << 1) : c);
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !full.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of a row-major [n, D] tensor into a shared tile,
// rows past n as zeros.
template <int ROWS, int D, typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int r0, int n) {
  constexpr int PER = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int CPR = D / PER;         // chunks a row
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * PER;
    const bool in = r0 + r < n;
    cp16(dst + at<T, ld<D>()>(r, c), src + (size_t)(in ? r0 + r : 0) * D + c,
         in);
  }
}

// Entry r0 + i of a fp32 row of n into dst[i], zero past n.
__device__ __forceinline__ void stage_entry(float* dst,
                                            const float* __restrict__ src,
                                            int r0, int n, int i) {
  const bool in = r0 + i < n;
  cp4(dst + i, src + (in ? r0 + i : 0), in);
}

// ---------------------------------------------------------------------------
// tensor-core products
// ---------------------------------------------------------------------------

// hi = x rounded to TF32, to nearest with ties away from zero (the
// rounding of cvt.rna.tf32.f32 for finite x), lo = x - hi, exact; the
// tensor core reads the top 19 bits of each.  Without SPLIT, x is exact
// in TF32 (a bf16 value): hi = x.
template <bool SPLIT, int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (SPLIT) {
      hi[i] = (__float_as_uint(x[i]) + 0x1000u) & 0xffffe000u;
      lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i]));
    } else {
      hi[i] = __float_as_uint(x[i]);
    }
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b and d += e.f over one m16n8k8 step, the two chains interleaved:
// the small terms (a_lo.b_hi, a_hi.b_lo where the operands carry them)
// first, then hi.hi.
template <bool A_LO, bool B_LO>
__device__ __forceinline__ void mma2x3(
    float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
    const uint32_t (&bh)[2], const uint32_t (&bl)[2], float (&d)[4],
    const uint32_t (&eh)[4], const uint32_t (&el)[4],
    const uint32_t (&fh)[2], const uint32_t (&fl)[2]) {
  if (A_LO) {
    mma(c, al, bh);
    mma(d, el, fh);
  }
  if (B_LO) {
    mma(c, ah, bl);
    mma(d, eh, fl);
  }
  mma(c, ah, bh);
  mma(d, eh, fh);
}

template <typename T>
__device__ __forceinline__ float2 ld2(const T* p);
template <>
__device__ __forceinline__ float2 ld2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 ld2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Fragment loads from a shared tile, g = lane / 4, t = lane % 4, k
// permuted as above.  A (16 x 8) of rows r0.. and columns c0..
template <int LD, typename T>
__device__ __forceinline__ void load_a(float (&a)[4], const T* X, int r0,
                                       int c0, int g, int t) {
  const float2 x0 = ld2(X + at<T, LD>(r0 + g, c0 + 2 * t));
  const float2 x1 = ld2(X + at<T, LD>(r0 + g + 8, c0 + 2 * t));
  a[0] = x0.x;
  a[1] = x1.x;
  a[2] = x0.y;
  a[3] = x1.y;
}

// B (8 x 8, k x n) = X^T for X stored [n][k]: rows n0.., columns k0..
template <int LD, typename T>
__device__ __forceinline__ void load_bt(float (&b)[2], const T* X, int n0,
                                        int k0, int g, int t) {
  const float2 x = ld2(X + at<T, LD>(n0 + g, k0 + 2 * t));
  b[0] = x.x;
  b[1] = x.y;
}

// B (8 x 8) of X stored [k][n]: rows k0 + 2t and k0 + 2t + 1, column n0 + g.
template <int LD, typename T>
__device__ __forceinline__ void load_bp(float (&b)[2], const T* X, int k0,
                                        int n0, int g, int t) {
  b[0] = to_float(X[at<T, LD>(k0 + 2 * t, n0 + g)]);
  b[1] = to_float(X[at<T, LD>(k0 + 2 * t + 1, n0 + g)]);
}

// The accumulators of a 16 x (8*NJ) tile as NJ A fragments (16 x 8 each,
// k permuted as load_bp expects), split for 3xTF32.
template <int NJ>
__device__ __forceinline__ void as_a(const float (&c)[NJ][4],
                                     uint32_t (&hi)[NJ][4],
                                     uint32_t (&lo)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float a[4] = {c[j][0], c[j][2], c[j][1], c[j][3]};
    split<true>(a, hi[j], lo[j]);
  }
}

// c1 = A1.B1^T and c2 = A2.B2^T for the warp's 16 rows r0.. of the
// resident A1, A2 and the BN rows of the streamed B1, B2 (S and dP).
template <int D, int NJ, typename T>
__device__ __forceinline__ void two_products(const T* A1, const T* A2,
                                             const T* B1, const T* B2,
                                             int r0, int g, int t,
                                             float (&c1)[NJ][4],
                                             float (&c2)[NJ][4]) {
  constexpr int LD = ld<D>();
  constexpr bool SPLIT = std::is_same<T, float>::value;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// exp(x - lse), 0 where the row's lse is -inf (every score masked) or x
// is -inf.
__device__ __forceinline__ float exp_lse(float x, float lse) {
  return expf(x - (isfinite(lse) ? lse : INFINITY));
}

// ---------------------------------------------------------------------------
// K2a: dK, dV
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 3 : 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, Bias bias,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk, float scale,
                     int causal, Dropout drop) {
  constexpr int LD = ld<D>();
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int NJ = BN / 8;  // 8-column blocks of S^T (q) a tile
  constexpr int ND = D / 8;   // 8-column blocks of dK, dV
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
  const T* qb = q + (size_t)bh * Tq * D;
  const T* dob = dout + (size_t)bh * Tq * D;
  const float* lseb = lse + (size_t)bh * Tq;
  const float* dlb = delta + (size_t)bh * Tq;
  const size_t kv_base = (size_t)bh * Tk * D;
  const float* brow = bias.ptr ? bias.ptr + b * bias.sb + h * bias.sh
                               : nullptr;

  auto stage_q = [&](int tile, int st) {
    const int q0 = tile * BN;
    stage<BN, D>(Qs + st * BN * LD, qb, q0, Tq);
    stage<BN, D>(dOs + st * BN * LD, dob, q0, Tq);
    if (threadIdx.x < BN)
      stage_entry(lse_s + st * BN, lseb, q0, Tq, threadIdx.x);
    else if (threadIdx.x < 2 * BN)
      stage_entry(dl_s + st * BN, dlb, q0, Tq, threadIdx.x - BN);
  };

  // causal: q tiles wholly above this K tile's first key see none of it
  const int t0 = causal ? k0 / BN : 0;
  const int nt = (Tq + BN - 1) / BN;
  stage<BM, D>(Ks, k + kv_base, k0, Tk);
  stage<BM, D>(Vs, v + kv_base, k0, Tk);
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

    // S^T = K Q^T and dP^T = V dO^T: 16 K rows x BN q columns a warp
    float s[NJ][4] = {}, dp[NJ][4] = {};
    if (live) two_products<D, NJ>(Ks, Vs, Qt, dOt, 16 * w, g, t, s, dp);

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
          const bool kp =
              drop.keep(k0 + kr + 8 * (e >> 1), q0 + qc + (e & 1), bh);
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
          load_bp<LD>(of, dOt, 8 * j, 8 * n, g, t);
          load_bp<LD>(qf, Qt, 8 * j, 8 * n, g, t);
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
    T* dkr = dk + kv_base + (size_t)kj * D;
    T* dvr = dv + kv_base + (size_t)kj * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = 8 * n + 2 * t;
      store2(dkr + c, dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
      store2(dvr + c, dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2b: dQ, dBias
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 3 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, Bias bias,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    float* __restrict__ dbias, int dbias_mode, int H,
                    int Tq, int Tk, float scale, int causal, Dropout drop) {
  constexpr int LD = ld<D>();
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int NJ = BN / 8;  // 8-column blocks of S (k) a tile
  constexpr int ND = D / 8;   // 8-column blocks of dQ
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
  const size_t q_base = (size_t)bh * Tq * D;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const float* brow = bias.ptr ? bias.ptr + b * bias.sb + h * bias.sh
                               : nullptr;
  const bool row_bias = brow != nullptr && bias.sq == 0;

  auto stage_kv = [&](int tile, int st) {
    stage<BN, D>(Ks + st * BN * LD, kb, tile * BN, Tk);
    stage<BN, D>(Vs + st * BN * LD, vb, tile * BN, Tk);
  };

  int nt = (Tk + BN - 1) / BN;
  if (causal) nt = min(nt, (q0 + BM - 1) / BN + 1);
  stage<BM, D>(Qs, q + q_base, q0, Tq);
  stage<BM, D>(dOs, dout + q_base, q0, Tq);
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
    if (live) two_products<D, NJ>(Qs, dOs, Kt, Vt, 16 * w, g, t, s, dp);

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

    if (dbias_mode == 2) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          const int qi = q0 + qr + 8 * (e >> 1);
          if (qi < Tq && kj < Tk)
            dbias[((size_t)bh * Tq + qi) * Tk + kj] = dp[j][e];
        }
    } else if (dbias_mode == 1) {
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
          load_bp<LD>(f0, Kt, 8 * j, 8 * n, g, t);
          load_bp<LD>(f1, Kt, 8 * j, 8 * n + 8, g, t);
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
    T* dqr = dq + q_base + (size_t)qi * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2(dqr + 8 * n + 2 * t, dq_acc[n][2 * r] * scale,
             dq_acc[n][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, Tq, Tk;
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

template <int D, typename T>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, D>();
  const int tiles = (a.Tk + BM - 1) / BM;
  cudaError_t err = prepare(flash_bwd_dkv_kernel<D, T>, smem, tiles);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D, T><<<dim3(a.B * a.H, tiles), NTHREADS, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.Tq,
      a.Tk, a.scale, a.causal, a.drop);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dq(const Args& a, void* dq, float* dbias, int mode,
                      cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, D>();
  const int tiles = (a.Tq + BM - 1) / BM;
  cudaError_t err = prepare(flash_bwd_dq_kernel<D, T>, smem, tiles);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D, T><<<dim3(a.B * a.H, tiles), NTHREADS, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(dq), dbias, mode, a.H, a.Tq, a.Tk,
      a.scale, a.causal, a.drop);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
// lse and delta are [B*H, Tq] fp32; q, k, v, dout and the gradients are
// 16-byte aligned (cp.async copies 16 bytes).  Return a cudaError_t (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int D, int dtype, long long sb,
    long long sh, long long sq, long long sk, float scale, int causal,
    int dropout, unsigned threshold, unsigned key0, unsigned key1,
    float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dk) || !aligned16(dv))
    return cudaErrorMisalignedAddress;
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
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dq))
    return cudaErrorMisalignedAddress;
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
