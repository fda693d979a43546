// Tensor-core and asynchronous-copy pieces shared by the flash-attention
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu): shared tiles
// with padded, swizzled rows filled by 16-byte cp.async, warp-level
// mma.sync products (TF32 m16n8k8, with the 3xTF32 split for fp32
// operands, and bf16 m16n8k16), and their fragment loads.
//
// Head widths.  The kernels are instantiated at the widths of HeadWidths
// (32, 64, 128, 256; the one list, which with_width walks); a head dim d
// runs at the smallest W >= d.  Rows are read from
// and written to the dense [n, d] tensors; the tile columns d..W-1 are
// zero-filled on load, so they add nothing to q.k^T and give zero output
// columns, which are not written (the forward also skips products over
// whole 8- or 16-column blocks past d).  d must be a multiple of
// the 16-byte chunk (4 fp32, 8 bf16 values): the wrapper pads other head
// dims with zero columns.  Head dims above kMaxHeadDim run in the wide arm
// (flash_attention_wide.cuh), which the C entries dispatch to instead.
#pragma once

#include <type_traits>

#include "flash_attention_common.cuh"

namespace flash {

constexpr int kMaxHeadDim = 256;

// The widths the kernels are instantiated at, narrowest first; the last
// is kMaxHeadDim.
template <int... Ws>
struct Widths {};
using HeadWidths = Widths<32, 64, 128, 256>;

template <int W, int... Ws, typename F>
cudaError_t with_width(int d, F& f, Widths<W, Ws...>) {
  if constexpr (sizeof...(Ws) == 0) {
    static_assert(W == kMaxHeadDim, "the widest width is kMaxHeadDim");
    return f(std::integral_constant<int, W>{});
  } else {
    if (d <= W) return f(std::integral_constant<int, W>{});
    return with_width(d, f, Widths<Ws...>{});
  }
}

// f(std::integral_constant<int, W>{}) at the smallest width W >= d: the
// kernel instantiation a head dim d <= kMaxHeadDim runs at.
template <typename F>
cudaError_t with_width(int d, F&& f) {
  return with_width(d, f, HeadWidths{});
}

// A shared row: W elements and 8 more (32 bytes of fp32, 16 of bf16).
template <int W>
__host__ __device__ constexpr int ld() {
  return W + 8;
}

// Element (r, c) of a shared tile [.][LD].  fp32 rows (LD = W + 8 words,
// W a multiple of 16, so rows 2 apart are 16 banks apart) have their
// columns XOR-swizzled by 8 on rows with bit 2 set: the float2 fragment
// loads (rows g, columns 2t) and the scalar ones (rows 2t and 2t+1,
// columns g) then hit 32 distinct banks.  bf16 rows need no swizzle: the
// 32-bit loads (rows g, columns 2t) and ldmatrix's 16-byte rows hit
// distinct banks as they are.
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

// Rows [r0, r0 + ROWS) of a row-major [n, d] tensor into a shared tile of
// width W, by NT threads: rows past n and columns past d as zeros.
template <int ROWS, int W, int NT, typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int r0, int n, int d) {
  constexpr int PER = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int CPR = W / PER;         // chunks a row
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * PER;
    const bool in = (r0 + r < n) & (c < d);
    cp16(dst + at<T, ld<W>()>(r, c),
         src + (in ? (size_t)(r0 + r) * d + c : 0), in);
  }
}

// Entry r0 + i of a fp32 row of n (element stride `stride`) into dst[i],
// zero past n.
__device__ __forceinline__ void stage_entry(float* dst,
                                            const float* __restrict__ src,
                                            int r0, int n, int i,
                                            long long stride = 1) {
  const bool in = r0 + i < n;
  cp4(dst + i, src + (in ? (r0 + i) * stride : 0), in);
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

// c += a.b, m16n8k8, TF32 operands, fp32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b, m16n8k16, bf16 operands (two a register), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// TF32 fragment loads from a shared tile, g = lane / 4, t = lane % 4, with
// the k order of a product permuted (k = t <-> column 2t, k = t + 4 <->
// column 2t + 1), so an accumulator fragment is an A fragment as it
// stands and the S-shaped fragments read two neighbouring values at once.
// A (16 x 8) of rows r0.. and columns c0..
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

// The accumulators of a 16 x (8*NJ) tile as NJ TF32 A fragments (16 x 8
// each, k permuted as load_bp expects), split for 3xTF32.
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

// Two floats as a bf16x2 register (x in the low half), rounded to
// nearest.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 32-bit word (two bf16) at element (r, c) of a bf16 tile.
template <int LD>
__device__ __forceinline__ uint32_t ld_b32(const __nv_bfloat16* X, int r,
                                           int c) {
  return *reinterpret_cast<const uint32_t*>(X + r * LD + c);
}

// Four 8x8 bf16 matrices, transposed: lane l gives the row address of
// row l % 8 of matrix l / 8; register i receives, from matrix i, the
// elements (2 * (lane % 4), lane / 4) and (2 * (lane % 4) + 1, lane / 4).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// What the C entries take: any d >= 1 that is a whole 16-byte chunk (the
// HeadWidths kernels up to kMaxHeadDim, the wide arm above it).
__host__ __device__ constexpr bool head_dim_ok(int d, int elem_bytes) {
  return d > 0 && d % (16 / elem_bytes) == 0;
}

}  // namespace flash
