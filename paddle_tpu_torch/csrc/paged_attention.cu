// Paged decode attention (K4) and its int8-arena arm (K5) for Hopper
// (sm_90a), plain C interface.
//
// Replaces two TPU kernels that share one flash loop in the JAX package,
// paddle_tpu/ops/pallas_kernels.py::_paged_attn_kernel_impl (:958):
//   K4  _paged_attention_call (:1033) -> pl.pallas_call (:1064), float32
//       or bfloat16 K/V arenas;
//   K5  paddle_tpu/ops/quant_kernels.py::_paged_attn_quant_call (:257) ->
//       pl.pallas_call (:299), int8 K/V arenas with float32 per-token
//       scale rows, dequantized inside the tile.
// Over q [S, H, D] (one decode query per slot), arenas [N, Bs, H, D], an
// int32 block table [S, MB] and int32 lengths [S] it computes, for each
// slot s and head h, with L = min(lengths[s], MB * Bs) and token t living
// at position t % Bs of block table[s, t / Bs]:
//
//     k_t = k_arena[blk, pos, h, :] (* k_scale[blk, pos] in the int8 arm)
//     v_t = v_arena[blk, pos, h, :] (* v_scale[blk, pos])
//     s_t = (q[s, h, :] * scale) . k_t                       for t < L
//     out[s, h, :] = sum_t softmax(s)_t v_t                  (0 when L = 0)
//
// in float32, written in q's dtype.  The TPU kernel walked a (slot, block)
// grid whose sequential block axis carried the online-softmax state in
// VMEM scratch; its index map fetched the table-named block for each step.
// A block id outside [0, N) contributes nothing and is never read (the
// pool's tables always name real blocks).
//
// Which kernel serves which arm:
//   paged_attention_kernel        K4 (float32, bfloat16 arenas), D <= 256
//   paged_attention_split_kernel  K5 (int8 arenas), D <= 256
//   paged_attention_wide_kernel   K4 and K5 above D 256
//
// paged_attention_kernel.  One CTA of 4 warps per (slot, head).  Each warp
// owns every fourth block of the slot's chain (blocks past the length are
// never visited; the tail block is cut at the length, position by
// position) and keeps its own online softmax: running max m, denominator l
// and the accumulator, with q (pre-scaled) and the accumulator in
// registers, lane i holding elements i, i + 32, ... of the head dimension
// (at most 8 a lane).  A token's score is one dot product per lane and a
// 5-step shuffle reduction; its K and V rows are read by the warp as
// coalesced strided loads.  At the end the four warps' (m, l, acc) are
// merged through shared memory by the usual rescale by exp(m_w - M).
//
// paged_attention_wide_kernel.  Above D 256 a second grid axis splits the
// head dim into column groups of 256: each CTA forms every token's full-D
// score (q read from global memory, where it stays in L1) and accumulates
// only its group's columns, in the loop above; in the int8 arm each element
// is multiplied by its token's fp32 scale in registers as it is loaded.
//
// paged_attention_split_kernel.  A slot's chain is a serial walk in the
// loops above: each token's loads wait on the previous token's shuffles and
// exponentials, a DRAM round trip a token.  Here the chain is cut across
// CTAs and each CTA streams its part a block at a time:
//   - a 1-D grid of (slot, head group, split) CTAs.  The wrapper fixes the
//     plan from the shapes alone (paged_kernels.split_plan), never from the
//     lengths: the most splits that keep one wave of two CTAs an SM (256
//     CTAs at bench_kernels.py's decode shape, 4 splits of 4 blocks).  A
//     split whose blocks all lie past its slot's length contributes an
//     empty state (m = -inf, l = 0);
//   - a head group is G consecutive heads, G * roundup(D, 16) <= 1024 bytes
//     and a warp a head (at most 8): per token, the group's rows are G * D
//     contiguous bytes of the arena.
//     A tile is a block (or 16 positions of a larger one): its K and V rows
//     for the group and its two scale rows are copied into shared memory
//     with cp.async, 16 bytes a thread where D and the arena pointers allow
//     (8 or 4 otherwise; a byte at a time, synchronously, where D % 4 != 0
//     or a pointer is not 4-byte aligned), in a ring of 2 tiles (up to 32 KB
//     a tile; three CTAs an SM up to D 128);
//   - compute: a token's row is spread over roundup_pow2(D / 16) lanes, 16
//     values each, and 32 / lanes tokens of the head (at most 16) sit side
//     by side in the warp.  A lane turns its 16-byte word into 16 floats exactly with
//     byte permutes and one subtraction (2^23 + 128 + x is an exact float;
//     no int-to-float conversion), dots it with its 16 values of q (pre-
//     scaled, in registers; four partial sums) and the head's lanes add
//     the parts in log2(lanes) shuffles; K's scale multiplies the reduced
//     dot once, s = ks * (q . k8); V's scale is folded into the token's
//     weight, w = p * vs.  The tile's max over the head's tokens is two
//     more shuffles, so (m, l, acc) are rescaled once per tile, not once
//     per token; the lanes of one chunk add their sums at the end;
//   - merge in the same launch: with one split the warp writes out;
//     otherwise the CTA writes its (m, l, acc) per head to a workspace the
//     wrapper allocates (torch.empty) and counts itself in a per-(slot,
//     head group) counter (one thread: __threadfence, atomicAdd); the last
//     CTA to arrive merges every split's state (a warp a head) and sets the
//     counter back to 0 for the next launch (the wrapper keeps the
//     counters, zeroed once, per device and stream).  CTAs that finish
//     early leave at once.  No second kernel, no dequantized copy of the
//     arena.  Accurate expf and IEEE division throughout (no fast math).
//
// What bounds it.  Bytes: every live token's K and V row read once (2 B a
// value in bf16, 4 in fp32, 1 in int8 plus two fp32 scales a token), q read
// and out written once.  At bench_kernels.py's decode shape (S 64, H 8,
// D 128, Bs 16, lengths 192-256) that is ~59 MB in bf16 (~17.6 us at the
// H100 SXM's published 3.35 TB/s) and ~30 MB in int8 (~9 us); the 4 flops
// a value take under 1 us at 67 TFLOP/s fp32.  The int8 arm is bound on
// the card by its instructions' latency instead (~4 instructions a value:
// the byte-permute conversion and the FMA on each side): its warps almost
// never wait for their copies (PERF.md §6).  chip_smoke.py's
// paged_kernel_phase prints the measured times beside these bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_D = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// NPER: head-dimension elements a lane holds (ceil(D / 32) rounded up to a
// power of two).  k_scale/v_scale are null for float arenas.
template <typename TQ, typename TKV, int NPER>
__global__ void __launch_bounds__(THREADS)
    paged_attention_kernel(const TQ* __restrict__ q,
                           const TKV* __restrict__ k_arena,
                           const TKV* __restrict__ v_arena,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ table,
                           const int* __restrict__ lengths,
                           TQ* __restrict__ out, int H, int D, int Bs,
                           int MB, int N, float scale) {
  __shared__ float sh_acc[WARPS][MAX_D];
  __shared__ float sh_m[WARPS];
  __shared__ float sh_l[WARPS];

  const long long row = blockIdx.x;  // s * H + h
  const int s = static_cast<int>(row / H);
  const int h = static_cast<int>(row % H);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = min(max(lengths[s], 0), MB * Bs);

  float qr[NPER], acc[NPER];
#pragma unroll
  for (int i = 0; i < NPER; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? to_f(q[row * D + d]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  const long long tok = static_cast<long long>(H) * D;  // position stride
  const int nblk = (len + Bs - 1) / Bs;
  for (int b = warp; b < nblk; b += WARPS) {
    const int blk = table[static_cast<long long>(s) * MB + b];
    if (blk < 0 || blk >= N) continue;
    const int fill = min(Bs, len - b * Bs);
    const long long first = static_cast<long long>(blk) * Bs;
    for (int p = 0; p < fill; ++p) {
      const long long off = (first + p) * tok + static_cast<long long>(h) * D;
      float ks = 1.f, vs = 1.f;
      if (k_scale != nullptr) {
        ks = k_scale[first + p];
        vs = v_scale[first + p];
      }
      float dot = 0.f, vr[NPER];
#pragma unroll
      for (int i = 0; i < NPER; ++i) {
        const int d = lane + 32 * i;
        vr[i] = 0.f;
        if (d < D) {
          float kk = to_f(k_arena[off + d]);
          float vv = to_f(v_arena[off + d]);
          if (k_scale != nullptr) {
            kk *= ks;
            vv *= vs;
          }
          dot += qr[i] * kk;
          vr[i] = vv;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
      const float m_new = fmaxf(m, dot);
      const float corr = expf(m - m_new);  // 0 while m is -inf
      const float pr = expf(dot - m_new);
      l = l * corr + pr;
#pragma unroll
      for (int i = 0; i < NPER; ++i) acc[i] = acc[i] * corr + pr * vr[i];
      m = m_new;
    }
  }

  // merge the four warps' online-softmax states
  if (lane == 0) {
    sh_m[warp] = m;
    sh_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < NPER; ++i) {
    const int d = lane + 32 * i;
    if (d < D) sh_acc[warp][d] = acc[i];
  }
  __syncthreads();
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sh_m[w]);
  float wt[WARPS], denom = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    wt[w] = sh_m[w] == -CUDART_INF_F ? 0.f : expf(sh_m[w] - mx);
    denom += sh_l[w] * wt[w];
  }
  denom = fmaxf(denom, 1e-20f);
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += sh_acc[w][d] * wt[w];
    store(out + row * D + d, a / denom);
  }
}

// Head dims above MAX_D: CTA (slot * H + head, group) forms each token's
// score over the whole head dim and accumulates the group's MAX_D columns
// c0 .. c0 + MAX_D - 1; otherwise the loop of paged_attention_kernel.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
    paged_attention_wide_kernel(const TQ* __restrict__ q,
                                const TKV* __restrict__ k_arena,
                                const TKV* __restrict__ v_arena,
                                const float* __restrict__ k_scale,
                                const float* __restrict__ v_scale,
                                const int* __restrict__ table,
                                const int* __restrict__ lengths,
                                TQ* __restrict__ out, int H, int D, int Bs,
                                int MB, int N, float scale) {
  constexpr int NPER = MAX_D / 32;
  __shared__ float sh_acc[WARPS][MAX_D];
  __shared__ float sh_m[WARPS];
  __shared__ float sh_l[WARPS];

  const long long row = blockIdx.x;  // s * H + h
  const int s = static_cast<int>(row / H);
  const int h = static_cast<int>(row % H);
  const int c0 = blockIdx.y * MAX_D;
  const int ncols = min(MAX_D, D - c0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = min(max(lengths[s], 0), MB * Bs);
  const TQ* qrow = q + row * D;

  float acc[NPER];
#pragma unroll
  for (int i = 0; i < NPER; ++i) acc[i] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  const long long tok = static_cast<long long>(H) * D;  // position stride
  const int nblk = (len + Bs - 1) / Bs;
  for (int b = warp; b < nblk; b += WARPS) {
    const int blk = table[static_cast<long long>(s) * MB + b];
    if (blk < 0 || blk >= N) continue;
    const int fill = min(Bs, len - b * Bs);
    const long long first = static_cast<long long>(blk) * Bs;
    for (int p = 0; p < fill; ++p) {
      const long long off = (first + p) * tok + static_cast<long long>(h) * D;
      float ks = 1.f, vs = 1.f;
      if (k_scale != nullptr) {
        ks = k_scale[first + p];
        vs = v_scale[first + p];
      }
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) {
        float kk = to_f(k_arena[off + d]);
        if (k_scale != nullptr) kk *= ks;
        dot += to_f(qrow[d]) * scale * kk;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
      const float m_new = fmaxf(m, dot);
      const float corr = expf(m - m_new);  // 0 while m is -inf
      const float pr = expf(dot - m_new);
      l = l * corr + pr;
#pragma unroll
      for (int i = 0; i < NPER; ++i) {
        const int c = lane + 32 * i;
        float vv = 0.f;
        if (c < ncols) {
          vv = to_f(v_arena[off + c0 + c]);
          if (v_scale != nullptr) vv *= vs;
        }
        acc[i] = acc[i] * corr + pr * vv;
      }
      m = m_new;
    }
  }

  // merge the four warps' online-softmax states
  if (lane == 0) {
    sh_m[warp] = m;
    sh_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < NPER; ++i) sh_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sh_m[w]);
  float wt[WARPS], denom = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    wt[w] = sh_m[w] == -CUDART_INF_F ? 0.f : expf(sh_m[w] - mx);
    denom += sh_l[w] * wt[w];
  }
  denom = fmaxf(denom, 1e-20f);
  for (int c = threadIdx.x; c < ncols; c += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += sh_acc[w][c] * wt[w];
    store(out + row * D + c0 + c, a / denom);
  }
}

// ---------------------------------------------------------------------
// K5 at D <= 256: the split-KV walk (see the header)
// ---------------------------------------------------------------------

constexpr int SPLIT_WARPS = 8;       // at most, a CTA
constexpr int SPLIT_STAGES = 2;
constexpr int TILE_MAX = 16;         // tokens staged at a time
constexpr int GROUP_BYTES = 1024;    // a head group's padded row
constexpr int SMEM_MAX = 226 * 1024;  // 227 KB less the static
// 2^23 + 128: the float whose low mantissa byte is (x ^ 0x80) is this + x
constexpr float INT8_BIAS = 8388736.f;

struct SplitParams {
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const int* table;
  const int* lengths;
  float* work;      // [S * HG, splits, G * (D + 2)] partials (splits > 1)
  int* counters;    // [S * HG], zero between launches (splits > 1)
  long long rows;   // S * HG
  long long tok;    // H * D: a position's stride in the arenas
  int H, D, Bs, MB, N;
  float scale;
  int G, HG, splits, bps;  // head group, groups, splits, blocks a split
  int TT, TPB;             // tile tokens, tiles a block
  int DP, lg, tg, KT;      // padded D; log2 of lanes a token, of tokens a
                           // warp; tokens a lane a tile
  int threads;             // 32 * G: a warp a head
  int vec;                 // copy width, bytes (16, 8, 4, or 1: plain)
  int kbytes, stage;       // K (= V) bytes of a tile, bytes of a stage
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 int8 values of a 16-byte word, exactly, as floats: each byte with its
// sign bit flipped (x + 128) is placed in the low byte of 2^23's bits.
__device__ __forceinline__ void int8x16(const uint4 w, float f[16]) {
  const unsigned u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                         w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * j + b] =
          __uint_as_float(__byte_perm(u[j], 0x4B000000u, 0x7440u | b)) -
          INT8_BIAS;
}

// Lane layout: a token's head row is spread over 2^lg lanes (16 values
// each), 2^tg tokens of the head side by side in its warp (where one lane
// holds a row, lanes 16-31 idle).  The warp owns its head: its max,
// denominator and the merge of its token lanes are shuffles.
// KMAX: a lane's most tokens in a tile (4 up to D 128, 8 above: 16 lanes
// a token's row).  Three CTAs an SM up to D 128 (80 registers), two above
// (the eight scores need more).
template <typename TQ, int KMAX>
__global__ void __launch_bounds__(SPLIT_WARPS * 32, KMAX <= 4 ? 3 : 2)
    paged_attention_split_kernel(const TQ* __restrict__ q,
                                 TQ* __restrict__ out, const SplitParams a) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int sh_fill[SPLIT_STAGES];
  __shared__ int sh_last;

  const long long row = blockIdx.x / a.splits;  // s * HG + head group
  const int split = static_cast<int>(blockIdx.x % a.splits);
  const int tid = threadIdx.x;
  const int nthreads = a.threads;
  const int s = static_cast<int>(row / a.HG);
  const int h0 = static_cast<int>(row % a.HG) * a.G;
  const int gv = min(a.G, a.H - h0);  // heads of this group
  const int D = a.D, DP = a.DP, G = a.G;

  // this split's blocks; the length and the first tiles' block ids are
  // read together (the ids do not depend on the length)
  const int b0 = split * a.bps;
  const int nb = min(a.bps, a.MB - b0);
  const int* tab = a.table + static_cast<long long>(s) * a.MB + b0;
  const int ntiles = nb * a.TPB;
  int ahead[SPLIT_STAGES];  // block ids of tiles 0 .. SPLIT_STAGES - 1
#pragma unroll
  for (int j = 0; j < SPLIT_STAGES; ++j)
    ahead[j] = j < ntiles ? __ldg(tab + j / a.TPB) : -1;
  const int len = min(max(__ldg(a.lengths + s), 0), a.MB * a.Bs);
  int nlive = 0;  // tiles that hold live tokens
  {
    const int rem = len - b0 * a.Bs;
    if (rem > 0)
      nlive = min(ntiles, (rem / a.Bs) * a.TPB +
                              (rem % a.Bs + a.TT - 1) / a.TT);
  }

  // compute role: lane c of token lane tl of head hl
  const int lane = tid & 31;
  const int lanes = 1 << a.lg;
  const int c = lane & (lanes - 1);
  const int tl = (lane >> a.lg) & ((1 << a.tg) - 1);
  const int hl = tid >> 5;
  const bool head_on = hl < gv && (lane >> (a.lg + a.tg)) == 0;
  const bool lane_on = head_on && c * 16 < D;
  const int in_row = lane_on ? hl * DP + c * 16 : 0;  // smem bytes
  const int tstep = 1 << a.tg;
  const int gdp = G * DP;

  // copy role: one VEC-byte piece of each staged token's rows
  const int pieces = D / a.vec;
  const int R = gv * pieces;
  const bool fast = a.vec >= 4 && R <= nthreads;
  const int cstep = fast ? nthreads / R : 0;
  const int ct0 = fast ? tid / R : 0;
  const int cr = fast ? tid % R : 0;
  const long long src_in =
      static_cast<long long>(h0 + cr / pieces) * D + (cr % pieces) * a.vec;
  const int dst_in = (cr / pieces) * DP + (cr % pieces) * a.vec;

  auto issue = [&](int j, int blk) {
    unsigned char* kst = ring + (j % SPLIT_STAGES) * a.stage;
    unsigned char* vst = kst + a.kbytes;
    float* kss = reinterpret_cast<float*>(vst + a.kbytes);
    float* vss = kss + a.TT;
    if (j < nlive) {
      const int b = b0 + j / a.TPB;
      const int tok0 = (j % a.TPB) * a.TT;
      int fill = min(min(a.TT, a.Bs - tok0), len - (b * a.Bs + tok0));
      if (blk < 0 || blk >= a.N) fill = 0;
      if (tid == 0) sh_fill[j % SPLIT_STAGES] = fill;
      const long long first = static_cast<long long>(blk) * a.Bs + tok0;
      if (fill > 0) {
        const int8_t* kg = a.k + first * a.tok;
        const int8_t* vg = a.v + first * a.tok;
        if (fast) {
          if (ct0 < cstep)
            for (int t = ct0; t < fill; t += cstep) {
              cp_async(kst + t * gdp + dst_in, kg + t * a.tok + src_in,
                       a.vec);
              cp_async(vst + t * gdp + dst_in, vg + t * a.tok + src_in,
                       a.vec);
            }
        } else {
          for (int e = tid; e < fill * R; e += nthreads) {
            const int t = e / R, r = e % R;
            const int hh = r / pieces, pp = (r % pieces) * a.vec;
            const long long g =
                t * a.tok + static_cast<long long>(h0 + hh) * D + pp;
            const int o = t * gdp + hh * DP + pp;
            if (a.vec >= 4) {
              cp_async(kst + o, kg + g, a.vec);
              cp_async(vst + o, vg + g, a.vec);
            } else {
              kst[o] = static_cast<unsigned char>(kg[g]);
              vst[o] = static_cast<unsigned char>(vg[g]);
            }
          }
        }
        for (int t = tid; t < 2 * fill; t += nthreads) {
          if (t < fill)
            cp_async(kss + t, a.ks + first + t, 4);
          else
            cp_async(vss + t - fill, a.vs + first + t - fill, 4);
        }
      }
    }
    cp_commit();
  };

  float qr[16], acc[16];
  {
    const long long qoff = (static_cast<long long>(s) * a.H + h0 + hl) * D;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int d = c * 16 + i;
      qr[i] = lane_on && d < D ? to_f(q[qoff + d]) * a.scale : 0.f;
      acc[i] = 0.f;
    }
  }
  // the head's running max (the same in all its lanes) and this lane's
  // share of the denominator
  float m = -CUDART_INF_F, l = 0.f;

#pragma unroll
  for (int j = 0; j < SPLIT_STAGES - 1; ++j) issue(j, ahead[j]);
  int next = ahead[SPLIT_STAGES - 1];  // the block id of the next issue
  for (int i = 0; i < nlive; ++i) {
    cp_wait<SPLIT_STAGES - 2>();
    __syncthreads();
    issue(i + SPLIT_STAGES - 1, next);
    // read one issue ahead: the load overlaps this tile's compute
    const int j2 = i + SPLIT_STAGES;
    next = j2 < nlive ? __ldg(tab + j2 / a.TPB) : -1;

    const int fill = sh_fill[i % SPLIT_STAGES];
    if (fill == 0) continue;  // a block id outside the arena
    const unsigned char* kst = ring + (i % SPLIT_STAGES) * a.stage;
    const unsigned char* vst = kst + a.kbytes;
    const float* kss = reinterpret_cast<const float*>(vst + a.kbytes);
    const float* vss = kss + a.TT;

    // scores of this lane's tokens t = tl + k * 2^tg (t < fill), no
    // branch: a token past the fill reads row 0 and is masked after
    float sc[KMAX];
    float mt = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < a.KT) {
        const int t = tl + k * tstep;
        const bool on = t < fill;
        float f[16];
        int8x16(*reinterpret_cast<const uint4*>(kst + (on ? t : 0) * gdp +
                                                in_row),
                f);
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
          d0 = fmaf(qr[e], f[e], d0);
          d1 = fmaf(qr[e + 1], f[e + 1], d1);
          d2 = fmaf(qr[e + 2], f[e + 2], d2);
          d3 = fmaf(qr[e + 3], f[e + 3], d3);
        }
        float dot = (d0 + d1) + (d2 + d3);
        for (int o = lanes >> 1; o > 0; o >>= 1)
          dot += __shfl_xor_sync(FULL, dot, o);
        sc[k] = on ? kss[on ? t : 0] * dot : -CUDART_INF_F;
        mt = fmaxf(mt, sc[k]);
      }
    }
    // the tile's max over the head's token lanes
    for (int o = lanes; o < (lanes << a.tg); o <<= 1)
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, o));

    // one rescale of (m, l, acc) for the tile, then its weighted V rows
    const float m_new = fmaxf(m, mt);  // finite: the tile has a token
    const float corr = expf(m - m_new);  // 0 while m is -inf
    l *= corr;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] *= corr;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < a.KT) {
        const int t = tl + k * tstep;
        const bool on = t < fill;
        const float p = expf(sc[k] - m_new);  // 0 past the fill
        l += p;
        const float w = on ? p * vss[on ? t : 0] : 0.f;
        float f[16];
        int8x16(*reinterpret_cast<const uint4*>(vst + (on ? t : 0) * gdp +
                                                in_row),
                f);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = fmaf(w, f[e], acc[e]);
      }
    }
    m = m_new;
  }

  // the head's lanes of one chunk hold parts of its sums: add them up
  for (int o = lanes; o < (lanes << a.tg); o <<= 1) {
    l += __shfl_xor_sync(FULL, l, o);
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] += __shfl_xor_sync(FULL, acc[e], o);
  }
  const bool writer = lane_on && tl == 0;  // one lane a chunk
  const long long orow = (static_cast<long long>(s) * a.H + h0 + hl) * D;
  if (a.splits == 1) {
    if (writer) {
      const float den = fmaxf(l, 1e-20f);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (c * 16 + e < D) store(out + orow + c * 16 + e, acc[e] / den);
    }
    return;
  }

  // several splits: publish this split's state; the last CTA of the row
  // to arrive merges them all and sets the row's counter back to 0
  const int stride = G * (D + 2);
  float* part = a.work + (row * a.splits + split) * stride;
  if (writer) {
    if (c == 0) {
      part[hl] = m;
      part[G + hl] = l;
    }
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (c * 16 + e < D) part[2 * G + hl * D + c * 16 + e] = acc[e];
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // the CTA's partial, before its count
    sh_last = atomicAdd(a.counters + row, 1) == a.splits - 1;
    __threadfence();  // and the others' partials after theirs
  }
  __syncthreads();
  if (!sh_last) return;
  if (tid == 0) a.counters[row] = 0;

  // a warp a head: the splits' maxima and denominators lane-strided, then
  // the head's columns over every split
  const float* parts = a.work + row * a.splits * stride;
  float* sw = reinterpret_cast<float*>(ring);  // [G][splits] weights
  const int warp = tid >> 5;
  for (int hh = warp; hh < gv; hh += nthreads >> 5) {
    float mx = -CUDART_INF_F;
    for (int j = lane; j < a.splits; j += 32)
      mx = fmaxf(mx, __ldcg(parts + static_cast<long long>(j) * stride + hh));
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    float den = 0.f;
    for (int j = lane; j < a.splits; j += 32) {
      const float* pj = parts + static_cast<long long>(j) * stride;
      const float mj = __ldcg(pj + hh);
      const float wj = mj == -CUDART_INF_F ? 0.f : expf(mj - mx);
      sw[hh * a.splits + j] = wj;
      den += wj * __ldcg(pj + G + hh);
    }
    for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(FULL, den, o);
    den = fmaxf(den, 1e-20f);
    __syncwarp();
    const long long ohead = (static_cast<long long>(s) * a.H + h0 + hh) * D;
    for (int d = lane; d < D; d += 32) {
      float v = 0.f;
#pragma unroll 4
      for (int j = 0; j < a.splits; ++j) {
        const float x = __ldcg(parts + static_cast<long long>(j) * stride +
                               2 * G + hh * D + d);
        const float w = sw[hh * a.splits + j];
        v += w != 0.f ? w * x : 0.f;  // x is unwritten where w is 0
      }
      store(out + ohead + d, v / den);
    }
  }
}

// The derived launch shape of a split plan (heads a group G, tile tokens
// TT, splits, blocks a split); returns cudaErrorInvalidValue for a plan
// the kernel does not take.
int split_params(SplitParams& a, int S, int H, int D, int Bs, int MB,
                 int G, int TT, int splits, int bps, const void* k,
                 const void* v, size_t* smem) {
  a.H = H;
  a.D = D;
  a.Bs = Bs;
  a.MB = MB;
  a.tok = static_cast<long long>(H) * D;
  a.DP = (D + 15) / 16 * 16;
  a.G = G;
  a.TT = TT;
  a.splits = splits;
  a.bps = bps;
  int lg = 0;
  while ((16 << lg) < D) ++lg;        // lanes a token: ceil(D / 16), pow2
  a.lg = lg;
  a.tg = lg >= 1 ? 5 - lg : 4;        // tokens a warp: 32 / lanes, <= 16
  a.KT = (TT + (1 << a.tg) - 1) >> a.tg;
  a.threads = 32 * G;
  if (G < 1 || G > H || G * a.DP > GROUP_BYTES ||
      a.threads > SPLIT_WARPS * 32 || TT < 1 || TT > TILE_MAX || TT > Bs ||
      bps < 1 || splits < 1 || splits != (MB + bps - 1) / bps ||
      a.KT > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  a.HG = (H + G - 1) / G;
  a.TPB = (Bs + TT - 1) / TT;
  const auto ka = reinterpret_cast<uintptr_t>(k);
  const auto va = reinterpret_cast<uintptr_t>(v);
  a.vec = 16;
  while (a.vec >= 4 && (D % a.vec || ka % a.vec || va % a.vec)) a.vec >>= 1;
  if (a.vec < 4) a.vec = 1;
  a.kbytes = TT * G * a.DP;
  a.stage = 2 * a.kbytes + (2 * TT * 4 + 15) / 16 * 16;
  a.rows = static_cast<long long>(S) * a.HG;
  if (a.rows * splits > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t ring_b = static_cast<size_t>(SPLIT_STAGES) * a.stage;
  const size_t mrg_b = 4 * static_cast<size_t>(G) * splits;
  *smem = ring_b > mrg_b ? ring_b : mrg_b;
  if (*smem > static_cast<size_t>(SMEM_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename TQ>
int launch_split(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* table, const void* lengths,
                 void* out, int S, int H, int D, int Bs, int MB, int N,
                 float scale, int G, int TT, int splits, int bps, void* work,
                 void* counters, cudaStream_t stream) {
  SplitParams a{};
  size_t smem = 0;
  const int rc = split_params(a, S, H, D, Bs, MB, G, TT, splits, bps, k, v,
                              &smem);
  if (rc != 0) return rc;
  if (splits > 1 && (work == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.table = static_cast<const int*>(table);
  a.lengths = static_cast<const int*>(lengths);
  a.work = static_cast<float*>(work);
  a.counters = static_cast<int*>(counters);
  a.N = N;
  a.scale = scale;
  // above 48 KB of dynamic shared memory only after an opt-in to that
  // size, made once a device for the largest size launched so far
  auto kernel = a.KT <= 4 ? paged_attention_split_kernel<TQ, 4>
                          : paged_attention_split_kernel<TQ, 8>;
  static int opted[2][64] = {};  // one instantiation's opt-ins, by device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int* done = dev < 64 ? &opted[a.KT > 4][dev] : nullptr;
  if (smem > 48 * 1024 && (!done || *done < static_cast<int>(smem))) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (done) *done = static_cast<int>(smem);
  }
  kernel<<<static_cast<unsigned>(a.rows * splits),
           static_cast<unsigned>(a.threads), smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<TQ*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_wide(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* table, const void* lengths,
                void* out, int S, int H, int D, int Bs, int MB, int N,
                float scale, cudaStream_t stream) {
  const unsigned rows = static_cast<unsigned>(static_cast<long long>(S) * H);
  const int groups = (D + MAX_D - 1) / MAX_D;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  paged_attention_wide_kernel<TQ, TKV>
      <<<dim3(rows, groups), THREADS, 0, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(k),
          static_cast<const TKV*>(v), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(table),
          static_cast<const int*>(lengths), static_cast<TQ*>(out), H, D, Bs,
          MB, N, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* lengths, void* out, int S, int H, int D, int Bs,
           int MB, int N, float scale, cudaStream_t stream) {
  if (D > MAX_D)
    return launch_wide<TQ, TKV>(q, k, v, nullptr, nullptr, table, lengths,
                                out, S, H, D, Bs, MB, N, scale, stream);
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(S) * H));
  const auto* qq = static_cast<const TQ*>(q);
  const auto* kk = static_cast<const TKV*>(k);
  const auto* vv = static_cast<const TKV*>(v);
  const auto* tab = static_cast<const int*>(table);
  const auto* len = static_cast<const int*>(lengths);
  auto* o = static_cast<TQ*>(out);
  const int nper = (D + 31) / 32;
  if (nper <= 1)
    paged_attention_kernel<TQ, TKV, 1><<<grid, THREADS, 0, stream>>>(
        qq, kk, vv, nullptr, nullptr, tab, len, o, H, D, Bs, MB, N, scale);
  else if (nper <= 2)
    paged_attention_kernel<TQ, TKV, 2><<<grid, THREADS, 0, stream>>>(
        qq, kk, vv, nullptr, nullptr, tab, len, o, H, D, Bs, MB, N, scale);
  else if (nper <= 4)
    paged_attention_kernel<TQ, TKV, 4><<<grid, THREADS, 0, stream>>>(
        qq, kk, vv, nullptr, nullptr, tab, len, o, H, D, Bs, MB, N, scale);
  else
    paged_attention_kernel<TQ, TKV, 8><<<grid, THREADS, 0, stream>>>(
        qq, kk, vv, nullptr, nullptr, tab, len, o, H, D, Bs, MB, N, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_q(int kv_dtype, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* table,
             const void* lengths, void* out, int S, int H, int D, int Bs,
             int MB, int N, float scale, int G, int TT, int splits, int bps,
             void* work, void* counters, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<TQ, float>(q, k, v, table, lengths, out, S, H, D, Bs,
                               MB, N, scale, stream);
    case 1:
      return launch<TQ, __nv_bfloat16>(q, k, v, table, lengths, out, S, H,
                                       D, Bs, MB, N, scale, stream);
    default:
      if (D > MAX_D)
        return launch_wide<TQ, int8_t>(q, k, v, ks, vs, table, lengths, out,
                                       S, H, D, Bs, MB, N, scale, stream);
      return launch_split<TQ>(q, k, v, ks, vs, table, lengths, out, S, H, D,
                              Bs, MB, N, scale, G, TT, splits, bps, work,
                              counters, stream);
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (arenas only).  The int8 arm
// takes both scale planes; the float arms take neither.  The int8 arm at
// D <= 256 also takes its split plan (paged_kernels.split_plan): heads a
// group, tile tokens, splits, blocks a split, and with more than one
// split a float32 workspace of S * ceil(H / group) * splits * group *
// (D + 2) values and S * ceil(H / group) int32 counters that are zero (the
// kernel leaves them zero); the other arms ignore those arguments.
// Returns a cudaError_t (0 on success).
extern "C" int paged_attention_fwd(const void* q, int q_dtype, const void* k,
                                   const void* v, int kv_dtype,
                                   const void* k_scale, const void* v_scale,
                                   const void* table, const void* lengths,
                                   void* out, int S, int H, int D, int Bs,
                                   int MB, int N, float scale,
                                   int heads_per_group, int tile_tokens,
                                   int splits, int blocks_per_split,
                                   void* work, void* counters,
                                   void* stream) {
  if (S <= 0 || H <= 0 || D <= 0 || Bs <= 0 || MB <= 0 ||
      N <= 0 || q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 2 ||
      !q || !k || !v || !table || !lengths || !out ||
      (kv_dtype == 2) != (k_scale != nullptr) ||
      (kv_dtype == 2) != (v_scale != nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_q<float>(kv_dtype, q, k, v, k_scale, v_scale, table,
                           lengths, out, S, H, D, Bs, MB, N, scale,
                           heads_per_group, tile_tokens, splits,
                           blocks_per_split, work, counters, s);
  return launch_q<__nv_bfloat16>(kv_dtype, q, k, v, k_scale, v_scale, table,
                                 lengths, out, S, H, D, Bs, MB, N, scale,
                                 heads_per_group, tile_tokens, splits,
                                 blocks_per_split, work, counters, s);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
