// One recurrent time step of the LSTM (K8) and of the GRU's candidate and
// output (K9) for Hopper (sm_90a), plain C interface.
//
// Replaces two TPU kernels of paddle_tpu/ops/pallas_kernels.py, with the
// product and the length mask that surround each in the reference's scan
// body:
//   * K8 _lstm_cell_kernel (:1194), reached through _fused_lstm_cell_p ->
//     pl.pallas_call (:1245) from fused_lstm_cell (:1217), which the `lstm`
//     op's scan step runs once per time step (paddle_tpu/ops/rnn_ops.py:
//     63-93) between the product and the mask:
//
//       gates [B, 4D] = xg + h_prev @ W     (gc | gi | gf | go)
//       i, f, o = sigmoid(gi, gf, go)
//       c = f * c_prev + i * tanh(gc)          h = o * tanh(c)
//       with peepholes (the `lstm` op's default, use_peepholes): gi +=
//       c_prev * w_ic, gf += c_prev * w_fc before their sigmoids and go +=
//       c * w_oc before its own, the three weights [3, D] being the tail
//       of the op's Bias (rnn_ops.py:63-93's composed cell; the TPU
//       kernel leaves peepholes to that composed cell)
//       under the `lstm` op's other activations (gate_activation,
//       cell_activation, candidate_activation, each one of sigmoid,
//       tanh, relu, identity: rnn_ops.py:25-30's _ACT), the gates take
//       the gate activation, tanh(gc) the candidate's and tanh(c) the
//       cell's (the book's semantic-role labeller runs sigmoid gates, a
//       relu candidate and a sigmoid cell; the TPU kernel leaves every
//       set but the default to the composed cell)
//       valid = step < lens[b]: carries valid ? (h, c) : (h_prev, c_prev),
//       emits valid ? (h, c) : 0
//
//   * K9 _gru_cell_kernel (:1267), reached through _fused_gru_p ->
//     pl.pallas_call (:1310) from fused_gru_output (:1287), which the `gru`
//     op's scan step runs once per time step (rnn_ops.py:165-189):
//
//       ur_pre [B, 2D] = xg[:, :2D] + h_prev @ W_ur     (a library product)
//       u, r = sigmoid(ur_pre)
//       cand = xg[:, 2D:] + (r * h_prev) @ W_c          (this kernel on)
//       out = (1 - u) * h_prev + u * tanh(cand)  (origin_mode: u * h_prev +
//                                                 (1 - u) * tanh(cand))
//       then the mask as above: carries out or h_prev, emits out or 0
//
//     The second product needs every column of r, so it cannot share a
//     launch with the first without a grid-wide barrier: a GRU time step
//     is two launches, torch.addmm and this kernel.
//
// Each kernel also serves its cell alone (fused_lstm_cell, fused_gru_output):
// with a null W there is no product (the gate pre-activations are read as
// given) and with null lengths no mask.  fp32 in and out, as the TPU
// kernels compute in fp32.
//
// Design.  A CTA owns kRows = 16 batch rows (the mma.sync M; a grid axis
// walks the M tiles of B > 16, rows past B are zero-filled and not
// written) and a tile of hidden units: kLstmUnits units and their
// 4 * kLstmUnits columns of W, one slice of each gate block, so all four
// gates of a unit meet in the CTA with no exchange between CTAs (K9:
// kGruUnits units and their columns of W_c).  The product runs on the
// tensor cores as 3xTF32 m16n8k8 (split, mma2x3, load_a, load_bp of
// flash_attention_mma.cuh), which keeps fp32's accuracy as K1 and K2 do.
// Each k8 step's three products accumulate into fresh registers that are
// then added to the running sums rounded to nearest (__fadd_rn): the
// tensor cores' accumulation does not round to nearest, and one chain of
// it over K = 512 put the step 3.6-5.9 times as far from a float64 answer
// as cuBLAS's fp32 product (chip_smoke.py's scans on an NVIDIA H100 80GB
// HBM3 at 700 W); per step it is below.
// h_prev (K9: h_prev and the reset pre-activations) and the CTA's W panel
// are staged into shared memory by cp.async in chunks of kChunk rows of K,
// kStages chunks in flight: 16-byte copies where D, the row strides and
// the bases allow, else 4-byte ones (W is read where it lies, never
// padded).  K9's A operand sigmoid(r_pre) * h_prev is formed from the two
// staged tiles as each warp reads its fragment, rounded as the plain
// version's separate product rounds.  K is split across the CTA's kWarps
// warps (kStepsPerWarp k8 steps of each chunk each); their partial sums
// meet in shared memory once, and the epilogue adds xg (read in place, any
// row stride: x[:, step] of the [B, T, 4D] input), applies the cell
// operation for operation as the plain PyTorch version does (the accurate
// expf/tanhf, sigmoid(x) = 1 / (1 + expf(-x)) as PyTorch's CUDA sigmoid,
// every product and sum rounded on its own: __fmul_rn, __fadd_rn, no FMA
// contraction), then the mask.  The tile below was picked by measurement on
// the card among eight (PERF.md): 4 LSTM units (128 CTAs at D 512) and 16
// GRU units a CTA, 8 warps each taking one k8 step of a 64-row chunk,
// 3 chunks in flight.
//
// What bounds it.  At the seq2seq encoder's B 16, D 512 the LSTM step
// moves W (4 MB), the xg rows, h_prev, c_prev and its four outputs: 4.5 MB,
// 1.35 us at the H100 SXM's published 3.35 TB/s; its 33.6 MFLOP take 0.2 us
// at 3xTF32's third of the 495 TFLOP/s TF32 peak.  W stays in the 50 MB L2
// across the T steps of a scan.  The GRU step moves W_c (1 MB) and the
// rows: 0.37 us.  Measured (chip_smoke.py, "NVIDIA H100 80GB HBM3, 700.00
// W"): the LSTM step 0.0106 ms, against 0.0476 for the product, add, cell
// kernel and mask ops it replaces and 0.0174 for torch.addmm +
// _thnn_fused_lstm_cell; the GRU kernel 0.0134 ms (with its addmm 0.0256,
// against 0.0529).  A cell alone takes 0.0056-0.0058 ms: each launch is
// bound by its latency and the round trips of its 8 chunks of K to L2,
// not by bytes.  What the design buys is on the host: one call a time
// step where the scan made a dozen (0.06 against 0.19-0.29 ms of host
// time a step).  A persistent kernel over the whole scan would remove
// the per-step launch too.  The semantic-role labeller's step (B 10,
// D 128, peepholes, relu candidate, sigmoid cell) takes 0.0074 ms, the
// launch floor's 0.0051 and a chunk's round trip; the activation switch
// left the default step's time within 1% and its outputs bit for bit
// (k8_compare.py, same card).

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_mma.cuh"

namespace {

// The tile.
constexpr int kRows = 16;          // batch rows a CTA: the mma's M
constexpr int kWarps = 8;          // warps a CTA, splitting K
constexpr int kStepsPerWarp = 1;   // k8 steps a warp takes of each chunk
constexpr int kStages = 3;         // chunks of K in flight
constexpr int kLstmUnits = 4;      // hidden units a CTA, LSTM (16 columns)
constexpr int kGruUnits = 16;      // hidden units a CTA, GRU

constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 8 * kStepsPerWarp * kWarps;  // rows of K a chunk
constexpr int kLdA = kChunk + 8;                    // shared row of A

// Shared floats of the product: kStages chunks of A (twice for the GRU's
// h_prev and reset pre-activations) and W, reused for the warps' partial
// sums once the last chunk is consumed.
template <int NCOL, bool GRU>
__host__ __device__ constexpr int product_floats() {
  constexpr int stage = kRows * kLdA * (GRU ? 2 : 1) + kChunk * (NCOL + 8);
  constexpr int partial = kWarps * kRows * (NCOL + 8);
  return stage * kStages > partial ? stage * kStages : partial;
}

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// The lstm op's activations, by the code the C entry takes (2 bits each of
// its `acts`: gate | cell << 2 | candidate << 4), each as PyTorch computes
// it: sigmoid as torch.sigmoid, tanhf, relu as torch.relu (NaN passes),
// identity.  The codes are kernel arguments, the same in every thread, so
// each switch is a uniform branch: one code path a launch, read where the
// epilogue needs it.  Templates over the 64 sets would multiply the
// instantiations (and the SASS to check) for an epilogue of a few dozen
// instructions beside the product's latency.
enum Act { kSigmoid = 0, kTanh = 1, kRelu = 2, kIdentity = 3 };

__device__ __forceinline__ float activation(int code, float x) {
  switch (code) {
    case kSigmoid:
      return sigmoid_rn(x);
    case kTanh:
      return tanhf(x);
    case kRelu:
      return x < 0.0f ? 0.0f : x;
    default:
      return x;
  }
}

// Rows [m0, m0 + kRows) and columns [k0, k0 + kChunk) of a row-major
// [B, D] matrix (row stride ld) into the shared tile A [kRows][kLdA]; rows
// past B and columns past D as zeros.  V16: 16-byte copies (D, ld and the
// base 16-byte aligned), else 4-byte ones.
template <bool V16>
__device__ __forceinline__ void stage_a(float* A,
                                        const float* __restrict__ src,
                                        long long ld, int m0, int B, int k0,
                                        int D) {
  constexpr int PER = V16 ? 4 : 1;
  constexpr int CPR = kChunk / PER;
#pragma unroll
  for (int i = threadIdx.x; i < kRows * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * PER;
    const bool in = (m0 + r < B) & (k0 + c < D);
    const float* s = src + (in ? (m0 + r) * ld + k0 + c : 0);
    float* d = A + flash::at<float, kLdA>(r, c);
    if (V16)
      flash::cp16(d, s, in);
    else
      flash::cp4(d, s, in);
  }
}

// Rows [k0, k0 + kChunk) of W (row stride ld) restricted to the CTA's
// units [n0, n0 + UNITS) of each of NG gate blocks (columns q * D + n0 +
// u) into the shared tile [kChunk][NG * UNITS + 8], gate q at columns
// q * UNITS..; rows and units past D as zeros.
template <int UNITS, int NG, bool V16>
__device__ __forceinline__ void stage_w(float* Bs,
                                        const float* __restrict__ W,
                                        long long ld, int k0, int D,
                                        int n0) {
  constexpr int NCOL = NG * UNITS, LDB = NCOL + 8;
  constexpr int PER = V16 ? 4 : 1;
  constexpr int CPR = NCOL / PER;
#pragma unroll
  for (int i = threadIdx.x; i < kChunk * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * PER;
    const int q = c / UNITS, u = c % UNITS;
    const bool in = (k0 + r < D) & (n0 + u < D);
    const float* s = W + (in ? (k0 + r) * ld + q * D + n0 + u : 0);
    float* d = Bs + flash::at<float, LDB>(r, c);
    if (V16)
      flash::cp16(d, s, in);
    else
      flash::cp4(d, s, in);
  }
}

// The CTA's [kRows, NG * UNITS] block of A @ W, A = h_prev (LSTM) or
// sigmoid(r_pre) * h_prev (GRU), over all D rows of K; on return (after a
// barrier) the kWarps partial sums lie in smem as [kWarps][kRows][NCOL + 8]
// and the caller adds them in warp order.
template <int UNITS, int NG, bool GRU, bool V16>
__device__ __forceinline__ void product(float* smem,
                                        const float* __restrict__ h,
                                        long long ld_h,
                                        const float* __restrict__ r_pre,
                                        long long ld_r,
                                        const float* __restrict__ W,
                                        long long ld_w, int B, int D, int m0,
                                        int n0) {
  constexpr int NCOL = NG * UNITS, NT = NCOL / 8, LDB = NCOL + 8;
  static_assert(NT % 2 == 0, "the products run two n8 tiles at a time");
  constexpr int A_FLOATS = kRows * kLdA;
  constexpr int W_AT = A_FLOATS * (GRU ? 2 : 1);
  constexpr int STAGE = W_AT + kChunk * LDB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (D + kChunk - 1) / kChunk;

  auto fetch = [&](int kc) {
    float* st = smem + (kc % kStages) * STAGE;
    const int k0 = kc * kChunk;
    stage_a<V16>(st, h, ld_h, m0, B, k0, D);
    if constexpr (GRU)
      stage_a<V16>(st + A_FLOATS, r_pre, ld_r, m0, B, k0, D);
    stage_w<UNITS, NG, V16>(st + W_AT, W, ld_w, k0, D, n0);
  };

  float acc[NT][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) fetch(s);
    flash::cp_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    flash::cp_wait<kStages - 2>();
    __syncthreads();  // chunk kc landed; chunk kc - 1's slot is free
    if (kc + kStages - 1 < nk) fetch(kc + kStages - 1);
    flash::cp_commit();
    const float* As = smem + (kc % kStages) * STAGE;
    const float* Bs = As + W_AT;
#pragma unroll
    for (int s = 0; s < kStepsPerWarp; ++s) {
      const int k0 = (warp * kStepsPerWarp + s) * 8;
      float a[4];
      flash::load_a<kLdA>(a, As, 0, k0, g, t);
      if constexpr (GRU) {
        float rp[4];
        flash::load_a<kLdA>(rp, As + A_FLOATS, 0, k0, g, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = __fmul_rn(sigmoid_rn(rp[i]), a[i]);
      }
      uint32_t ah[4], al[4];
      flash::split<true>(a, ah, al);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        float b0[2], b1[2];
        flash::load_bp<LDB>(b0, Bs, k0, j * 8, g, t);
        flash::load_bp<LDB>(b1, Bs, k0, (j + 1) * 8, g, t);
        uint32_t bh0[2], bl0[2], bh1[2], bl1[2];
        flash::split<true>(b0, bh0, bl0);
        flash::split<true>(b1, bh1, bl1);
        float s0[4] = {}, s1[4] = {};
        flash::mma2x3<true, true>(s0, ah, al, bh0, bl0, s1, ah, al, bh1,
                                  bl1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[j][i] = __fadd_rn(acc[j][i], s0[i]);
          acc[j + 1][i] = __fadd_rn(acc[j + 1][i], s1[i]);
        }
      }
    }
  }
  flash::cp_wait<0>();
  __syncthreads();  // every warp is done with the chunks: reuse as partials
  float* part = smem + warp * kRows * LDB;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    flash::store2(part + g * LDB + j * 8 + 2 * t, acc[j][0], acc[j][1]);
    flash::store2(part + (g + 8) * LDB + j * 8 + 2 * t, acc[j][2],
                  acc[j][3]);
  }
  __syncthreads();
}

// Column `col` of row r of the product: the warps' partial sums in order.
template <int NCOL>
__device__ __forceinline__ float partial_sum(const float* smem, int r,
                                             int col) {
  float s = smem[r * (NCOL + 8) + col];
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    s = __fadd_rn(s, smem[(w * kRows + r) * (NCOL + 8) + col]);
  return s;
}

template <bool V16>
__global__ void __launch_bounds__(kThreads)
    lstm_step_kernel(const float* __restrict__ xg, long long ld_x,
                     const float* __restrict__ h_prev, long long ld_h,
                     const float* __restrict__ c_prev, long long ld_c,
                     const float* __restrict__ W, long long ld_w,
                     const float* __restrict__ peep,
                     const int* __restrict__ lens, int step,
                     float* __restrict__ h_out, float* __restrict__ c_out,
                     float* __restrict__ h_emit, float* __restrict__ c_emit,
                     int B, int D, int acts) {
  constexpr int U = kLstmUnits, NCOL = 4 * U;
  const int act_gate = acts & 3, act_cell = (acts >> 2) & 3,
            act_cand = (acts >> 4) & 3;
  __shared__ __align__(16) float smem[product_floats<NCOL, false>()];
  const int n0 = blockIdx.x * U, m0 = blockIdx.y * kRows;
  if (W)
    product<U, 4, false, V16>(smem, h_prev, ld_h, nullptr, 0, W, ld_w, B, D,
                              m0, n0);
  for (int i = threadIdx.x; i < kRows * U; i += kThreads) {
    const int r = i / U, u = i % U, row = m0 + r, unit = n0 + u;
    if (row >= B || unit >= D) continue;
    const float* x = xg + row * ld_x + unit;
    float gate[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      gate[q] = __ldg(x + q * D);
      if (W)
        gate[q] = __fadd_rn(gate[q], partial_sum<NCOL>(smem, r, q * U + u));
    }
    const float cp = __ldg(c_prev + row * ld_c + unit);
    if (peep) {
      gate[1] = __fadd_rn(gate[1], __fmul_rn(cp, __ldg(peep + unit)));
      gate[2] = __fadd_rn(gate[2], __fmul_rn(cp, __ldg(peep + D + unit)));
    }
    const float ig = activation(act_gate, gate[1]);
    const float fg = activation(act_gate, gate[2]);
    const float c = __fadd_rn(__fmul_rn(fg, cp),
                              __fmul_rn(ig, activation(act_cand, gate[0])));
    if (peep)
      gate[3] = __fadd_rn(gate[3], __fmul_rn(c, __ldg(peep + 2 * D + unit)));
    const float og = activation(act_gate, gate[3]);
    const float h = __fmul_rn(og, activation(act_cell, c));
    const bool valid = lens == nullptr || step < __ldg(lens + row);
    const long long o = (long long)row * D + unit;
    float hc = h, cc = c;
    if (!valid) {
      hc = __ldg(h_prev + row * ld_h + unit);
      cc = cp;
    }
    h_out[o] = hc;
    c_out[o] = cc;
    if (h_emit) {
      h_emit[o] = valid ? h : 0.0f;
      c_emit[o] = valid ? c : 0.0f;
    }
  }
}

template <bool V16>
__global__ void __launch_bounds__(kThreads)
    gru_step_kernel(const float* __restrict__ ur, long long ld_u,
                    const float* __restrict__ xc, long long ld_xc,
                    const float* __restrict__ h_prev, long long ld_h,
                    const float* __restrict__ Wc, long long ld_w,
                    const int* __restrict__ lens, int step,
                    float* __restrict__ h_out, float* __restrict__ h_emit,
                    int B, int D, int origin_mode) {
  constexpr int U = kGruUnits;
  __shared__ __align__(16) float smem[product_floats<U, true>()];
  const int n0 = blockIdx.x * U, m0 = blockIdx.y * kRows;
  if (Wc)
    product<U, 1, true, V16>(smem, h_prev, ld_h, ur + D, ld_u, Wc, ld_w, B,
                             D, m0, n0);
  for (int i = threadIdx.x; i < kRows * U; i += kThreads) {
    const int r = i / U, u = i % U, row = m0 + r, unit = n0 + u;
    if (row >= B || unit >= D) continue;
    const float ug = sigmoid_rn(__ldg(ur + row * ld_u + unit));
    float gc = __ldg(xc + row * ld_xc + unit);
    if (Wc) gc = __fadd_rn(gc, partial_sum<U>(smem, r, u));
    const float c = tanhf(gc);
    const float h = __ldg(h_prev + row * ld_h + unit);
    const float v = __fsub_rn(1.0f, ug);
    const float out = origin_mode
                          ? __fadd_rn(__fmul_rn(ug, h), __fmul_rn(v, c))
                          : __fadd_rn(__fmul_rn(v, h), __fmul_rn(ug, c));
    const bool valid = lens == nullptr || step < __ldg(lens + row);
    const long long o = (long long)row * D + unit;
    h_out[o] = valid ? out : h;
    if (h_emit) h_emit[o] = valid ? out : 0.0f;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int grid_for(int B, int D, int units, dim3* grid) {
  if (B <= 0 || D <= 0) return cudaErrorInvalidValue;
  const long long gx = (D + units - 1) / units;
  const long long gy = (B + kRows - 1) / kRows;
  if (gy > 65535) return cudaErrorInvalidValue;
  *grid = dim3((unsigned)gx, (unsigned)gy);
  return cudaSuccess;
}

}  // namespace

// One LSTM time step.  xg fp32 [B, 4D] (row stride ld_x, unit stride along
// the row), h_prev and c_prev fp32 [B, D] (row strides ld_h, ld_c), W fp32
// [D, 4D] (row stride ld_w), peep fp32 [3, D] dense (w_ic | w_fc | w_oc),
// lens int32 [B]; h, c (the carries) and h_emit, c_emit fp32 [B, D] dense.
// peep null: no peepholes.  W null: no product (xg holds the gates);
// lens null: no mask, and h_prev may be null when W is too; h_emit null:
// the emitted pair is not written.  acts: the activations' codes (Act),
// gate | cell << 2 | candidate << 4; the default set is 0 | 1 << 2 |
// 1 << 4.  Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int lstm_step_fwd(const void* xg, long long ld_x,
                             const void* h_prev, long long ld_h,
                             const void* c_prev, long long ld_c,
                             const void* W, long long ld_w,
                             const void* peep, const void* lens,
                             int step, void* h, void* c, void* h_emit,
                             void* c_emit, int B, int D, int acts,
                             void* stream) {
  dim3 grid;
  const int err = grid_for(B, D, kLstmUnits, &grid);
  if (err != cudaSuccess) return err;
  if (!xg || !c_prev || !h || !c || (!h_prev && (W || lens)) ||
      (!h_emit != !c_emit) || (acts & ~63))
    return cudaErrorInvalidValue;
  const bool v16 = W && D % 4 == 0 && ld_h % 4 == 0 && ld_w % 4 == 0 &&
                   aligned16(h_prev) && aligned16(W);
  auto kernel = v16 ? lstm_step_kernel<true> : lstm_step_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xg), ld_x, static_cast<const float*>(h_prev),
      ld_h, static_cast<const float*>(c_prev), ld_c,
      static_cast<const float*>(W), ld_w, static_cast<const float*>(peep),
      static_cast<const int*>(lens), step, static_cast<float*>(h),
      static_cast<float*>(c),
      static_cast<float*>(h_emit), static_cast<float*>(c_emit), B, D, acts);
  return cudaGetLastError();
}

// The GRU step after its first product.  ur fp32 [B, 2D] (row stride ld_u:
// update | reset pre-activations; only [:, :D] is read when W_c is null),
// xc fp32 [B, D] (the candidate's input part, row stride ld_xc), h_prev
// fp32 [B, D] (ld_h), W_c fp32 [D, D] (row stride ld_w), lens int32 [B];
// h (the carry) and h_emit fp32 [B, D] dense.  W_c null: no product (xc
// holds the candidate pre-activations); lens null: no mask; h_emit null:
// not written.
extern "C" int gru_step_fwd(const void* ur, long long ld_u, const void* xc,
                            long long ld_xc, const void* h_prev,
                            long long ld_h, const void* Wc, long long ld_w,
                            const void* lens, int step, void* h,
                            void* h_emit, int B, int D, int origin_mode,
                            void* stream) {
  dim3 grid;
  const int err = grid_for(B, D, kGruUnits, &grid);
  if (err != cudaSuccess) return err;
  if (!ur || !xc || !h_prev || !h) return cudaErrorInvalidValue;
  const bool v16 = Wc && D % 4 == 0 && ld_u % 4 == 0 && ld_h % 4 == 0 &&
                   ld_w % 4 == 0 && aligned16(ur) && aligned16(h_prev) &&
                   aligned16(Wc);
  auto kernel = v16 ? gru_step_kernel<true> : gru_step_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ur), ld_u, static_cast<const float*>(xc),
      ld_xc, static_cast<const float*>(h_prev), ld_h,
      static_cast<const float*>(Wc), ld_w, static_cast<const int*>(lens),
      step, static_cast<float*>(h), static_cast<float*>(h_emit), B, D,
      origin_mode);
  return cudaGetLastError();
}

extern "C" const char* rnn_cells_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
