// LSTM cell (K8) and GRU final-output gate (K9) for Hopper (sm_90a), plain
// C interface.
//
// Replaces two TPU kernels of paddle_tpu/ops/pallas_kernels.py:
//   * K8 _lstm_cell_kernel (:1194), reached through _fused_lstm_cell_p ->
//     pl.pallas_call (:1245) from fused_lstm_cell (:1217), which the `lstm`
//     op runs once per time step (paddle_tpu/ops/rnn_ops.py:67-71):
//
//       gates [B, 4D] = (gc | gi | gf | go) pre-activations, c_prev [B, D]
//       i, f, o = sigmoid(gi, gf, go)
//       c = f * c_prev + i * tanh(gc)          h = o * tanh(c)
//
//   * K9 _gru_cell_kernel (:1267), reached through _fused_gru_p ->
//     pl.pallas_call (:1310) from fused_gru_output (:1287), which the `gru`
//     op runs once per time step (rnn_ops.py:168-178):
//
//       u = sigmoid(gu), c = tanh(gc)
//       out = (1 - u) * h_prev + u * c         (origin_mode: u * h_prev +
//                                                (1 - u) * c)
//
// Both are fp32 in and out, as the TPU kernels compute in fp32.
//
// Design.  One thread per (row, d) output element, 256 threads a CTA, the
// flattened index walking d fastest: the warp's 32 threads read 32
// consecutive floats of each gate slice (four coalesced 128-byte reads for
// K8's gates, two for K9's) and write 32 consecutive floats of each output.
// The TPU kernels tiled [bb, bd] blocks of a (B / bb, D / bd) grid and
// served only D % 128 == 0 (pallas_kernels.py:1229, :1293), composing in
// XLA otherwise; here every B and D runs, the ragged tail masked by the
// index bound.  Each input carries its own row stride (in floats), so K9
// reads gu straight out of the [B, 2D] (u | r) pre-activation buffer of the
// gru step without a copy.
//
// The arithmetic follows the plain PyTorch version operation for
// operation: the accurate expf/tanhf (no fast-math intrinsics),
// sigmoid(x) = 1 / (1 + expf(-x)) as PyTorch's CUDA sigmoid, and every
// product and sum rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn), as
// the plain version's separate tensor ops round, with no FMA contraction.
//
// What bounds it.  K8 reads 5 floats and writes 2 per element (28 B): at
// the seq2seq encoder's B = 16, D = 512 that is 229 KB, 0.07 us at the
// H100 SXM's published 3.35 TB/s, and about 15 flops an element.
// chip_smoke.py measures about 0.0056 ms a call for K8 and K9 ("NVIDIA
// H100 80GB HBM3, 700.00 W"): launch latency.  Only fusing the cell into
// the step's matmul, or a persistent kernel over the whole scan, would
// change that (later work).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__global__ void __launch_bounds__(THREADS)
    lstm_cell_kernel(const float* __restrict__ gates, long long ld_gates,
                     const float* __restrict__ c_prev, long long ld_c,
                     float* __restrict__ h_out, float* __restrict__ c_out,
                     int B, int D) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * D) return;
  const long long row = idx / D;
  const int d = (int)(idx - row * D);
  const float* g = gates + row * ld_gates;
  const float gc = __ldg(g + d);
  const float gi = __ldg(g + D + d);
  const float gf = __ldg(g + 2 * D + d);
  const float go = __ldg(g + 3 * D + d);
  const float cp = __ldg(c_prev + row * ld_c + d);
  const float i = sigmoid_rn(gi);
  const float f = sigmoid_rn(gf);
  const float o = sigmoid_rn(go);
  const float c = __fadd_rn(__fmul_rn(f, cp), __fmul_rn(i, tanhf(gc)));
  c_out[idx] = c;
  h_out[idx] = __fmul_rn(o, tanhf(c));
}

__global__ void __launch_bounds__(THREADS)
    gru_output_kernel(const float* __restrict__ gu, long long ld_u,
                      const float* __restrict__ gc, long long ld_c,
                      const float* __restrict__ h_prev, long long ld_h,
                      float* __restrict__ out, int B, int D,
                      int origin_mode) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * D) return;
  const long long row = idx / D;
  const int d = (int)(idx - row * D);
  const float u = sigmoid_rn(__ldg(gu + row * ld_u + d));
  const float c = tanhf(__ldg(gc + row * ld_c + d));
  const float h = __ldg(h_prev + row * ld_h + d);
  const float v = __fsub_rn(1.0f, u);
  out[idx] = origin_mode ? __fadd_rn(__fmul_rn(u, h), __fmul_rn(v, c))
                         : __fadd_rn(__fmul_rn(v, h), __fmul_rn(u, c));
}

int blocks_for(int B, int D, unsigned* grid) {
  if (B <= 0 || D <= 0) return cudaErrorInvalidValue;
  const long long n = (long long)B * D;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  *grid = (unsigned)blocks;
  return cudaSuccess;
}

}  // namespace

// gates fp32 [B, 4D] (row stride ld_gates floats, unit stride along the
// row), c_prev fp32 [B, D] (row stride ld_c); h and c fp32 [B, D] dense.
// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int lstm_cell_fwd(const void* gates, long long ld_gates,
                             const void* c_prev, long long ld_c, void* h,
                             void* c, int B, int D, void* stream) {
  unsigned grid = 0;
  const int err = blocks_for(B, D, &grid);
  if (err != cudaSuccess) return err;
  lstm_cell_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gates), ld_gates,
      static_cast<const float*>(c_prev), ld_c, static_cast<float*>(h),
      static_cast<float*>(c), B, D);
  return cudaGetLastError();
}

// gu, gc, h_prev fp32 [B, D] with row strides ld_u, ld_c, ld_h (unit
// stride along the row); out fp32 [B, D] dense.
extern "C" int gru_output_fwd(const void* gu, long long ld_u, const void* gc,
                              long long ld_c, const void* h_prev,
                              long long ld_h, void* out, int B, int D,
                              int origin_mode, void* stream) {
  unsigned grid = 0;
  const int err = blocks_for(B, D, &grid);
  if (err != cudaSuccess) return err;
  gru_output_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gu), ld_u, static_cast<const float*>(gc),
      ld_c, static_cast<const float*>(h_prev), ld_h,
      static_cast<float*>(out), B, D, origin_mode);
  return cudaGetLastError();
}

extern "C" const char* rnn_cells_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
