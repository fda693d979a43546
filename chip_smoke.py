#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which fails the run (non-zero exit, no result line):

1. device: print the card's name and power limit (nvidia-smi); turn TF32
   off for float32 matrix products and convolutions.
2. build: compile every CUDA kernel of the port from the sources under
   paddle_tpu_torch/csrc (one nvcc each, all started together).
3. kernel vs plain: run each kernel's wrapper on the card at the shapes
   of the serving path and its edge cases, hold it against its plain
   PyTorch version on the same tensors, and time the kernel, the plain
   version and the PyTorch library call that computes the same function
   (a yardstick only; the port never calls it) with CUDA events.
4. training kernels vs plain: the same for the training arms at the
   BERT-base training shape (B=32, H=12, T=128, D=64) and edge cases:
   K1 with its lse and dropout, K2a (dK, dV) and K2b (dQ, dBias), with
   dropout on and off, against the plain forward and the plain
   FlashAttention-2 backward on the same tensors (the same Philox mask);
   the dropout keep rate and the bits' determinism per seed.
5. int8 kernel vs plain: K6 (quant_matmul) at the int8 serving path's
   shapes (M = 1024 with (K, N) in {(768, 768), (768, 3072), (3072,
   768)}, ragged M, the pooler's M = 8, the logits head's N = 2, and a
   shape ragged in M, K and N) against its plain version, which must
   agree bit for bit; kernel, plain and torch._int_mm + scale times.
6. serving: build BERT-base (12 layers, hidden 768, 12 heads, seq 128,
   random weights from a seed) with the port's fluid API, save it as an
   inference model, serve 32 single-row requests through
   create_paddle_predictor -> ServingEngine on the card, check that the
   flash-attention kernel ran 12 times per executed batch, and hold the
   served probabilities against a CPU Predictor on the same model dir.
7. quantized serving: the same model dir and requests through
   AnalysisConfig.enable_quantize() -> ServingEngine: K6 launched once
   per __quant__ op per executed batch (and K1 12 times), one executed
   batch run again with K6's plain version swapped in (equal answers),
   the engine's padded batches re-run on a CPU quantized Predictor (the
   int8 codes that differ counted), the answers within 0.05 of the fp32
   phase's, latency and throughput beside the fp32 phase's, and a
   profile of one quantized batch.
8. training parity: BERT-base width with 2 layers, batch 8, seq 128,
   Adam, from one startup state, 3 steps on the card against 3 steps on
   the CPU, with dropout 0 and with dropout 0.1 (the same Philox masks
   on both devices).
9. training: BERT-base pretraining (12 layers, dropout 0.1, batch 32,
   seq 128, 20 masked positions per sequence, Adam 1e-4, random weights
   from a seed) for 6 steps on the card through Executor.run: finite
   losses with the last below the first, the kernels' launch counts per
   step, step time, tokens/s, peak memory, and a profile of one step.
10. RNN and sequence kernels vs plain: K8 (lstm_cell) at the seq2seq
   encoder's B = 16, D = 512 and at edge shapes, K9 (gru_output) at
   (16, 512) in both modes on the gru op's strided input and at an edge
   shape, K7 (masked_softmax) at [16, 128], at ragged lengths with an
   empty row and at T = 1000: outputs and the backward's grads against
   the plain versions (atol 1e-5), kernel, plain and library times
   (_thnn_fused_lstm_cell, _thnn_fused_gru_cell, _masked_softmax).
11. seq2seq parity: the book's seq2seq model (bi-LSTM encoder, DynamicRNN
   decoder) at dictionary 1000, width 128, batch 8, 3 Adam steps on the
   card against 3 on the CPU from one state.
12. seq2seq training: the same model at the width of Paddle's
   machine-translation benchmark (dictionary 30000, embedding, encoder
   and decoder 512), batch 16, lengths 10-50, Adam 1e-3, 6 steps: finite
   falling losses, K8's launches per step, step time, target tokens/s,
   peak memory and a profile of one step.
13. GRU and sequence-softmax programs: embedding -> fc -> dynamic_gru(512)
   in both modes, and fc(1) -> sequence_softmax at T = 128 and at ragged
   lengths, 3 SGD steps on one batch on the card against the CPU, each
   update moving the loss, with K9 and K7 launched.
14. row gather kernel vs plain: K11 (gather_rows) against index_select,
   bit for bit, at one CTR step's deep and wide lookups on one shard
   (65,536 padded ids from a 500,000-row block, D = 16 and D = 1), at
   D = 129, a bf16 table, N = 1 and a 68-byte row stride, and ids outside
   the table (zero rows); kernel, plain and index_select times at the
   deep and wide shapes.
15. CTR parity: bench.py's CTR model (vocab 1,000,000, dim 16, 26 slots,
   400-400-400, SGD 1e-3, batch 4096) over 2 shard servers (shard 0
   colocated, shard 1 over RPC on 127.0.0.1), 3 steps on the card against
   3 on the CPU from one state, K11 launched 4 times a step on the card.
16. CTR training: the same, 6 steps on the card through
   declare_sharded_table -> SparseShardServer(device_table=True) ->
   shard_program -> Executor(CUDAPlace(0)): finite losses, K11 launched
   exactly 4 times a step, every shard's device mirror equal to its host
   block after the run, step time, examples/s, ids/s, the dedup ratio
   and padding waste, and a profile of one step.
17. report: a "kernels" JSON line, then the result line
   {"ok": true, "device": {...}} last.

Exits non-zero when no CUDA device is visible, and when the port's
package is not beside this script.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 1234
# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
# fp32: the kernel and the plain version sum exps in another order; bf16:
# the plain version rounds its output to bf16 from a different fp32 value
ATOL = {"float32": 2e-4, "bfloat16": 2e-2}
# training arms against the plain versions on the same tensors: fp32 out
# and lse as above; fp32 grads at the JAX package's own bar for its
# backward kernels (tests/test_pallas_kernels.py:92), since dS sums
# products over a row and the kernels sum in another order; bf16 outputs
# round to bf16 from fp32 values that differ in the last bits; the row
# dBias is summed by fp32 atomics, in another order on every run
TRAIN_ATOL = {"out": {"float32": 2e-4, "bfloat16": 5e-2}, "lse": 2e-4,
              "grad": {"float32": 2e-3, "bfloat16": 5e-2}, "dbias": 2e-3}
# keep rate of p=0.1 over the B*H*T*T draws of the BERT training shape
# (6.3 M draws: one standard deviation is 1.2e-4)
KEEP_RATE_TOL = 0.002
# training losses, card against CPU from one state: cuBLAS and the CPU sum
# in other orders; Adam's normalised steps carry the difference on
PARITY_RTOL = {1: 1e-4, 3: 1e-3}
# served probabilities against the CPU Predictor: cuBLAS vs CPU matmul
# summation order through 12 fp32 layers
SERVE_ATOL = 1e-4
# quantized, card against CPU: K6 equals its plain version bit for bit,
# but the fp32 ops between the matmuls (attention, layer norm, gelu) sum
# in other orders on the two devices, so some int8 activation codes round
# the other way on each side; a flipped code moves a matmul output by one
# activation step (amax/127 of the whole batch), and the flips compound
# through 12 layers (chip_smoke counts them).  Each side is within the
# JAX package's quantization bar of fp32, so that bar bounds their
# difference too.
SERVE_QUANT_ATOL = 0.05
# quantized answers against the fp32 ones: the JAX package's bar
# (tests/test_quantize_pass.py:319)
QUANT_FP32_BAR = 0.05
# K6 at the int8 serving path's shapes: (name, M, K, N); serving batches
# are rows * 128 tokens with rows bucketed to 1-8, the pooler runs at
# M = rows and the logits head at N = 2
QUANT_CASES = [("qkv_out_m1024", 1024, 768, 768),
               ("ffn1_m1024", 1024, 768, 3072),
               ("ffn2_m1024", 1024, 3072, 768),
               ("ragged_m1000_ffn1", 1000, 768, 3072),
               ("pooler_m8", 8, 768, 768),
               ("logits_m8_n2", 8, 768, 2),
               ("ragged_mkn", 333, 1001, 999)]
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_heads=12,
                 intermediate_size=3072, max_position=512,
                 type_vocab_size=2)
# BERT pretraining at seq 128: 20 masked positions per sequence
# (max_predictions_per_seq of the published pretraining data)
TRAIN_B, TRAIN_T, TRAIN_M, TRAIN_STEPS = 32, 128, 20, 6
# the RNN slice: the book's seq2seq model at the width of Paddle's
# machine-translation benchmark (benchmark/fluid/models/
# machine_translation.py, Fluid 1.x: embedding 512, encoder and decoder
# 512, dictionary 30000), batch 16, source and target lengths 10-50; its
# card-vs-CPU parity at a reduced width
S2S_FULL = dict(dict_size=30000, emb=512, hidden=512)
S2S_PARITY = dict(dict_size=1000, emb=128, hidden=128)
S2S_B, S2S_LENS, S2S_STEPS = 16, (10, 50), 6
# the GRU program's loss, the mean of h·h, is ~5e-6 at its random init,
# and so are its gradients: at SGD 0.5 its updates move it by ~7e-5
# relative over two steps, under the parity bound; at 200 by ~1e-2.  A
# repeated batch must move by MIN_MOVE (5x the step-3 bound) after each
# update, so a run that skipped them could not pass the card-vs-CPU check
GRU_LR = 200.0
MIN_MOVE = 5 * PARITY_RTOL[3]
# K7, K8, K9 against their plain versions on the same tensors, outputs
# and grads: the kernels take the plain version's operations in its
# order, with the accurate expf/tanhf
RNN_ATOL = 1e-5
KERNELS = {
    "fwd": {"name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels.py:74"},
    "dkv": {"name": "flash_attention_bwd_dkv", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels.py:558"},
    "dq": {"name": "flash_attention_bwd_dq", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
           "replaces": "paddle_tpu/ops/pallas_kernels.py:625"},
    "quant": {"name": "quant_matmul", "route": "cuda",
              "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
              "replaces": "paddle_tpu/ops/quant_kernels.py:64"},
    "lstm": {"name": "lstm_cell", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/rnn_cells.cu",
             "replaces": "paddle_tpu/ops/pallas_kernels.py:1194"},
    "gru": {"name": "gru_output", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/rnn_cells.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels.py:1267"},
    "softmax": {"name": "masked_softmax", "route": "cuda",
                "source": "paddle_tpu_torch/csrc/masked_softmax.cu",
                "replaces": "paddle_tpu/ops/pallas_kernels.py:1340"},
    "gather": {"name": "gather_rows", "route": "cuda",
               "source": "paddle_tpu_torch/csrc/gather_rows.cu",
               "replaces": "paddle_tpu/sparse/gather.py:54"},
}
# the CTR slice: bench.py's CTR configuration (bench.py:268-316, Paddle's
# CTR DNN on Criteo): 26 categorical slots through one shared deep table
# of 1,000,000 x 16 and a wide table of width 1, 13 dense features, a
# 400-400-400 MLP, SGD 1e-3, batch 4096, ids uniform over the vocabulary;
# both tables row-sharded over 2 shard servers (shard 0 colocated, shard 1
# over RPC on 127.0.0.1), each gathering through K11 on the card
CTR_B, CTR_SHARDS, CTR_STEPS, CTR_PARITY_STEPS = 4096, 2, 6, 3


def phase(name):
    print(f"== {name}", flush=True)


def device_phase(torch):
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 off for float32 matmul and cudnn")
    return smi


def build_phase():
    from paddle_tpu_torch.ops import cuda_build

    phase("build")
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.3f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def time_ms(torch, fn, reps=50):
    """Median of `reps` CUDA-event timings of fn() after a warm-up.  A
    spin kernel keeps the card busy while the host enqueues every call,
    so each event pair brackets device time, not Python launch time; the
    spin lasts at least twice the measured enqueue time of all the calls
    (at a 2 GHz clock, more than the card's)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(max(1e8, 2e9 * 2 * reps * enqueue_s)))
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def attention_cases(torch):
    """(name, q, k, v, bias, causal) on the card, made from SEED."""
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def qkv(b, h, t, d, dtype):
        return [torch.randn(b, h, t, d, generator=g, device="cuda")
                .to(dtype) for _ in range(3)]

    def row_bias(b, t):
        lens = torch.randint(t // 4, t + 1, (b,), generator=g,
                             device="cuda")
        pad = torch.arange(t, device="cuda")[None, :] >= lens[:, None]
        return (pad.float() * -10000.0).reshape(b, 1, 1, t)

    def q_only(b, h, t, d, dtype):
        return torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype)

    def masked_row_bias():
        """A full bias whose row (0, 0, 5) is -inf everywhere: the TPU
        kernel's isfinite and max(l, 1e-20) guards make that row 0."""
        bias = torch.randn(8, 12, 128, 128, generator=g, device="cuda")
        bias[0, 0, 5, :] = float("-inf")
        return bias

    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("bert_row_f32", *qkv(8, 12, 128, 64, f32), row_bias(8, 128), False),
        ("bert_row_bf16", *qkv(8, 12, 128, 64, bf16), row_bias(8, 128),
         False),
        ("causal_f32", *qkv(8, 12, 128, 64, f32), None, True),
        ("full_bias_f32", *qkv(8, 12, 128, 64, f32),
         torch.randn(8, 12, 128, 128, generator=g, device="cuda"), False),
        ("ragged_t100_f32", *qkv(8, 12, 100, 64, f32), row_bias(8, 100),
         False),
        ("d128_f32", *qkv(8, 12, 128, 128, f32), row_bias(8, 128), False),
        ("d128_bf16", *qkv(8, 12, 128, 128, bf16), row_bias(8, 128),
         False),
        # one padding row shared by the whole batch (bias batch stride 0)
        ("shared_row_f32", *qkv(8, 12, 128, 64, f32), row_bias(1, 128),
         False),
        ("masked_row_f32", *qkv(8, 12, 128, 64, f32), masked_row_bias(),
         False),
        ("causal_row_tq64_tk128_f32", q_only(8, 12, 64, 64, f32),
         *qkv(8, 12, 128, 64, f32)[1:], row_bias(8, 128), True),
    ]


def attention_bound_ms(q, k, bias, causal):
    """Least time on an H100 SXM: bytes moved (q, k, v, bias read once,
    out written once) over the memory rate, against the operations the
    unmasked (q, k) pairs need over the peak rate of the input type."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    if bias is not None:
        nbytes += bias.element_size() * bias.numel()
    pairs = sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk
    flops = 4 * b * h * d * pairs
    dtype = str(q.dtype).replace("torch.", "")
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def kernel_phase(torch):
    from paddle_tpu_torch.ops import attention_kernels as ak

    phase("kernel vs plain (flash_attention_fwd)")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, q, k, v, bias, causal in attention_cases(torch):
        scale = q.shape[-1] ** -0.5
        out = ak.flash_attention(q, k, v, bias=bias, causal=causal)
        ref = ak.flash_attention_reference(q, k, v, bias, causal, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        dtype = str(q.dtype).replace("torch.", "")
        ok = err <= ATOL[dtype]
        mask, is_causal = None if bias is None else bias.to(q.dtype), causal
        if causal and mask is not None:
            # SDPA takes no mask together with is_causal: fold it in
            keep = torch.ones(q.shape[2], k.shape[2], dtype=torch.bool,
                              device="cuda").tril()
            mask, is_causal = mask.masked_fill(~keep, float("-inf")), False
        row = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: ak.flash_attention(
                q, k, v, bias=bias, causal=causal)),
            "plain_ms": time_ms(torch, lambda: ak.flash_attention_reference(
                q, k, v, bias, causal, scale)),
            "library_ms": time_ms(torch, lambda: sdpa(
                q, k, v, attn_mask=mask, is_causal=is_causal, scale=scale)),
        }
        row["bound_ms"], row["bound_by"] = attention_bound_ms(q, k, bias,
                                                              causal)
        rows[name] = row
        print(f"{name}: shape {tuple(q.shape)} {dtype} max_abs_err {err:.3e}"
              f" (atol {ATOL[dtype]:g}) kernel {row['ms']:.6f} ms plain "
              f"{row['plain_ms']:.6f} ms sdpa {row['library_ms']:.6f} ms "
              f"bound {row['bound_ms']:.6f} ms ({row['bound_by']})",
              flush=True)
        if not ok:
            raise SystemExit(f"flash_attention_fwd disagrees with its plain "
                             f"version on {name}: {err} > {ATOL[dtype]}")
    return rows


def train_attention_cases(torch):
    """(name, q, k, v, bias, causal, dropout_p, dbias) on the card, made
    from SEED: the BERT-base training shape and its edge cases."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    f32, bf16 = torch.float32, torch.bfloat16
    b, h, t, d = TRAIN_B, 12, TRAIN_T, 64

    def qkv(dtype, t=t, d=d):
        return [torch.randn(b, h, t, d, generator=g, device="cuda")
                .to(dtype) for _ in range(3)]

    def pad_mask(t=t):
        lens = torch.randint(t // 4, t + 1, (b,), generator=g,
                             device="cuda")
        pad = torch.arange(t, device="cuda")[None, :] >= lens[:, None]
        return (pad.float() * -10000.0).reshape(b, 1, 1, t)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda") * 0.5

    masked = torch.randn(b, h, t, t, generator=g, device="cuda")
    masked[0, 0, 5, :] = float("-inf")
    return [
        ("bert_row_f32", *qkv(f32), pad_mask(), False, 0.0, False),
        # the main path's case: BERT-base training, attention dropout 0.1
        ("bert_row_f32_drop", *qkv(f32), pad_mask(), False, 0.1, False),
        ("bert_row_bf16", *qkv(bf16), pad_mask(), False, 0.0, False),
        ("bert_row_bf16_drop", *qkv(bf16), pad_mask(), False, 0.1, False),
        ("causal_f32", *qkv(f32), None, True, 0.0, False),
        ("full_bias_dbias_f32", *qkv(f32), randn(b, h, t, t), False, 0.0,
         True),
        ("row_bias_dbias_f32", *qkv(f32), randn(b, 1, 1, t), False, 0.1,
         True),
        ("shared_row_dbias_f32", *qkv(f32), randn(1, 1, 1, t), False, 0.0,
         True),
        ("ragged_t100_f32_drop", *qkv(f32, t=100), pad_mask(100), False,
         0.1, False),
        ("d128_f32_drop", *qkv(f32, d=128), pad_mask(), False, 0.1, False),
        ("masked_row_dbias_f32", *qkv(f32), masked, False, 0.0, True),
    ]


def train_bounds_ms(q, k, bias, causal, dbias):
    """Least time on an H100 SXM of K1 (with lse), K2a and K2b: each
    input read once and each output written once over the memory rate,
    against the products the unmasked (q, k) pairs need (4, 8 and 6
    FLOP per pair and head dim) over the peak rate of the input type."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    es = q.element_size()
    nq, nk = es * q.numel(), es * k.numel()
    rows = 4 * b * h * tq                       # one fp32 lse or delta
    nbias = 0 if bias is None else 4 * bias.numel()
    ndbias = 0 if not dbias else 4 * (
        b * tk if bias.shape[1] == bias.shape[2] == 1 else b * h * tq * tk)
    pairs = sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    work = {"fwd": (2 * nq + 2 * nk + nbias + rows, 4),
            "dkv": (2 * nq + 4 * nk + nbias + 2 * rows, 8),
            "dq": (3 * nq + 2 * nk + nbias + 2 * rows + ndbias, 6)}
    out = {}
    for kern, (nbytes, per_pair) in work.items():
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = per_pair * b * h * d * pairs / peak * 1e3
        out[kern] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes > t_ops else "operations")
    return out


def max_err(torch, got, want):
    """Max |got - want|; -inf entries (lse of a fully masked row) must sit
    at the same places in both."""
    got, want = got.float(), want.float()
    inf = torch.isinf(want)
    if not torch.equal(inf, torch.isinf(got)):
        return float("inf")
    return (got - want).abs()[~inf].max().item()


def train_kernel_phase(torch):
    from paddle_tpu_torch.ops import attention_kernels as ak

    phase("training kernels vs plain (K1 with lse and dropout, K2a, K2b)")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {"fwd": {}, "dkv": {}, "dq": {}}
    for i, (name, q, k, v, bias, causal, p, dbias) in enumerate(
            train_attention_cases(torch)):
        scale = q.shape[-1] ** -0.5
        seed = SEED + i
        dtype = str(q.dtype).replace("torch.", "")
        dout = torch.randn_like(q)
        args = (q, k, v, bias, causal, scale, p, seed)
        out, lse = ak.flash_attention_fwd(*args, with_lse=True)
        delta = ak.attention_delta(dout, out)
        bwd = (q, k, v, bias, dout, lse, delta, causal, scale, p, seed)
        dk, dv = ak.flash_attention_bwd_dkv(*bwd)
        dq, db = ak.flash_attention_bwd_dq(*bwd, dbias=dbias)
        out_r, lse_r = ak.flash_attention_reference(*args, return_lse=True)
        # the backward's plain version on the backward kernels' inputs
        dq_r, dk_r, dv_r, db_r = ak.flash_attention_backward_reference(
            q, k, v, bias, out, lse, dout, causal, scale, p, seed)
        torch.cuda.synchronize()
        errs = {"out": max_err(torch, out, out_r),
                "lse": max_err(torch, lse, lse_r),
                "dq": max_err(torch, dq, dq_r),
                "dk": max_err(torch, dk, dk_r),
                "dv": max_err(torch, dv, dv_r)}
        tols = {"out": TRAIN_ATOL["out"][dtype], "lse": TRAIN_ATOL["lse"],
                "dq": TRAIN_ATOL["grad"][dtype],
                "dk": TRAIN_ATOL["grad"][dtype],
                "dv": TRAIN_ATOL["grad"][dtype]}
        if dbias:
            errs["dbias"] = max_err(torch, db, db_r)
            tols["dbias"] = TRAIN_ATOL["dbias"]

        # the library yardstick: SDPA forward, and its backward under
        # torch.autograd.grad (math/efficient backends; the port never
        # calls it)
        fwd_mask = None if bias is None else bias.to(q.dtype)
        mask, is_causal = fwd_mask, causal
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        if dbias:
            mask = mask.detach().requires_grad_()
            leaves.append(mask)
        lib_out = sdpa(*leaves[:3], attn_mask=mask, is_causal=is_causal,
                       dropout_p=p, scale=scale)
        bounds = train_bounds_ms(q, k, bias, causal, dbias)
        plain_bwd_ms = time_ms(torch, lambda: (
            ak.flash_attention_backward_reference(
                q, k, v, bias, out, lse, dout, causal, scale, p, seed)))
        lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, leaves, dout, retain_graph=True))
        timed = {
            "fwd": (lambda: ak.flash_attention_fwd(*args, with_lse=True),
                    lambda: ak.flash_attention_reference(
                        *args, return_lse=True),
                    lambda: sdpa(q, k, v, attn_mask=fwd_mask,
                                 is_causal=causal, dropout_p=p,
                                 scale=scale)),
            "dkv": (lambda: ak.flash_attention_bwd_dkv(*bwd), None, None),
            "dq": (lambda: ak.flash_attention_bwd_dq(*bwd, dbias=dbias),
                   None, None),
        }
        errs_of = {"fwd": ("out", "lse"), "dkv": ("dk", "dv"),
                   "dq": ("dq", "dbias")}
        for kern, (fn, plain, lib) in timed.items():
            rows[kern][name] = {
                "max_abs_err": max(errs[e] for e in errs_of[kern]
                                   if e in errs),
                "ms": time_ms(torch, fn),
                "plain_ms": time_ms(torch, plain) if plain else
                plain_bwd_ms,
                "library_ms": time_ms(torch, lib) if lib else lib_bwd_ms,
                "bound_ms": bounds[kern][0], "bound_by": bounds[kern][1]}
        print(f"{name}: q {tuple(q.shape)} {dtype} dropout {p} causal "
              f"{causal} bias {None if bias is None else tuple(bias.shape)}"
              f" dbias {dbias}", flush=True)
        print("  max_abs_err " + " ".join(
            f"{e} {errs[e]:.3e} (atol {tols[e]:g})" for e in errs))
        # the plain versions repeat the kernels' products in the same
        # order, so fp32 errors may be exactly 0: the sizes show the
        # comparison is not of zeros
        print("  max |kernel| " + " ".join(
            f"{e} {t.float().abs().max().item():.3e}" for e, t in
            (("dq", dq), ("dk", dk), ("dv", dv), ("dbias", db))
            if t is not None))
        for kern, r in rows.items():
            r = r[name]
            print(f"  {KERNELS[kern]['name']}: kernel {r['ms']:.6f} ms "
                  f"plain {r['plain_ms']:.6f} ms sdpa {r['library_ms']:.6f}"
                  f" ms bound {r['bound_ms']:.6f} ms ({r['bound_by']})",
                  flush=True)
        bad = [e for e in errs if not errs[e] <= tols[e]]
        if bad:
            raise SystemExit(f"training kernels disagree with their plain "
                             f"versions on {name}: "
                             f"{ {e: errs[e] for e in bad} }")
        if name == "bert_row_f32_drop":
            dropout_checks(torch, ak, args, seed)
    return rows


def dropout_checks(torch, ak, args, seed):
    """The p=0.1 mask of the BERT training shape: keep rate over its
    B*H*T*T draws, and the kernel's bits fixed by the seed."""
    q, k = args[0], args[1]
    b, h, t, _ = q.shape
    keep = ak.philox_keep_mask(seed, b * h, t, k.shape[2], 0.1,
                               device=q.device)
    rate = keep.float().mean().item()
    again = ak.flash_attention_fwd(*args)
    same = torch.equal(again, ak.flash_attention_fwd(*args))
    other = ak.flash_attention_fwd(*args[:-1], seed + 1)
    differs = not torch.equal(again, other)
    print(f"  dropout 0.1: keep rate {rate:.6f} over {keep.numel()} draws "
          f"(tolerance {KEEP_RATE_TOL:g}); same seed identical {same}, "
          f"next seed differs {differs}")
    if abs(rate - 0.9) > KEEP_RATE_TOL or not same or not differs:
        raise SystemExit("attention dropout bits fail their checks")


def int8_library(torch, xq, wq):
    """torch._int_mm (cuBLASLt) on the kernel's operands, or None where it
    refuses the shape (M <= 16, K or N not a multiple of 8)."""
    try:
        torch._int_mm(xq, wq)
    except RuntimeError:
        return None
    return lambda: torch._int_mm(xq, wq)


def quant_kernel_phase(torch):
    """K6 against its plain version, which must give the same bits."""
    from paddle_tpu_torch.ops import quant_kernels as qk

    phase("int8 kernel vs plain (quant_matmul)")
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = {}
    for name, m, k, n in QUANT_CASES:
        xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                           dtype=torch.int8)
        cs = torch.rand(n, generator=g, device="cuda") * 1e-4 + 1e-6
        out = qk.int8_matmul(xq, wq, cs)
        ref = qk.int8_matmul_reference(xq, wq, cs)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        lib = int8_library(torch, xq, wq)
        nbytes = m * k + k * n + 4 * n + 4 * m * n
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = 2 * m * k * n / PEAK_FLOPS["int8"] * 1e3
        row = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: qk.int8_matmul(xq, wq, cs)),
            "plain_ms": time_ms(torch, lambda: qk.int8_matmul_reference(
                xq, wq, cs)),
            "library_ms": None if lib is None else time_ms(
                torch, lambda: lib().float() * cs),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}
        rows[name] = row
        lib_txt = "refused" if lib is None else \
            f"{row['library_ms']:.6f} ms"
        print(f"{name}: M {m} K {k} N {n} max_abs_err {err:.3e} (must be 0;"
              f" max |out| {out.abs().max().item():.3e}) kernel "
              f"{row['ms']:.6f} ms plain {row['plain_ms']:.6f} ms "
              f"_int_mm+scale {lib_txt} bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']})", flush=True)
        if err != 0.0:
            raise SystemExit(f"quant_matmul disagrees with its plain version "
                             f"on {name}: {err}")
    return rows


def bert_requests(cfg, t, n):
    """n single-row requests: seeded token ids and padding masks."""
    rng = np.random.RandomState(SEED)
    reqs = []
    for _ in range(n):
        length = rng.randint(t // 4, t + 1)
        bias = np.zeros((1, 1, 1, t), np.float32)
        bias[..., length:] = -10000.0
        sent = np.zeros((1, t), np.int64)
        sent[0, length // 2:length] = 1
        reqs.append({
            "src_ids": rng.randint(0, cfg.vocab_size, (1, t)).astype(
                np.int64),
            "pos_ids": np.arange(t, dtype=np.int64)[None, :],
            "sent_ids": sent, "attn_bias": bias})
    return reqs


def serve(fluid, pred, reqs, max_batch, counters, on_start=None):
    """Serve `reqs` through a ServingEngine over `pred`: warm-up, then
    every launch counter set to 0 (and `on_start` called) just before the
    timed burst and read just after it."""
    engine = fluid.serving.ServingEngine(
        pred, fluid.serving.ServingConfig(max_batch_size=max_batch,
                                          max_wait_ms=5.0))
    try:
        engine.warmup()
        # one warm-up round through the engine (cuBLAS handles, allocator)
        for r in [engine.submit(f) for f in reqs[:max_batch]]:
            r.result(120)
        engine.reset_stats()
        for c in counters.values():
            c.launches = 0
        if on_start is not None:
            on_start()
        done_ms = []
        t0 = time.perf_counter()
        futures = [engine.submit(f) for f in reqs]
        for f in futures:
            f.add_done_callback(lambda r: done_ms.append(
                (time.perf_counter() - r.enq_t) * 1e3))
        served = [f.result(120)[0] for f in futures]
        wall_s = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        stats = engine.stats()
    finally:
        engine.stop()
    c = stats["counters"]
    n_req = len(reqs)
    print(f"answered {c['completed']}/{n_req} in {c['batches_executed']} "
          f"batches, launches {launches}")
    if c["completed"] != n_req or len(served) != n_req:
        raise SystemExit(f"only {c['completed']} of {n_req} requests "
                         "were answered")
    served = np.concatenate(served)
    if served.shape != (n_req, 2) or not np.isfinite(served).all():
        raise SystemExit(f"served output has shape {served.shape} or is "
                         "not finite")
    lat = stats["latency_ms"]
    run = {"served": served, "launches": launches, "stats": stats,
           "batches": c["batches_executed"], "wall_s": wall_s,
           "p50": float(np.percentile(done_ms, 50)),
           "p99": float(np.percentile(done_ms, 99)),
           "req_s": n_req / wall_s}
    run["line"] = (f"latency p50 {lat['p50']} ms p99 {lat['p99']} ms "
                   f"(engine histogram, bucket edges), client-side p50 "
                   f"{run['p50']:.6f} ms p99 {run['p99']:.6f} ms, "
                   f"{run['req_s']:.3f} req/s over {wall_s:.6f} s, "
                   f"compute_ms avg {stats['compute_ms']['avg']} per batch, "
                   f"batch occupancy {stats['batch_occupancy']}")
    return run


def serving_phase(torch, smi):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.bert import BertConfig, bert_classifier
    from paddle_tpu_torch.ops import attention_kernels as ak

    phase("serving BERT-base through Predictor -> ServingEngine")
    cfg = BertConfig(vocab_size=30522, hidden_size=768, num_layers=12,
                     num_heads=12, intermediate_size=3072,
                     max_position=512, type_vocab_size=2, dropout=0.1)
    t_seq, n_req, max_batch = 128, 32, 8
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        probs, feeds = bert_classifier(cfg, t_seq)
    model_dir = tempfile.mkdtemp(prefix="bert_base_")
    t0 = time.perf_counter()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, feeds, [probs], exe,
                                      main_program=main)
    n_params = sum(v.numel() for v in scope.vars.values()
                   if v is not None)
    print(f"BERT-base: {n_params} parameters, startup on the card + save "
          f"in {time.perf_counter() - t0:.3f} s")

    pred = fluid.create_paddle_predictor(fluid.AnalysisConfig(model_dir))
    reqs = bert_requests(cfg, t_seq, n_req)
    run = serve(fluid, pred, reqs, max_batch, {"fwd": ak.flash_attention})
    launches = run["launches"]["fwd"]
    if launches != cfg.num_layers * run["batches"] or launches == 0:
        raise SystemExit(f"flash_attention_fwd ran {launches} times for "
                         f"{run['batches']} batches, expected "
                         f"{cfg.num_layers * run['batches']}")
    cpu_cfg = fluid.AnalysisConfig(model_dir)
    cpu_cfg.disable_gpu()
    cpu_pred = fluid.create_paddle_predictor(cpu_cfg)
    cpu = np.concatenate([
        cpu_pred.run({n: np.concatenate([r[n] for r in reqs[i:i + 8]])
                      for n in feeds})[0]
        for i in range(0, n_req, 8)])
    err = float(np.abs(run["served"] - cpu).max())
    print(f"served vs CPU Predictor: max_abs_err {err:.3e} "
          f"(atol {SERVE_ATOL:g})")
    if err > SERVE_ATOL:
        raise SystemExit(f"card and CPU predictors disagree: {err}")
    print(f"serving [{smi}]: {run['line']}")
    batch = {n: np.concatenate([r[n] for r in reqs[:max_batch]])
             for n in feeds}
    profile_batch(torch, pred, batch, smi)
    run.update(cfg=cfg, model_dir=model_dir, reqs=reqs, batch=batch,
               max_batch=max_batch)
    return run


def code_flips(qk, card_pred, cpu_pred, feed):
    """The int8 activation codes of every quantized matmul of one batch,
    on the card and on the CPU: how many differ, per matmul."""
    codes, quantize = [], qk.quantize_activation

    def recording(x):
        xq, xs = quantize(x)
        codes.append(xq.cpu())
        return xq, xs

    qk.quantize_activation = recording
    try:
        card_pred.run(feed)
        card = codes[:]
        codes.clear()
        cpu_pred.run(feed)
    finally:
        qk.quantize_activation = quantize
    return {"counts": [int((a != b).sum()) for a, b in zip(card, codes)],
            "sizes": [a.numel() for a in card],
            "max_step": max(int((a.int() - b.int()).abs().max())
                            for a, b in zip(card, codes))}


def quant_serving_phase(torch, smi, fp32):
    """The serving phase's model dir and requests served with int8
    weights: the main path of the int8 slice (K1 and K6)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import quant_kernels as qk

    phase("quantized serving: AnalysisConfig.enable_quantize() -> "
          "ServingEngine")
    cfg = fluid.AnalysisConfig(fp32["model_dir"])
    cfg.enable_quantize()
    t0 = time.perf_counter()
    pred = fluid.create_paddle_predictor(cfg)
    n_quant = sum("__quant__" in op.attrs
                  for op in pred._program.global_block().ops)
    print(f"quantized predictor: {n_quant} __quant__ ops, load + quantize "
          f"in {time.perf_counter() - t0:.3f} s")
    # every padded batch the engine executes, with the card's answers
    executed, run_feeds, int8_matmul = [], pred._run_feeds, qk.int8_matmul

    def recorded(feed):
        outs = run_feeds(feed)
        executed.append(({n: np.array(a) for n, a in feed.items()}, outs))
        return outs

    pred._run_feeds = recorded
    run = serve(fluid, pred, fp32["reqs"], fp32["max_batch"],
                {"fwd": ak.flash_attention, "quant": qk.int8_matmul},
                on_start=executed.clear)
    pred._run_feeds = run_feeds
    want = {"fwd": fp32["cfg"].num_layers * run["batches"],
            "quant": n_quant * run["batches"]}
    print(f"launches {run['launches']} (expected {want}: "
          f"{fp32['cfg'].num_layers} and {n_quant} per batch)")
    if run["launches"] != want or not run["batches"] or             len(executed) != run["batches"]:
        raise SystemExit(f"quantized serving launches {run['launches']} for "
                         f"{run['batches']} batches ({len(executed)} "
                         f"recorded), expected {want}")
    # the path with K6 against the same path with K6's plain version, on
    # the card, on one executed batch: the rest of the path is the same
    # deterministic sequence of kernels, so the answers must be equal
    feed, outs = executed[0]
    qk.int8_matmul = qk.int8_matmul_reference
    try:
        (plain,) = pred.run(feed)
    finally:
        qk.int8_matmul = int8_matmul
    path_err = float(np.abs(outs[0] - plain).max())
    print(f"served batch with K6 vs with its plain version on the card: "
          f"max_abs_err {path_err:.3e} (must be 0; max |out| "
          f"{np.abs(plain).max():.3e})")
    if path_err != 0.0:
        raise SystemExit(f"the int8 path with K6 departs from its plain "
                         f"version: {path_err}")
    cpu_cfg = fluid.AnalysisConfig(fp32["model_dir"])
    cpu_cfg.disable_gpu()
    cpu_cfg.enable_quantize()
    cpu_pred = fluid.create_paddle_predictor(cpu_cfg)
    flips = code_flips(qk, pred, cpu_pred, feed)
    print(f"int8 activation codes that differ card vs CPU on one batch, per "
          f"quantized matmul in program order (of "
          f"{flips['sizes'][0]}-{max(flips['sizes'])} codes each): first 6 "
          f"{flips['counts'][:6]}, last 6 {flips['counts'][-6:]}, total "
          f"{sum(flips['counts'])} of {sum(flips['sizes'])}, largest code "
          f"difference {flips['max_step']}")
    err = max(float(np.abs(outs[0] - cpu_pred.run(feed)[0]).max())
              for feed, outs in executed)
    rows = sorted({len(next(iter(f.values()))) for f, _ in executed})
    print(f"card vs CPU quantized Predictor on the engine's {len(executed)} "
          f"padded batches (rows {rows}): max_abs_err {err:.3e} (atol "
          f"{SERVE_QUANT_ATOL:g})")
    if err > SERVE_QUANT_ATOL:
        raise SystemExit(f"card and CPU quantized predictors disagree: {err}")
    dq = float(np.abs(run["served"] - fp32["served"]).max())
    print(f"quantized vs fp32 served probabilities: max_abs_diff {dq:.3e} "
          f"(bar {QUANT_FP32_BAR:g})")
    if not dq < QUANT_FP32_BAR:
        raise SystemExit(f"quantized answers depart from fp32 by {dq}")
    print(f"serving int8 [{smi}]: {run['line']}")
    print(f"serving fp32 [{smi}]: {fp32['line']}")
    profile_batch(torch, pred, fp32["batch"], smi)
    return run


def profile_batch(torch, pred, feed, smi):
    """Where one batch's time goes: host wall time of Predictor.run
    (median of 5, unprofiled), then one run under torch.profiler for the
    device's busy time, its idle share and the kernels that fill it."""
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred.run(feed)
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"batch of {len(next(iter(feed.values())))}: wall "
          f"{statistics.median(walls):.6f} ms unprofiled (median of 5)")
    profile_run(torch, lambda: pred.run(feed), "one batch (Predictor.run)",
                smi)


def profile_run(torch, run, label, smi):
    """One run() under torch.profiler: its wall time, the device's busy
    time and idle share, and the kernels that fill it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    phase(f"profile {label}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's row repeats its kernels' time
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[{smi}] {label}: {prof_wall:.6f} ms profiled; device busy "
          f"{busy:.6f} ms, idle share {1.0 - busy / prof_wall:.4f} of the "
          f"profiled wall")
    for name, ms, count in rows[:12]:
        print(f"  {ms:10.6f} ms  x{count:<5d} {name[:90]}")
    # the host side: torch operators by self CPU time (profiled, so
    # inflated), and how many the run dispatched
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU
                   and e.key.startswith("aten::")), key=lambda r: -r[1])
    print(f"  host: {sum(r[2] for r in host)} torch operator calls, "
          f"{sum(r[1] for r in host):.6f} ms of self CPU time; top: " +
          ", ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in host[:6]))


def pretrain_program(fluid, num_layers, dropout):
    """BERT-base-width pretraining (MLM + NSP heads) with Adam(1e-4):
    (main, startup, loss), random seeds fixed to SEED."""
    from paddle_tpu_torch.models.bert import BertConfig, bert_pretrain

    cfg = BertConfig(num_layers=num_layers, dropout=dropout, **BERT_BASE)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        loss, _ = bert_pretrain(cfg, TRAIN_T)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return main, startup, loss


def pretrain_feed(b, t, m, seed):
    """A pretraining batch from a numpy seed: token ids, padding masks,
    two segments, `m` masked positions per sequence (absolute flattened
    indices inside each sequence's length) with their labels, NSP
    labels."""
    rng = np.random.RandomState(seed)
    vocab = BERT_BASE["vocab_size"]
    lens = rng.randint(t // 2, t + 1, b)
    bias = np.zeros((b, 1, 1, t), np.float32)
    sent = np.zeros((b, t), np.int64)
    pos = np.zeros((b * m, 1), np.int64)
    for i, n in enumerate(lens):
        bias[i, ..., n:] = -10000.0
        sent[i, n // 2:n] = 1
        pos[i * m:(i + 1) * m, 0] = i * t + rng.choice(n, m, replace=False)
    return {"src_ids": rng.randint(0, vocab, (b, t)).astype(np.int64),
            "pos_ids": np.tile(np.arange(t, dtype=np.int64), (b, 1)),
            "sent_ids": sent, "attn_bias": bias, "mask_pos": pos,
            "mlm_label": rng.randint(0, vocab, (b * m, 1)).astype(np.int64),
            "mlm_weight": np.ones((b * m, 1), np.float32),
            "nsp_label": rng.randint(0, 2, (b, 1)).astype(np.int64)}


def training_parity_phase(torch):
    """2-layer BERT-base width, batch 8: the card's first three losses
    against the CPU's, from one startup state and the same feeds."""
    import paddle_tpu_torch as fluid

    phase("training parity: 2-layer BERT-base width, card vs CPU")
    feed = pretrain_feed(8, TRAIN_T, TRAIN_M, SEED)
    for dropout in (0.0, 0.1):
        main, startup, loss = pretrain_program(fluid, 2, dropout)
        card_vs_cpu(fluid, main, startup, loss, [feed] * 3,
                    f"dropout {dropout}")
    torch.cuda.empty_cache()


def training_phase(torch, smi):
    """BERT-base pretraining on the card: the main path of this slice."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import attention_kernels as ak

    phase(f"training BERT-base: 12 layers, batch {TRAIN_B}, seq {TRAIN_T}, "
          f"dropout 0.1, Adam, {TRAIN_STEPS} steps")
    layers = 12
    main, startup, loss = pretrain_program(fluid, layers, 0.1)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    print(f"BERT-base pretraining: {n_params} parameters, "
          f"{len(main.global_block().ops)} ops, startup on the card in "
          f"{time.perf_counter() - t0:.3f} s")
    feed = pretrain_feed(TRAIN_B, TRAIN_T, TRAIN_M, SEED + 7)
    counters = {"fwd": ak.flash_attention, "dkv": ak.flash_attention_bwd_dkv,
                "dq": ak.flash_attention_bwd_dq}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        (value,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        walls.append(time.perf_counter() - t0)
        losses.append(float(value))
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    # per step: K1 once in the forward op and once in the generic grad's
    # recompute (with lse) per layer; K2a and K2b once per layer
    want = {"fwd": 2 * layers * TRAIN_STEPS, "dkv": layers * TRAIN_STEPS,
            "dq": layers * TRAIN_STEPS}
    step_s = statistics.median(walls[1:])
    print(f"losses {losses}")
    print(f"launches {launches} (expected {want})")
    print(f"[{smi}] step {step_s * 1e3:.6f} ms (median of steps 2-"
          f"{TRAIN_STEPS}; first step {walls[0] * 1e3:.6f} ms), "
          f"{TRAIN_B * TRAIN_T / step_s:.3f} tokens/s, peak memory "
          f"{peak} bytes ({peak / 2**30:.3f} GiB)", flush=True)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise SystemExit(f"training losses are not finite and falling: "
                         f"{losses}")
    if launches != want:
        raise SystemExit(f"kernel launches {launches}, expected {want}")
    profile_run(torch, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope),
                f"one training step (batch {TRAIN_B}, seq {TRAIN_T})", smi)
    return launches


# ---------------------------------------------------------------------------
# the RNN slice: K7, K8, K9 and the seq2seq, GRU and sequence-softmax
# programs
# ---------------------------------------------------------------------------

def thnn_lstm_cell(torch, gates, c_prev):
    """The library yardstick of K8: PyTorch's fused LSTM cell on the same
    gates reordered from (c, i, f, o) to its (i, f, g, o) order (done
    here, outside the timed call), with zero hidden gates."""
    gc, gi, gf, go = gates.chunk(4, dim=-1)
    ig = torch.cat([gi, gf, gc, go], dim=-1).contiguous()
    hg = torch.zeros_like(ig)
    return lambda: torch.ops.aten._thnn_fused_lstm_cell(ig, hg, c_prev)


def thnn_gru_cell(torch, gu, gc, h_prev, origin_mode):
    """The library yardstick of K9: PyTorch's fused GRU cell, whose
    hy = (1 - z)·tanh(n) + z·hx with z = σ(its update gate), on input
    gates (0 | gu | gc) in its (r, z, n) order and zero hidden gates.
    That is K9 with origin_mode; the default mode's
    (1 - σ(gu))·h + σ(gu)·tanh(gc) follows from z = σ(-gu).  The gates
    are assembled here, outside the timed call."""
    z = gu if origin_mode else -gu
    ig = torch.cat([torch.zeros_like(gc), z, gc], dim=-1).contiguous()
    hg = torch.zeros_like(ig)
    return lambda: torch.ops.aten._thnn_fused_gru_cell(ig, hg, h_prev)


def torch_masked_softmax(torch, x, lens):
    """The library yardstick of K7: torch._masked_softmax over the last
    dim with the boolean mask of the invalid positions (mask type 2: the
    mask has x's shape), built here, outside the timed call."""
    invalid = torch.arange(x.shape[1], device=x.device)[None, :] \
        >= lens[:, None]
    return lambda: torch._masked_softmax(x, invalid, 1, 2)


def grads_err(torch, fn, plain, inputs, cots):
    """Max |output or grad| difference of `fn` (a kernel's wrapper, its
    backward included) against `plain` under torch autograd, on the same
    inputs and cotangents."""
    res = []
    for f in (fn, plain):
        leaves = [t.detach().requires_grad_() for t in inputs]
        outs = f(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        res.append(list(outs) + list(torch.autograd.grad(outs, leaves,
                                                         cots)))
    torch.cuda.synchronize()
    return max((a - b).abs().max().item() for a, b in zip(*res))


def bound_row(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def rnn_kernel_phase(torch):
    """K8, K9 and K7 against their plain versions at the shapes of the
    slice's programs and at edge shapes.  Bounds count each input read
    once and each output written once (fp32), and the flops the function
    needs with a transcendental as one: 15 an element for the LSTM cell
    (three sigmoids of exp, add, divide; two tanh; three multiplies and
    an add), 8 for the GRU output, 7 per valid element for the softmax.
    At these sizes every kernel is launch-bound: its bound is tens of
    nanoseconds."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    from paddle_tpu_torch.ops import sequence_kernels as sk

    phase("RNN and sequence kernels vs plain (lstm_cell, gru_output, "
          "masked_softmax)")
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda") * 2.0

    rows = {"lstm": {}, "gru": {}, "softmax": {}}

    def report(kern, name, err, fwd, plain, lib, bound, note):
        row = {"max_abs_err": err, "ms": time_ms(torch, fwd),
               "plain_ms": time_ms(torch, plain),
               "library_ms": None if lib is None else time_ms(torch, lib),
               **bound}
        rows[kern][name] = row
        lib_txt = "–" if lib is None else f"{row['library_ms']:.6f} ms"
        print(f"{KERNELS[kern]['name']} {name}: {note} max_abs_err "
              f"{err:.3e} (outputs and grads, atol {RNN_ATOL:g}) kernel "
              f"{row['ms']:.6f} ms plain {row['plain_ms']:.6f} ms library "
              f"{lib_txt} bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']}; launch-bound at this size)", flush=True)
        if not err <= RNN_ATOL:
            raise SystemExit(f"{KERNELS[kern]['name']} disagrees with its "
                             f"plain version on {name}: {err}")

    # K8: the seq2seq encoder's step, B = 1, D not a multiple of 128, and
    # B * D not a multiple of 32
    for name, b, d in (("seq2seq_b16_d512", 16, 512), ("b1_d512", 1, 512),
                       ("b16_d129", 16, 129), ("b3_d37", 3, 37)):
        gates, c_prev = randn(b, 4 * d), randn(b, d)
        lib = thnn_lstm_cell(torch, gates, c_prev)
        diff = max((a - b).abs().max().item() for a, b in zip(
            rk.fused_lstm_cell(gates, c_prev), lib()))
        print(f"  _thnn_fused_lstm_cell vs kernel: max_abs_diff {diff:.3e}")
        err = grads_err(torch, rk.fused_lstm_cell, rk.lstm_cell_reference,
                        (gates, c_prev), (randn(b, d), randn(b, d)))
        report("lstm", name, err,
               lambda: rk.fused_lstm_cell(gates, c_prev),
               lambda: rk.lstm_cell_reference(gates, c_prev), lib,
               bound_row(4 * b * d * 7, 15 * b * d), f"B {b} D {d}")

    # K9: the GRU program's step in both modes, gu read in place out of
    # the [B, 2D] (u | r) buffer (row stride 2D), as the gru op passes it;
    # and a contiguous gu at an edge shape
    for name, b, d, mode, strided in (
            ("gru_b16_d512", 16, 512, False, True),
            ("gru_b16_d512_origin", 16, 512, True, True),
            ("gru_b5_d129_contiguous", 5, 129, False, False)):
        gu = randn(b, 2 * d)[:, :d] if strided else randn(b, d)
        gc, h_prev = randn(b, d), randn(b, d)
        lib = thnn_gru_cell(torch, gu, gc, h_prev, mode)
        diff = (rk.fused_gru_output(gu, gc, h_prev, mode)
                - lib()[0]).abs().max().item()
        print(f"  _thnn_fused_gru_cell vs kernel: max_abs_diff {diff:.3e}")
        err = grads_err(
            torch, lambda u, c, h: rk.fused_gru_output(u, c, h, mode),
            lambda u, c, h: rk.gru_output_reference(u, c, h, mode),
            (gu, gc, h_prev), (randn(b, d),))
        report("gru", name, err,
               lambda: rk.fused_gru_output(gu, gc, h_prev, mode),
               lambda: rk.gru_output_reference(gu, gc, h_prev, mode), lib,
               bound_row(4 * b * d * 4, 8 * b * d),
               f"B {b} D {d} origin_mode {mode} strided {strided}")

    # K7: the sequence-softmax program's [16, 128], ragged lengths in
    # [1, 50] with an empty row, and T = 1000
    def lens(b, t, lo):
        return torch.randint(lo, t + 1, (b,), generator=g, device="cuda",
                             dtype=torch.int32)

    ragged = lens(16, 50, 1)
    ragged[3] = 0
    for name, x, n in (
            ("b16_t128", randn(16, 128), torch.full(
                (16,), 128, dtype=torch.int32, device="cuda")),
            ("ragged_t50_empty_row", randn(16, 50), ragged),
            ("b16_t1000", randn(16, 1000), lens(16, 1000, 1))):
        mask = sk.length_mask(n, x.shape[1])
        lib = torch_masked_softmax(torch, x, n)
        # the library call leaves an empty row NaN; K7 writes it 0
        rows_valid = n > 0
        diff = (sk.masked_softmax(x, n) - lib())[rows_valid].abs().max()
        print(f"  torch._masked_softmax vs kernel: max_abs_diff "
              f"{diff.item():.3e} over the non-empty rows")
        err = grads_err(torch, lambda v: sk.masked_softmax(v, n),
                        lambda v: sk.masked_softmax_reference(v, mask),
                        (x,), (randn(*x.shape),))
        valid = int(n.sum().item())
        report("softmax", name, err, lambda: sk.masked_softmax(x, n),
               lambda: sk.masked_softmax_reference(x, mask), lib,
               bound_row(8 * x.numel() + 4 * n.numel(), 7 * valid),
               f"x {tuple(x.shape)} ({valid} valid)")
    return rows


def rnn_program(fluid, net, optimizer, **sizes):
    """(main, startup, loss) of `net` with `optimizer`, seeds fixed to
    SEED."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        loss = net(fluid, **sizes)
        loss = loss[0] if isinstance(loss, tuple) else loss
        optimizer.minimize(loss)
    return main, startup, loss


def card_vs_cpu(fluid, main, startup, loss, feeds, label, counters=(),
                min_move=None):
    """One startup state (run on the CPU), the losses of `feeds` on the
    card and on the CPU, held to PARITY_RTOL; `counters` are set to 0
    just before the card's run and read just after.  With `min_move`
    (the feeds are one batch repeated), the CPU's losses after step 1
    must each differ from its step-1 loss by at least that much,
    relatively: a card run that skipped the updates would repeat its
    step-1 loss and fail the comparison.  Returns the card's launches."""
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = {n: t.numpy() for n, t in init.vars.items() if t is not None}
    losses, launches = {}, {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.io.state_from_numpy(state, scope=fluid.Scope(),
                                          place=place, main_program=main)
        exe = fluid.Executor(place)
        on_card = isinstance(place, fluid.CUDAPlace)
        if on_card:
            for c in counters:
                c.launches = 0
        losses[on_card] = [float(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0]) for f in feeds]
        if on_card:
            launches = {c.__name__: c.launches for c in counters}
    card, cpu = losses[True], losses[False]
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    print(f"{label}: card {card} cpu {cpu} relative differences {rel} "
          f"(bounds {PARITY_RTOL[1]:g} at step 1, {PARITY_RTOL[3]:g} at "
          f"step 3)" + (f", card launches {launches}" if counters else ""),
          flush=True)
    if not np.isfinite(card + cpu).all() or rel[0] > PARITY_RTOL[1] \
            or max(rel) > PARITY_RTOL[3]:
        raise SystemExit(f"{label}: the card departs from the CPU: {rel}")
    if min_move is not None:
        moves = [abs(a - cpu[0]) / abs(cpu[0]) for a in cpu[1:]]
        print(f"  the updates move the loss from step 1 by {moves} "
              f"relative (at least {min_move:g} required)")
        if min(moves) < min_move:
            raise SystemExit(f"{label}: the updates move the loss by "
                             f"{moves}, under {min_move:g}")
    return launches


def seq2seq_parity_phase(torch):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.rnn import seq2seq_batch, seq_to_seq_net

    phase("seq2seq parity: dictionary 1000, width 128, card vs CPU")
    main, startup, loss = rnn_program(
        fluid, seq_to_seq_net, fluid.optimizer.Adam(learning_rate=1e-3),
        **S2S_PARITY)
    rng = np.random.RandomState(SEED + 4)
    feeds = [seq2seq_batch(rng, 8, S2S_PARITY["dict_size"], 2, 12)
             for _ in range(3)]
    card_vs_cpu(fluid, main, startup, loss, feeds, "seq2seq width 128")
    torch.cuda.empty_cache()


def seq2seq_training_phase(torch, smi):
    """The book's seq2seq model trained on the card at the benchmark's
    width: the main path of the RNN slice."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.lod import bucket_len
    from paddle_tpu_torch.models.rnn import seq2seq_batch, seq_to_seq_net
    from paddle_tpu_torch.ops import rnn_kernels as rk

    phase(f"training seq2seq: dictionary {S2S_FULL['dict_size']}, width "
          f"{S2S_FULL['hidden']}, batch {S2S_B}, lengths {S2S_LENS}, Adam, "
          f"{S2S_STEPS} steps")
    main, startup, loss = rnn_program(
        fluid, seq_to_seq_net, fluid.optimizer.Adam(learning_rate=1e-3),
        **S2S_FULL)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    feed = seq2seq_batch(np.random.RandomState(SEED + 8), S2S_B,
                         S2S_FULL["dict_size"], *S2S_LENS)
    t_src = bucket_len(max(len(s) for s in feed["source_sequence"]))
    t_trg = bucket_len(max(len(s) for s in feed["target_sequence"]))
    n_trg = sum(len(s) for s in feed["target_sequence"])
    print(f"seq2seq: {n_params} parameters, {len(main.global_block().ops)} "
          f"ops (step block {len(main.blocks[1].ops)}), startup on the card "
          f"in {time.perf_counter() - t0:.3f} s; padded source T {t_src}, "
          f"target T {t_trg}, {n_trg} target tokens")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rk.fused_lstm_cell.launches = 0
    losses, walls = [], []
    for _ in range(S2S_STEPS):
        t0 = time.perf_counter()
        (value,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        walls.append(time.perf_counter() - t0)
        losses.append(float(value))
    launches = rk.fused_lstm_cell.launches
    peak = torch.cuda.max_memory_allocated()
    # per step: one K8 launch per padded source step in each direction,
    # in the lstm ops and again in their generic grads' recompute
    want = 4 * t_src * S2S_STEPS
    step_s = statistics.median(walls[1:])
    print(f"losses {losses}")
    print(f"lstm_cell launches {launches} (expected {want}: 4 x {t_src} "
          f"per step)")
    print(f"[{smi}] step {step_s * 1e3:.6f} ms (median of steps 2-"
          f"{S2S_STEPS}; first step {walls[0] * 1e3:.6f} ms), "
          f"{n_trg / step_s:.3f} target tokens/s, peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise SystemExit(f"seq2seq losses are not finite and falling: "
                         f"{losses}")
    if launches != want:
        raise SystemExit(f"lstm_cell launches {launches}, expected {want}")
    profile_run(torch, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope),
                f"one seq2seq training step (batch {S2S_B})", smi)
    return launches


def rnn_programs_phase(torch):
    """The GRU and sequence-softmax programs, card against CPU, with K9
    and K7 launched: per SGD step once per padded step (K9) or once (K7)
    in the forward op and again in its generic grad's recompute.  Each
    runs one batch three times, so the comparison sees the updates."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.lod import bucket_len
    from paddle_tpu_torch.models.rnn import gru_net, seq_softmax_net
    from paddle_tpu_torch.ops import rnn_kernels as rk
    from paddle_tpu_torch.ops import sequence_kernels as sk

    phase("GRU and sequence-softmax programs, card vs CPU")
    rng = np.random.RandomState(SEED + 5)
    launches = {"gru": 0, "softmax": 0}
    words = {"words": [rng.randint(0, S2S_FULL["dict_size"], (n,))
                       for n in rng.randint(10, 51, S2S_B)]}
    t_words = bucket_len(max(len(w) for w in words["words"]))
    for mode in (False, True):
        main, startup, loss = rnn_program(
            fluid, gru_net, fluid.optimizer.SGD(learning_rate=GRU_LR),
            dict_size=S2S_FULL["dict_size"], hidden=S2S_FULL["hidden"],
            origin_mode=mode)
        got = card_vs_cpu(fluid, main, startup, loss, [words] * 3,
                          f"embedding -> fc -> dynamic_gru(512) origin_mode"
                          f" {mode}", [rk.fused_gru_output], MIN_MOVE)
        n = got["fused_gru_output"]
        if n != 2 * 3 * t_words:
            raise SystemExit(f"gru_output launched {n} times, expected "
                             f"{2 * 3 * t_words}")
        launches["gru"] += n
    for label, lens in (("T 128", np.full(S2S_B, 128)),
                        ("ragged lengths 1-50", rng.randint(1, 51, S2S_B))):
        feed = {"x": [rng.standard_normal((n, 64)).astype(np.float32)
                      for n in lens]}
        main, startup, loss = rnn_program(
            fluid, seq_softmax_net, fluid.optimizer.SGD(learning_rate=0.5),
            width=64)
        got = card_vs_cpu(fluid, main, startup, loss, [feed] * 3,
                          f"fc(1) -> sequence_softmax, {label}",
                          [sk.masked_softmax], MIN_MOVE)
        n = got["masked_softmax"]
        if n != 2 * 3:
            raise SystemExit(f"masked_softmax launched {n} times, expected "
                             f"6")
        launches["softmax"] += n
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the CTR slice: K11 and the sharded embedding engine
# ---------------------------------------------------------------------------

def path_ids(rng, vocab, shard):
    """The shard-local ids one lookup of the CTR step gathers on `shard`:
    26 x CTR_B uniform ids deduped on the host, the shard's rows in
    local index space, padded with row 0 to the power-of-two bucket."""
    from paddle_tpu_torch.sparse import RowPartition, dedup_ids, pad_bucket

    part = RowPartition(vocab, CTR_SHARDS)
    uniq, _ = dedup_ids(rng.randint(0, vocab, 26 * CTR_B))
    local = part.local_of(uniq[part.shard_of(uniq) == shard])
    idx = np.zeros(pad_bucket(len(local)), np.int64)
    idx[:len(local)] = local
    return idx


def ctr_kernel_phase(torch):
    """K11 against its plain version (index_select), bit for bit, at the
    CTR step's deep and wide lookups (the ids one shard gathers in one
    step, from a 500,000-row shard block), D = 129, a bf16 table, N = 1
    and a table whose row stride (68 bytes) is not a multiple of 16; and
    ids outside [0, V), whose rows K11 writes as zeros.  Bound: each
    gathered row read once and written once, 8 bytes an id, over
    3.35 TB/s; index_select is the plain version and the library call."""
    from paddle_tpu_torch.models.ctr import CTR_VOCAB
    from paddle_tpu_torch.sparse import gather as ga

    phase("row gather kernel vs plain (gather_rows, K11)")
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rng = np.random.RandomState(SEED + 9)
    height = CTR_VOCAB // CTR_SHARDS
    deep_ids = torch.from_numpy(path_ids(rng, CTR_VOCAB, 0)).cuda()

    def table(v, d, dtype=torch.float32):
        return torch.randn(v, d, generator=g, device="cuda").to(dtype)

    def ids(v, n):
        return torch.randint(0, v, (n,), generator=g, device="cuda")

    cases = [("deep_n65536_d16_f32", table(height, 16), deep_ids),
             ("wide_n65536_d1_f32", table(height, 1), deep_ids),
             ("d129_f32", table(20000, 129), ids(20000, 4096)),
             ("deep_d16_bf16", table(height, 16, torch.bfloat16), deep_ids),
             ("n1_d16_f32", table(height, 16), ids(height, 1)),
             ("stride68_d16_f32", table(height, 17)[:, :16], deep_ids)]
    rows = {}
    for name, t, idx in cases:
        out = ga.gather_rows(t, idx)
        ref = ga.gather_rows(t, idx, impl="plain")
        torch.cuda.synchronize()
        exact = torch.equal(out, ref)
        err = (out.float() - ref.float()).abs().max().item()
        n, d, s = idx.numel(), t.shape[1], t.element_size()
        row = {"max_abs_err": err, **bound_row(2 * n * d * s + 8 * n, 0)}
        if name.startswith(("deep_n", "wide_n")):
            row.update(
                ms=time_ms(torch, lambda: ga.gather_rows(t, idx)),
                plain_ms=time_ms(torch, lambda: ga.gather_rows_reference(
                    t, idx)),
                library_ms=time_ms(torch, lambda: torch.index_select(
                    t, 0, idx)))
            times = (f" kernel {row['ms']:.6f} ms plain {row['plain_ms']:.6f}"
                     f" ms index_select {row['library_ms']:.6f} ms")
        else:
            times = ""
        rows[name] = row
        print(f"gather_rows {name}: table {tuple(t.shape)} stride "
              f"{t.stride(0) * s} B {str(t.dtype)[6:]} N {n}: equal bit for "
              f"bit {exact} (max_abs_err {err:.3e}){times} bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']})", flush=True)
        if not exact:
            raise SystemExit(f"gather_rows disagrees with its plain version "
                             f"on {name}: {err}")
    t = table(1000, 16)
    bad = torch.tensor([3, -1, 1000, 999, 10 ** 12], device="cuda")
    out = ga.gather_rows(t, bad)
    want = torch.zeros_like(out)
    want[[0, 3]] = t[[3, 999]]
    torch.cuda.synchronize()
    print(f"gather_rows ids outside [0, V): their rows zero, the others "
          f"equal: {torch.equal(out, want)}")
    if not torch.equal(out, want):
        raise SystemExit("gather_rows read or wrote wrong rows for ids "
                         "outside the table")
    return rows


def ctr_program(fluid):
    """(main, startup, loss) of the CTR model at bench.py's full width."""
    from paddle_tpu_torch.models.ctr import CTR_DIM, CTR_VOCAB, ctr_dnn

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        loss = ctr_dnn(fluid, CTR_VOCAB, CTR_DIM)
    return main, startup, loss


def ctr_cluster(fluid, sparse, place, tables=None):
    """Declare both CTR tables over CTR_SHARDS shard servers on `place`:
    every server started on 127.0.0.1 (OS-assigned ports), shard 0 also
    bound in-process (the colocated rank: no RPC); with `tables`
    ({name: dense [vocab, D] array}) the shards are loaded from them.
    Returns the servers."""
    from paddle_tpu_torch.models.ctr import (CTR_DIM, CTR_VOCAB,
                                             DEEP_TABLE, WIDE_TABLE)

    sparse.clear_tables()
    cfgs = {name: sparse.declare_sharded_table(
        name, CTR_VOCAB, dim, ["127.0.0.1:0"] * CTR_SHARDS,
        optimizer="sgd", learning_rate=1e-3, seed=SEED, init_scale=scale)
        for name, dim, scale in ((DEEP_TABLE, CTR_DIM, 0.01),
                                 (WIDE_TABLE, 1, 0.0))}
    servers = []
    try:
        for i in range(CTR_SHARDS):
            servers.append(sparse.SparseShardServer(
                "127.0.0.1:0", i, cfgs, device_table=True,
                place=place).start())
        for name, cfg in cfgs.items():
            cfg.endpoints = [s.endpoint for s in servers]
            sparse.bind_local_server(name, 0, servers[0])
            if tables is not None:
                sparse.load_table(servers, name, tables[name])
    except BaseException:
        for s in servers:
            s.shutdown()
        raise
    return servers


def mirrors_equal(torch, servers):
    """Whether every shard's device mirror equals its host block, bit for
    bit (True where no lookup built one)."""
    return all(torch.equal(dev.cpu(), torch.from_numpy(s.values[name]))
               for s in servers for name, dev in s._dev.items())


def ctr_parity_phase(torch):
    """The full CTR config, 2 shards as on the main path, 3 SGD steps on
    the card against 3 on the CPU (CPU executor and CPU mirrors) from one
    state: the original startup program run once on the CPU, its dense
    parameters through io.state_from_numpy, its tables shard by shard
    through sparse.load_table."""
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.sparse as sparse
    from paddle_tpu_torch.models.ctr import CTR_VOCAB, ctr_batch

    phase(f"CTR parity: vocab {CTR_VOCAB}, 26 slots, 400-400-400, batch "
          f"{CTR_B}, {CTR_SHARDS} shards, card vs CPU")
    main, startup, loss = ctr_program(fluid)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = {n: t.numpy() for n, t in init.vars.items() if t is not None}
    rng = np.random.RandomState(SEED + 10)
    feeds = [ctr_batch(rng, CTR_B, CTR_VOCAB)
             for _ in range(CTR_PARITY_STEPS)]
    losses = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        servers = ctr_cluster(fluid, sparse, place, state)
        try:
            tp, _ = sparse.shard_program(main, startup)
            tables = set(tp._sparse_tables)
            scope = fluid.io.state_from_numpy(
                {n: v for n, v in state.items() if n not in tables},
                scope=fluid.Scope(), place=place, main_program=tp)
            exe = fluid.Executor(place)
            sparse.gather_rows.launches = 0
            losses.append([float(exe.run(tp, feed=f, fetch_list=[loss],
                                         scope=scope)[0]) for f in feeds])
            exe.close()
            launches = sparse.gather_rows.launches
            same = mirrors_equal(torch, servers)
        finally:
            for s in servers:
                s.shutdown()
        on_card = isinstance(place, fluid.CUDAPlace)
        want = 2 * CTR_SHARDS * CTR_PARITY_STEPS if on_card else 0
        print(f"{'card' if on_card else 'CPU'}: losses {losses[-1]}, "
              f"gather_rows launches {launches} (expected {want}), mirrors "
              f"equal to the host blocks {same}", flush=True)
        if launches != want or not same:
            raise SystemExit(f"CTR parity run on {place!r}: {launches} "
                             f"gather_rows launches, mirrors equal {same}")
    card, cpu = losses
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    print(f"CTR card vs CPU relative differences {rel} (bounds "
          f"{PARITY_RTOL[1]:g} at step 1, {PARITY_RTOL[3]:g} at step 3)")
    if not np.isfinite(card + cpu).all() or rel[0] > PARITY_RTOL[1] \
            or max(rel) > PARITY_RTOL[3]:
        raise SystemExit(f"CTR: the card departs from the CPU: {rel}")
    torch.cuda.empty_cache()


def ctr_training_phase(torch, smi):
    """The CTR model trained on the card through the sharded engine, as
    its users run it: declare_sharded_table -> SparseShardServer(
    device_table=True) -> shard_program -> Executor(CUDAPlace(0)).run(
    trainer_startup) -> exe.run(trainer_prog) per batch.  The main path
    of this slice."""
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.sparse as sparse
    from paddle_tpu_torch.models.ctr import CTR_VOCAB, ctr_batch

    phase(f"training CTR: vocab {CTR_VOCAB} x 16 and x 1, 26 slots, "
          f"400-400-400, batch {CTR_B}, {CTR_SHARDS} shards, SGD 1e-3, "
          f"{CTR_STEPS} steps")
    main, startup, loss = ctr_program(fluid)
    t0 = time.perf_counter()
    servers = ctr_cluster(fluid, sparse, fluid.CUDAPlace(0))
    try:
        tp, ts = sparse.shard_program(main, startup)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        exe.run(ts, scope=scope)
        n_params = sum(int(np.prod(p.shape)) for p in tp.all_parameters())
        print(f"CTR: trainer program {len(tp.global_block().ops)} ops, "
              f"{n_params} dense parameters on the trainer; servers and "
              f"trainer startup in {time.perf_counter() - t0:.3f} s")
        rng = np.random.RandomState(SEED + 11)
        feeds = [ctr_batch(rng, CTR_B, CTR_VOCAB) for _ in range(CTR_STEPS)]
        torch.cuda.synchronize()
        sparse.METRICS.reset()
        sparse.gather_rows.launches = 0
        losses, walls = [], []
        for f in feeds:
            t0 = time.perf_counter()
            (value,) = exe.run(tp, feed=f, fetch_list=[loss], scope=scope)
            walls.append(time.perf_counter() - t0)
            losses.append(float(value))
        launches = sparse.gather_rows.launches
        exe.close()                   # every push applied
        same = mirrors_equal(torch, servers)
        snap = sparse.METRICS.snapshot()
        want = 2 * CTR_SHARDS * CTR_STEPS
        step_s = statistics.median(walls[1:])
        c = snap["counters"]
        print(f"losses {losses}")
        print(f"gather_rows launches {launches} (expected {want}: 2 tables "
              f"x {CTR_SHARDS} shards per step); after the run every "
              f"shard's device mirror equals its host block bit for bit: "
              f"{same} ({c['push_rows']} rows pushed)")
        print(f"[{smi}] step {step_s * 1e3:.6f} ms (median of steps 2-"
              f"{CTR_STEPS}; first step {walls[0] * 1e3:.6f} ms), "
              f"{CTR_B / step_s:.3f} examples/s, {26 * CTR_B / step_s:.3f} "
              f"ids/s per table; dedup ratio {snap['dedup_ratio']}, padding "
              f"waste {snap['padding_waste']}, lookup ms "
              f"{snap['lookup_ms']}, push ms {snap['push_ms']}", flush=True)
        if not np.isfinite(losses).all():
            raise SystemExit(f"CTR losses are not finite: {losses}")
        if launches != want:
            raise SystemExit(f"gather_rows launches {launches}, expected "
                             f"{want}")
        if not same:
            raise SystemExit("a device mirror departs from its host block")
        profile_run(torch, lambda: exe.run(tp, feed=feeds[0],
                                           fetch_list=[loss], scope=scope),
                    f"one CTR training step (batch {CTR_B})", smi)
        exe.close()
    finally:
        for s in servers:
            s.shutdown()
    torch.cuda.empty_cache()
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        print("chip_smoke: run from a checkout (paddle_tpu_torch/ must sit "
              "beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    t_start = time.perf_counter()
    smi = device_phase(torch)
    build_phase()
    kernel_phase(torch)
    train_rows = train_kernel_phase(torch)
    quant_rows = quant_kernel_phase(torch)
    fp32 = serving_phase(torch, smi)
    quant = quant_serving_phase(torch, smi, fp32)
    rnn_rows = rnn_kernel_phase(torch)
    training_parity_phase(torch)
    launches = training_phase(torch, smi)
    seq2seq_parity_phase(torch)
    launches["lstm"] = seq2seq_training_phase(torch, smi)
    launches.update(rnn_programs_phase(torch))
    gather_rows = ctr_kernel_phase(torch)
    ctr_parity_phase(torch)
    launches["gather"] = ctr_training_phase(torch, smi)

    phase("report")
    print(f"flash_attention_fwd launches: serving {fp32['launches']['fwd']},"
          f" int8 serving {quant['launches']['fwd']}, training "
          f"{launches['fwd']}")
    per_batch = quant["launches"]["quant"] / quant["batches"]
    print(f"quant_matmul launches: int8 serving {quant['launches']['quant']}"
          f" over {quant['batches']} batches ({per_batch:g} per batch)")
    print(f"lstm_cell launches: seq2seq training {launches['lstm']} over "
          f"{S2S_STEPS} steps; gru_output: GRU programs {launches['gru']}; "
          f"masked_softmax: sequence-softmax programs "
          f"{launches['softmax']}")
    print(f"gather_rows launches: CTR training {launches['gather']} over "
          f"{CTR_STEPS} steps")
    # the main paths' shapes: BERT-base training, fp32, dropout 0.1; and
    # the int8 serving batch's q/k/v/out projection (4 of 6 per layer)
    kernels = [dict(KERNELS[k], launches=launches[k],
                    **train_rows[k]["bert_row_f32_drop"])
               for k in ("fwd", "dkv", "dq")]
    kernels.append(dict(KERNELS["quant"],
                        launches=quant["launches"]["quant"],
                        launches_per_batch=per_batch,
                        **quant_rows["qkv_out_m1024"]))
    # the RNN slice's shapes: the seq2seq encoder step, the GRU program's
    # step, the sequence-softmax program at T = 128
    for k, case in (("lstm", "seq2seq_b16_d512"), ("gru", "gru_b16_d512"),
                    ("softmax", "b16_t128")):
        kernels.append(dict(KERNELS[k], launches=launches[k],
                            **rnn_rows[k][case]))
    # the CTR slice's deep-table lookup on one shard
    kernels.append(dict(KERNELS["gather"], launches=launches["gather"],
                        **gather_rows["deep_n65536_d16_f32"]))
    print(f"total {time.perf_counter() - t_start:.3f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
