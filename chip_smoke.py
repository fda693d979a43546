#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py segments   # the build and segments_phase alone
    python3 chip_smoke.py compiled   # ... serving and compiled_step_phase

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
   the dropout keep rate and the bits' determinism per seed.  First the
   built libraries' SASS: every instantiation of K1, K2a and K2b (fp32
   and bf16 at each width the C entries dispatch over, 32, 64, 128,
   256) must hold tensor-core products (HMMA) and asynchronous copies
   (LDGSTS), and K1 and the fp32 K2a, K2b at width 64 no register spills
   (LDL/STL).  At the BERT shape K2a/K2b's fp32 grads
   and K1's fp32 out and lse are also held against the plain versions
   computed in float64 (GRAD64_FACTOR times the fp32 plain version's own
   error), and K2a + K2b + attention_delta is timed beside the library's
   backward there and at NMT's T 64 bucket.  Then K1, K2a and K2b at head
   dims 8, 16, 80 and 256 (and 33 fp32, 100 bf16, which the wrapper pads
   to whole 16-byte chunks) and, in their wide arm, 257, 320 and 512
   (fp32 and bf16 with dropout, a full and a row bias's grad) against
   their plain versions, each timed beside its plain version and SDPA.
5. int8 kernel vs plain: first K6's SASS (integer warpgroup MMA, IGMMA,
   and TMA loads, UTMALDG, no spills); then K6
   (quant_matmul) at the int8 serving path's shapes (M = 1024 with (K,
   N) in {(768, 768), (768, 3072), (3072, 768)}, ragged M, the pooler's
   M = 8, the logits head's N = 2, and a shape ragged in M, K and N)
   against its plain version, which must agree bit for bit with the
   weight K-major (the serving layout) and row-major; times on the
   serving layout beside the row-major weight's, the plain version's
   and torch._int_mm + scale, and the host's time a call.
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
   profile of one quantized batch with K6's share of its device busy.
8. training parity: BERT-base width with 2 layers, batch 8, seq 128,
   Adam, from one startup state, 3 steps on the card against 3 steps on
   the CPU, with dropout 0 and with dropout 0.1 (the same Philox masks
   on both devices); then the reference zoo's transformer (d_key 8) and
   bert_pretrain (hidden 32 over 2 heads: D 16), built with the port's
   model builders, 3 Adam steps card vs CPU with K1/K2 launched.
9. training: BERT-base pretraining (12 layers, dropout 0.1, batch 32,
   seq 128, 20 masked positions per sequence, Adam 1e-4, random weights
   from a seed) for 6 steps on the card through Executor.run: finite
   losses with the last below the first, the kernels' launch counts per
   step, step time, tokens/s, peak memory, and a profile of one step.
10. RNN and sequence kernels vs plain: first the SASS of K8 and K9
   (tensor-core products, HMMA, and asynchronous copies, LDGSTS, in each
   instantiation; no spills).  K8 (lstm_step: one LSTM time step, the
   product on the tensor cores, the cell and the length mask in its
   epilogue) at the seq2seq encoder's B = 16, D = 512 and at edge shapes,
   and with the lstm op's peepholes at the machine-translation encoder's
   B = 16, D = 32 and at D = 129 (no library call takes peepholes),
   K9 (gru_step: the GRU step after its addmm) at (16, 512) in both modes
   on the gru op's strided operands and at an edge shape, their cell
   entries (the same kernels with no product and no mask), K7
   (masked_softmax) at [16, 128], at ragged lengths with an empty row and
   at T = 1000: outputs and the backward's grads against the plain
   versions (atol 1e-5); kernel, plain and library times
   (_thnn_fused_lstm_cell, _thnn_fused_gru_cell, _masked_softmax; for the
   steps torch.addmm + the fused cell), and for the steps the step as the
   scan ran it before (product, add, cell kernel, mask ops) and the
   host's time a call.  Then the lstm and gru ops over whole scans (B 16,
   T 64, D 512, lengths 10-50, forward and reverse) against the same ops
   on the plain steps (outputs and grads, atol 1e-5) and against float64
   (GRAD64_FACTOR), and one scan's device launches: the step kernel once
   a step.
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
   update moving the loss, with K9 and K7 launched; a profile of one GRU
   step on the card.
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
17. fused dropout kernel vs plain: K10 (fused_dropout) against its plain
   version, bit for bit, Out and input-grad, at BERT-base's and NMT's
   dropout shapes and a ragged one, both implementations, p 0.1 and 0.5,
   fp32 and bf16; the keep rate within 4 sigma; kernel, plain and
   F.dropout times; then K1, K2a and K2b against their plain versions at
   NMT's attention shapes (T 16, 32, 64 at 4096 tokens, full bias).
18. NMT parity: bench.py's transformer NMT at width 512, 2 layers,
   vocabulary 1000, dropout 0.1 with FLAGS_use_fused_dropout (K10 on the
   card, the plain version on the CPU: the same bits), 3 Adam steps on
   the card against 3 on the CPU from one state.
19. NMT training: the same at bench.py's fp32 configuration (6 + 6
   layers, d_model 512, d_inner 2048, vocabulary 30000, label smoothing
   0.1, Adam 2e-4, 4096 tokens a batch at T 16, 32, 64), two batches a
   bucket: K10 launched twice per dropout op a step (84), K1 36 and
   K2a/K2b 18 a step, step time per bucket, target tokens/s, peak
   memory, a profile of one step.  (Phase 9 also runs one BERT step
   with the flag on: K10's 74 launches and the device busy beside the
   plain dropout's.)
20. NMT decode: the trained model's forward, cloned for test, through
   make_program_step_fn -> ContinuousBatchingEngine over the paged KV
   pool (8 slots, max_len 64, a shared system prompt, 32 requests of
   mixed budgets): greedy tokens equal lockstep_decode's, sampled
   slot-mates leave them unchanged and a seed reproduces its tokens, a
   speculative run accepts every draft, one step shape, no block held
   after the drain; tokens/s, per-token latency, the step's device-to-
   host copy.
21. paged attention kernel vs plain: K4 (float32 and bf16 arenas) and
   K5 (int8 arenas with fp32 per-token scales; up to D 256 a split-KV
   kernel of its own) against their plain versions at bench_kernels.py's
   decode shape (S 64, H 8, D 128, blocks of 16, 16 a slot, 513 in the
   arena, lengths 192-256), at the disaggregated path's own call (one
   slot, H 8, D 64, blocks of 16, 48 tokens) and at ragged and odd shapes
   (D 4, 8, 64, 100 and 320, above 256; blocks of 4 and 5; an empty slot,
   a 1-token slot, a shared block): float32 and int8 within 2e-5, bf16
   within 2e-2, empty slots exactly 0; kernel, plain and two-call
   yardstick (index_select + masked SDPA) times at the decode,
   disaggregated and D 320 shapes, K5 also cold (L2 flushed).  Then K5's
   split kernel: its SASS (asynchronous copies, LDGSTS, and no LDL/STL
   in each instantiation), the decode shape over distinct blocks (a
   permutation of 1024 blocks) and a long context (S 8, 256 blocks a
   slot, lengths 3072-4096, a 67 MB arena) timed warm and cold, the split
   edges (lengths 0, 1, 16, 17 and 256 in one batch), and one launch a
   call from the profiler's host record (no second merge kernel).
22. disaggregated decode: the trained model behind a DisaggRouter: one
   PrefillReplica whose prefill_fn runs the decode program over the
   prompt and quantizes every decoder layer's self-attention K/V
   (quantize_kv) into int8 arenas, kv_stream to two decode Replicas
   (ContinuousBatchingEngine over int8 paged pools, a KVStreamServer
   each); 8 long prompts take the split path, 8 short ones fall back;
   split tokens equal lockstep_decode's, every streamed block a prefix
   hit; K5 over the decode pools' arenas and K4 over float32 arenas of
   the same chains against the program's own attention output (0.05,
   1e-4); int8 and float32 wire bytes, per-request walls; every pool
   audited and empty after the drain.
22a. control flow: K1 at the beam decode's attention shapes ([32, 8, 32,
   64], the encoder's and the decoder's full biases) against its plain
   version; Path A, the book's machine-translation model
   (models/machine_translation.py at its published sizes: dictionary
   30000, word 16, hidden 32, beam 2, max length 8; batch 16 of the
   test's synthetic data): 3 Adam steps card vs CPU from one state (K8 in
   the encoder's dynamic_lstm twice a padded source step a step), then
   the While decode of 16 sentences card vs CPU from the card's trained
   state: equal ids (or a CPU tie under 1e-5 where they differ), scores
   within 1e-4, 8 iterations with one host synchronisation a condition
   read (torch.cuda's sync debug mode, on inside the loop), K8 once a
   padded source step, the decode's wall and device busy; Path B, the
   trained transformer-base NMT model beam-decoded by
   models/decoding.beam_search over its test program (8 sentences of 32
   tokens, beam 4, max_len 32, the position-t rows gathered on the card):
   K1 18 times a run, one captured signature from the second step on,
   log-probabilities at steps 1, 2 and the last within 1e-4 of the
   largest |value| of the CPU's on the card's own prefixes, the numpy
   bookkeeping again on the card's log-probabilities giving its ids; a
   step's wall, generated tokens/s and a run's idle share.
23. K3 vs plain: flash_attention_with_lse (K1 with lse forward, K2a and
   K2b with delta - dlse backward) at the ring's shard shape [B 4, H 12,
   T/p 512, D 64] float32, causal and not, a ragged shard of 500 rows
   and a causal 256-row shard at head dim 320 (the kernels' wide arm):
   out, lse and dq, dk, dv under a random lse cotangent against
   the plain versions (TRAIN_ATOL) and the grads against float64
   (GRAD64_FACTOR); forward and backward times beside the bound, the
   plain versions and PyTorch's memory-efficient attention, and K2a +
   K2b + attention_delta beside its backward at the shard, causal and
   not.
24. ring: ring_attention on a 4-way seq mesh whose entries are all cuda:0
   at T 2048 against full_attention on the card, causal and not: outputs
   and grads, and K3, K2a and K2b launched once per computed (shard, step)
   pair; the same at head dim 80 (T 1024); FLAGS_ring_flash=false raises
   on the card rather than run the blocked torch path.
25. sequence-parallel step: __graft_entry__._dryrun_one's dp x tp x sp x
   pp training step (embedding, sharded QKV fc, ring attention, sharded
   output fc, a 2-stage PipelineStack, Momentum) at BERT-base attention
   width (d_model 768, 12 heads, seq 2048, batch 8) through
   CompiledProgram over a data 2 x model 2 x seq 4 x pipe 2 mesh of
   cuda:0 entries: losses within 1e-5 of the single-device run on the
   card (K1) and on the CPU, K3 and K2 launch counts, step time, idle
   share; then the dry run's BERT-block-shaped config (256, 4 heads)
   against the card's single-device run.
26. LeNet-5: bench.py's bench_mnist program (simple_img_conv_pool with 6
   and 16 filters, Momentum 0.01/0.9, batch 256): 3 steps on one batch on
   the card against the CPU, each update moving the loss; then examples/s
   and step time (median of 30 steps after 5), and a profile of one step.
27. ResNet-50: bench.py's bench_resnet50 program at amp=False
   (resnet_imagenet depth 50, 1000 classes, Momentum 0.001/0.9, fp32,
   TF32 off) fed through layers.py_reader(cache_on_device=True).  Card vs
   CPU at batch 8, 224x224: each of 3 steps on the card from the CPU's
   state before it (the free-running losses and the CPU's own spread from
   a start state perturbed by 1e-7 printed beside); the is_test forward
   of __graft_entry__.entry ([8, 3, 224, 224]) over calibrated moving
   statistics on the card against the CPU.  Then batch 128 through the
   reader: images/s and step time (median of 10 steps after 3, each
   ended by a synchronisation), the bench's own throughput over the
   window, peak memory, ops and torch calls a step, the share of the
   67 TFLOP/s fp32 bound (12.27 GFLOP an image), and a profile of one
   step with its top device operations.
28. bf16 kernels at the AMP paths' shapes: K1, K2a and K2b on bf16
   operands at bench_bert's attention (batch 128, 12 heads, T 128, D 64,
   a padding row bias rounded to bf16, dropout 0.1) and at bench_nmt's
   T 64 bucket (a full bias in bf16), against their plain versions
   (TRAIN_ATOL's bf16 bars), timed beside the plain versions, SDPA and
   the bound; K10 in bf16 at BERT's hidden and FFN dropout planes and
   NMT's FFN plane, bit for bit, timed beside F.dropout.
29. AMP parity: contrib.mixed_precision.enable on both sides.  The
   2-layer BERT-base-width pretraining at dropout 0 and 0.1 (K10 on the
   card, the same bits as the CPU's plain dropout), 3 Adam steps card vs
   CPU within AMP_PARITY_RTOL, K1, K2a, K2b (and K10) launched on bf16
   operands only; ResNet-50 at batch 8, 224x224, each card step from
   the CPU's state before it within AMP_R50_RTOL of the CPU's loss, and
   each CPU step replayed on the card op by op on the CPU's inputs to
   each op (op_replay): every output within AMP_OP_RTOL of the CPU's and
   under half the distance of the same op in fp32 where precision moves
   it; the gate must refuse a planted no-op of every state update and
   the fp32 control at the convolutions' and batch norms' forward and
   backward.
30. AMP training: bench.py's bench_bert (BERT-base, batch 128, seq 128,
   Adam), bench_resnet50 (batch 128 through py_reader, Momentum) and
   bench_nmt (transformer-base, 4096 tokens at T 16, 32, 64) programs at
   amp=True, every dropout through K10: step time, tokens or images a
   second, peak memory, ops and torch calls a step, a profile of one
   step with its idle share, ResNet-50's share of the 989 TFLOP/s dense
   bf16 peak, and the launches a step of K1, K2a, K2b and K10, all on
   bf16 operands, equal to the fp32 paths' (BERT-base 24, 12, 12, 74;
   NMT 36, 18, 18, 84).
31. AMP serving: the serving phase's BERT-base model dir through
   AnalysisConfig.enable_bf16() -> ServingEngine: K1 12 times a batch on
   bf16 operands, the answers within the JAX package's bf16 bar (rtol
   0.05, atol 0.02) of the card's fp32 answers and of a CPU bf16
   Predictor's on the same batches; latency, requests/s and a profile of
   one batch.
31a. compiled step: Executor.run's CUDA-graph capture of BERT-base, NMT
   and ResNet-50 training and of serving, against the uncaptured
   _CompiledBlock(use_graph=False), and the random kernels keyed by the
   device step word against the host key.
31b. sequence labelling: K8's activation arms (the semantic-role
   labeller's sigmoid gates, sigmoid cell and relu candidate, and an
   identity arm) at B 10, D 128 with peepholes against the plain step
   (outputs and grads, atol 1e-5), timed beside the launch floor, and the
   lstm op over a T 64 scan in that arm, forward and reverse, against the
   plain steps; the book's semantic-role labeller at its published sizes
   (models/label_semantic_roles.py: conll05's dictionaries, hidden 512,
   depth 8, batch 10, lengths 5-60, the frozen pretrained emb made from
   the seed): 3 Adam steps card vs CPU from one state (PARITY_RTOL), K8
   launched twice a padded step a layer, emb unchanged; crf_decoding on
   one emission tensor on the card and the CPU (equal paths) and the
   decode program card vs CPU; captured against uncaptured steps bit for
   bit, compile_count, a step's wall, busy and idle share; the book's
   recommender at its published sizes (models/recommender_system.py,
   batch 256): 3 SGD steps card vs CPU and a step's numbers; warpctc at
   B 32, T 64, C 96 (the loss and the Logits' grad within 1e-5 of the
   CPU's) and ctc_greedy_decoder (equal ids); top_k over [32, 30000]
   tie-heavy rows, card and CPU indices equal; the phase's seconds and
   peak memory.
31c. front end: BERT-base pretraining (12 layers, batch 32, seq 128,
   dropout 0.1 through K10, Adam 1e-4) under LARK/BERT's
   GradientClipByGlobalNorm(1.0): one op-by-op step fetching the global
   norm and every grad before and after the clip (the norm within 1e-5
   of torch.linalg.vector_norm over the grads, each clipped grad within
   1e-6 of grad / max(norm, 1)), then captured against the uncaptured
   block from one state (losses bit for bit, K1/K2a/K2b/K10 launched 24,
   12, 12, 74 a step); ResNet-50 fp32 at batch 128 under
   LarsMomentum(0.1, 0.9) captured against uncaptured; the step ms, idle
   share and peak of each beside the unclipped BERT-base and Momentum
   ResNet-50 of 31a; then the op sweep: each of the 85 op types this
   slice ported (the 77 the front end emitted without a kernel, the 8
   optimizer ops) on the card and the CPU from the same seeded inputs at
   a model's shape, its outputs and generic grad within its bar.
32. report: a "kernels" JSON line (K1, K2a, K2b and K10 with bf16_* keys
   at the AMP shapes beside their fp32 main-path numbers, and the
   clipped BERT-base step's launches as clip_bert_launches; K1 with
   beam_decode_* and K8 with mt_* keys for the control-flow paths; K8
   with srl_* keys for the semantic-role labeller and the slice's CTC
   loss as ctc_* keys), then the result line {"ok": true, "device":
   {...}} last.

Exits non-zero when no CUDA device is visible, and when the port's
package is not beside this script.
"""

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np

SEED = 1234
# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
# "tf32x3": fp32 products on the tensor cores in the 3xTF32 scheme (K1,
# K2a, K2b): three TF32 products for each, so a third of the 495 TFLOP/s
# dense TF32 peak of the same data sheet
PEAK_FLOPS = {"float32": 67e12, "tf32x3": 495e12 / 3, "bfloat16": 989e12,
              "int8": 1979e12}
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
# the flash-attention kernels' precision: their fp32 dq, dk, dv (and K1's
# out and lse) against a float64 answer computed on the card from the same
# inputs must be within GRAD64_FACTOR times the error of the fp32 plain
# version against that answer, or within GRAD64_FLOOR of the answer's
# largest magnitude.  The
# factor allows for another summation order and the tensor cores'
# truncating sums; 3xTF32 keeps fp32's accuracy, while one TF32 product a
# term (~1e-3 relative) is some 500 times worse and fails
GRAD64_FACTOR, GRAD64_FLOOR = 10.0, 1e-6
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
# K8 and K9 take whole time steps: a step at index RNN_STEP of an input of
# RNN_STEP_T steps; whole scans at T RNN_SCAN_T (the seq2seq encoder's
# bucket) against the plain scan
RNN_STEP_T, RNN_STEP = 8, 3
RNN_SCAN_T = 64
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
    "lstm": {"name": "lstm_step", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/rnn_cells.cu",
             "replaces": "paddle_tpu/ops/pallas_kernels.py:1194"},
    "gru": {"name": "gru_step", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/rnn_cells.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels.py:1267"},
    "softmax": {"name": "masked_softmax", "route": "cuda",
                "source": "paddle_tpu_torch/csrc/masked_softmax.cu",
                "replaces": "paddle_tpu/ops/pallas_kernels.py:1340"},
    "gather": {"name": "gather_rows", "route": "cuda",
               "source": "paddle_tpu_torch/csrc/gather_rows.cu",
               "replaces": "paddle_tpu/sparse/gather.py:54"},
    "dropout": {"name": "fused_dropout", "route": "cuda",
                "source": "paddle_tpu_torch/csrc/fused_dropout.cu",
                "replaces": "paddle_tpu/ops/pallas_kernels.py:1405"},
    "paged": {"name": "paged_attention", "route": "cuda",
              "source": "paddle_tpu_torch/csrc/paged_attention.cu",
              "replaces": "paddle_tpu/ops/pallas_kernels.py:958"},
    "paged_quant": {"name": "paged_attention_quant", "route": "cuda",
                    "source": "paddle_tpu_torch/csrc/paged_attention.cu",
                    "replaces": "paddle_tpu/ops/quant_kernels.py:257"},
    # K3: K1 with lse forward (flash_attention_fwd.cu); its backward is
    # K2a + K2b with delta - dlse (flash_attention_bwd.cu)
    "k3": {"name": "flash_attention_with_lse", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
           "bwd_source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
           "replaces": "paddle_tpu/ops/pallas_kernels.py:883"},
}
# the CTR slice: bench.py's CTR configuration (bench.py:268-316, Paddle's
# CTR DNN on Criteo): 26 categorical slots through one shared deep table
# of 1,000,000 x 16 and a wide table of width 1, 13 dense features, a
# 400-400-400 MLP, SGD 1e-3, batch 4096, ids uniform over the vocabulary;
# both tables row-sharded over 2 shard servers (shard 0 colocated, shard 1
# over RPC on 127.0.0.1), each gathering through K11 on the card
CTR_B, CTR_SHARDS, CTR_STEPS, CTR_PARITY_STEPS = 4096, 2, 6, 3
# the NMT slice: bench.py's transformer-base NMT configuration at fp32
# (bench.py:190-265, bench_nmt(amp=False); BASELINE.json's "Transformer
# NMT"): 6 + 6 layers, 8 heads, d_model 512, d_inner 2048, vocabulary
# 30000 on each side (no shared embeddings), label smoothing 0.1, dropout
# 0.1, Adam 2e-4, batches of 4096 tokens bucketed to T = 16, 32, 64 with
# lengths in (T/2, T]; FLAGS_use_fused_dropout on, so each of its 42
# dropout ops runs K10.  Its card-vs-CPU parity at 2 layers, vocabulary
# 1000, 512 tokens a batch
NMT = dict(vocab=30000, n_layer=6, n_head=8, d_model=512, d_inner=2048)
NMT_BUCKETS, NMT_TOKENS, NMT_BATCHES_PER_BUCKET = (16, 32, 64), 4096, 2
NMT_PARITY = dict(NMT, vocab=1000, n_layer=2)
# the control-flow slice.  Path A: the book's machine-translation model
# (Fluid 1.3 tests/book/test_machine_translation.py) at its published
# sizes, models/machine_translation.py's BOOK (dictionary 30000, word 16,
# hidden = decoder 32, beam 2, max length 8), a batch of 16 sentences of
# the test's synthetic data: 3 Adam steps card vs CPU (PARITY_RTOL), then
# one While decode of 16 new sentences, card vs CPU from the card's
# trained state; ids equal, scores within MT_SCORE_RTOL, or a differing
# id where the CPU's K-th and (K+1)-th candidates lie within MT_TIE_GAP.
# Path B: the NMT cell's transformer-base decoded by
# models/decoding.beam_search over nmt_program's test program from the
# trained state: 8 source sentences of 32 tokens, beam 4, max_len 32, the
# prefix fed padded to 32 so every step is one feed signature; the card's
# next-token log-probabilities at 3 steps within BEAM_ATOL of the largest
# |value| of the CPU's on the card's own prefixes
MT_B, MT_STEPS = 16, 3
MT_SCORE_RTOL, MT_TIE_GAP = 1e-4, 1e-5
BEAM_B, BEAM_K, BEAM_SRC, BEAM_LEN, BEAM_BOS, BEAM_EOS = 8, 4, 32, 32, 0, 1
BEAM_ATOL = 1e-4
# K10 at the dropout shapes of BERT-base training ([32, 128] x hidden and
# x intermediate), of NMT's buckets ([4096 / T, T] x d_model or d_inner)
# and a ragged one; the kernels line reports the NMT FFN's [128, 32, 2048]
DROPOUT_SHAPES = [("bert_b32_t128_d768", (32, 128, 768)),
                  ("bert_b32_t128_d3072", (32, 128, 3072)),
                  ("nmt_b256_t16_d512", (256, 16, 512)),
                  ("nmt_b128_t32_d2048", (128, 32, 2048)),
                  ("nmt_b64_t64_d512", (64, 64, 512)),
                  ("ragged_3x5x7", (3, 5, 7))]
# decode serving of the trained NMT model (bench.py:613-720's pattern at
# transformer-base width): 8 slots, max_len 64, source length 32, a shared
# 5-token system prompt (bos + 4), eos never produced (eos_id -1), groups
# of one long and seven short budgets
DEC_SLOTS, DEC_LEN, DEC_SRC, DEC_GROUPS = 8, 64, 32, 4
DEC_LONG, DEC_SHORT, DEC_SYS = 24, 3, [0, 3, 4, 5, 6]
# the disaggregated tier over the same model: blocks of 16, prompts taking
# the split path at 16 tokens and more; 8 long prompts of whole blocks (bos
# included) and 8 short ones, greedy budgets of 8-24 (prompt + budget
# within max_len 64); int8 K/V within 0.05 of the program's attention (the
# JAX package's int8 bar, tests/test_paged_kv.py:652), float32 within 1e-4
DISAGG_BLOCK, DISAGG_THRESHOLD, DISAGG_BLOCKS = 16, 16, 96
DISAGG_LONG = [32, 48, 32, 48, 32, 48, 32, 48]
DISAGG_LONG_BUDGETS = [24, 8, 16, 12, 20, 15, 8, 10]
DISAGG_SHORT = [3, 4, 5, 3, 4, 5, 3, 4]
DISAGG_SHORT_BUDGETS = [8, 24, 12, 16, 20, 10, 14, 18]
DISAGG_INT8_ATOL, DISAGG_FP32_ATOL = 0.05, 1e-4
# every request's deadline: the whole replay arrives at once, so the last
# request waits for the others' steps (the "high" class default is 5 s).
# It also bounds the wait for the prefill leg (the router's default is
# 30 s): the eight long prompts queue at one serial prefill worker, and on
# a loaded host the last of them waited past 30 s and fell back to
# co-located decode, which this phase counts as a failure
DISAGG_DEADLINE_MS = 300000


# paged decode attention (K4, K5): bench_kernels.py's decode shape (S 64
# slots, H 8, D 128, blocks of 16, 16 blocks a slot, an arena of 513 blocks,
# lengths in [192, 256], random tables), then ragged and odd shapes: (name,
# S, H, D, Bs, MB, N, lengths; shared: slot 1 starts with slot 0's block)
PAGED_BENCH = ("bench_s64_h8_d128", 64, 8, 128, 16, 16, 513, None)
# the disaggregated path's own call: one slot of an NMT decode pool (H 8,
# D 64, blocks of 16, max_len 64: 4 a slot, 96 in the arena) at a long
# prompt's 48 tokens; and head dims above 256 (column groups of 256)
PAGED_DISAGG = ("disagg_s1_h8_d64_bs16", 1, 8, 64, 16, 4, 96, [48])
PAGED_WIDE = ("d320_bs16_wide", 8, 4, 320, 16, 4, 40,
              [48, 1, 0, 33, 64, 17, 16, 2])
PAGED_TIMED = (PAGED_BENCH, PAGED_DISAGG, PAGED_WIDE)
PAGED_CASES = [PAGED_BENCH, PAGED_DISAGG,
               ("d4_bs4_empty_1tok", 3, 2, 4, 4, 3, 7, [5, 0, 1]),
               ("d8_bs4_ragged", 4, 3, 8, 4, 5, 11, [17, 1, 0, 20]),
               ("d64_bs16_nmt", 8, 8, 64, 16, 4, 40,
                [48, 1, 0, 33, 64, 17, 16, 2]),
               ("d100_bs5_odd", 3, 5, 100, 5, 4, 13, [19, 20, 0]),
               PAGED_WIDE]
# K5's split-KV kernel (int8 arenas only): the decode shape over distinct
# blocks (a permutation of blocks 1..S*MB, as a pool gives each slot its
# own; the 16.8 MB arena of PAGED_BENCH's 513 blocks sits in the 50 MB L2),
# a long context with few slots (lengths 3072-4096; a 67 MB arena), and the
# split edges: lengths 0, 1, one block, one block and a token, and MB * Bs
# in one batch (16 splits of one block each: trailing splits empty)
PAGED_DISTINCT = ("bench_distinct_n1025", 64, 8, 128, 16, 16, 1025, None)
PAGED_LONG = ("long_s8_mb256_n2049", 8, 8, 128, 16, 256, 2049, None)
PAGED_EDGES = ("split_edges_s5", 5, 8, 128, 16, 16, 81,
               [0, 1, 16, 17, 256])
PAGED_SPLIT_CASES = [PAGED_DISTINCT, PAGED_LONG, PAGED_EDGES]
# tables that are a permutation of blocks 1..S*MB (N = S * MB + 1)
PAGED_PERMUTED = {PAGED_DISTINCT[0], PAGED_LONG[0]}
# kernel against its plain version on the same tensors: float32 and the
# int8 arm (both dequantized in float32), bf16 (the output rounded to bf16)
PAGED_ATOL = {"float32": 2e-5, "int8": 2e-5, "bfloat16": 2e-2}
# paged_attention_quant calls under the profiler in k5_launch_check
K5_PROFILED_CALLS = 8
# the sequence-parallel slice (__graft_entry__.py:132-219, _dryrun_one):
# K3 at the ring's shard shape [B 4, H 12, T/p 512, D 64] float32 (the
# step's batch 8 cut over data 2), causal
# (the ring's diagonal step) and not, and a ragged shard of 500 rows; the
# ring on a 4-way seq mesh at T 2048 against full attention; the
# dp x tp x sp x pp training step at BERT-base attention width (d_model
# 768, 12 heads, D 64, seq 512 x sp, batch 4 x dp, 4 microbatches) over a
# data 2 x model 2 x seq 4 x pipe 2 mesh whose 32 entries are all cuda:0,
# against its single-device run on the card and on the CPU, and the dry
# run's own BERT-block-shaped config (256, 4 heads).  The losses are held
# at 1e-5 relative, not the dry run's 1e-3: a ring that drops a past shard
# or leaks the diagonal's future moves the loss by less than 1e-3 at the
# BERT-block-shaped config (tests/test_torch_parallel.py::
# test_dryrun_loss_bar_catches_a_broken_ring), and both sides do the same
# dense math
SP_SHARD = (4, 12, 512, 64)
SP_RAGGED_T = 500
# K3 in the kernels' wide arm: a causal shard of 256 rows at head dim 320
SP_WIDE = (256, 320)
# K1 and K2 at head dims off BERT's 64: the reference zoo's transformer
# (d_key 8) and BERT (16), a D 80 model, the largest the kernels take
# (256); and two that are not whole 16-byte chunks (fp32 33, bf16 100)
HEAD_DIMS = (8, 16, 80, 256)
HEAD_DIMS_PADDED = ((33, "float32"), (100, "bfloat16"))
# head dims above 256, which the reference takes and the kernels' wide arm
# runs (column groups of 256 over a grid axis): the first (257, padded to
# a whole 16-byte chunk), two groups, one of them part-filled (320), and
# two whole groups (512)
HEAD_DIMS_WIDE = (257, 320, 512)
SP_RING = dict(b=4, t=2048, h=12, d=64, seq=4)
# a ring at a head dim off the BERT widths (the zoo's and users' models
# are not all D 64): it must run on the card and equal full attention
SP_RING_D80 = dict(b=1, t=1024, h=4, d=80)
SP_MESH = {"data": 2, "model": 2, "seq": 4, "pipe": 2}
SP_CONFIGS = [("BERT-base attention width", 768, 12, 4, True),
              ("BERT-block-shaped", 256, 4, 4, False)]
SP_PARITY_STEPS, SP_TIMED_STEPS, SP_LOSS_RTOL = 2, 4, 1e-5
# bytes written between launches timed cold: above the H100's 50 MB L2
L2_FLUSH_BYTES = 96 << 20
# the dense image slice: bench.py's bench_mnist (LeNet-5) and
# bench_resnet50 (amp=False); ResNet-50's training FLOPs an image
# (bench.py:94-97: 3 x 4.09 GFLOP forward) against the fp32 peak
LENET_B, LENET_WARMUP, LENET_ITERS = 256, 5, 30
R50_PARITY_B, R50_B, R50_WARMUP, R50_ITERS = 8, 128, 3, 10
R50_HW = 224
R50_FLOP_PER_IMAGE = 12.27e9
# ResNet-50's forced card steps: each leaf's change within LEAF_GAP
# (2-norm) of the CPU's change of it.  On the H100 in fp32 the worst leaf
# sat at 2.5e-2 to 3.1e-2 (median 1.2e-2 to 2.3e-2) over resnet50_parity's
# two batches of three steps; with TF32 on, at 0.75 to 0.85 (median 0.37
# to 0.60)
LEAF_GAP = 0.1
# bf16 AMP (contrib.mixed_precision.enable, as bench.py's headline benches
# call it at amp=True, and AnalysisConfig.enable_bf16): bench_bert's
# BERT-base pretraining at batch 128 (16,384 tokens; 19 masked slots a
# sequence, int(128 * 0.15)), bench_resnet50's ResNet-50 at batch 128 and
# bench_nmt's transformer-base at 4096 tokens a batch, all with every
# dropout through K10.  Their card-vs-CPU bars, set from a first run of
# these checks on the H100 (PERF.md §6): both sides round the same
# operands to bf16, but the card's K1 rounds the softmax weights to bf16
# for the PV product and cuBLAS and the CPU sum in other orders, so each
# step differs by bf16 rounding, which Adam's normalised steps carry on
AMP_BERT_B, AMP_BERT_M = 128, 19
AMP_WARMUP, AMP_STEPS = 2, 5
# (2-layer BERT-base width over three runs: 1.5e-5 to 2.8e-4 at step 1,
# 9.4e-5 to 1.44e-3 at steps 2 and 3)
AMP_PARITY_RTOL = {1: 1e-3, 3: 5e-3}
# ResNet-50's AMP step at batch 8, 224x224, card against CPU, held op by
# op (op_replay, op_gate): every op of a CPU AMP step runs again on the
# card on that op's own inputs.  Each float output (for an output that
# updates its input in place, a parameter, velocity or moving statistic,
# its change) sits within AMP_OP_RTOL of the CPU's (2-norm, relative);
# where the same op in fp32 on the card, the control, lands
# AMP_OP_MATERIAL or more from the CPU's, under half the control's
# distance, and elsewhere within AMP_OP_MATERIAL: the op computes the
# same at either precision.  A whole card step cannot be held so: at
# batch 8 most leaves' one-step changes under bf16 are rounding, card
# and CPU alike (PERF.md §6).  Each card step's loss (the Executor's,
# from the CPU's state before it) sat 1.7e-4 to 5.5e-3 from the CPU's
AMP_OP_RTOL, AMP_OP_MATERIAL = 1e-2, 1e-4
# A max pool's grad routes each window's gradient to one of its maxima,
# and bf16 inputs tie often (8 bits of mantissa): the card and the CPU
# break the ties apart, both right, so that grad is held to AMP_OP_RTOL
# only (ResNet-50's stem pool sat at 1.35e-3, 0.55 of its control's)
AMP_OP_TIED = {"pool2d_grad[max]"}
AMP_R50_RTOL = 1e-2
AMP_PARITY_STEPS = 2
# the JAX package's bar for a bf16 Predictor against fp32
# (tests/test_predictor.py::test_predictor_bf16_config)
AMP_SERVE_RTOL, AMP_SERVE_ATOL = 0.05, 0.02
# the sequence-labelling slice.  The book's semantic-role labeller at its
# published sizes (models/label_semantic_roles.py BOOK: conll05's
# dictionaries, word_dim 32, hidden 512 so LSTM cells of 128, depth 8,
# batch 10; Adam under exponential_decay) on SEED's synthetic batches,
# lengths in [5, 60] padded to the batch's bucket; K8 at its step shape
# (B 10, D 128, peepholes) in the SRL's arm (sigmoid gates, sigmoid cell,
# relu candidate) and an identity arm against the plain step; decode
# paths card vs CPU equal, or the CPU's scores of the two paths within
# SRL_TIE_GAP (relative) of each other.  The recommender at its published
# sizes (models/recommender_system.py BOOK), batch 256, SGD 0.2.  warpctc
# and ctc_greedy_decoder at an OCR-like shape: 32 lines of 64 frames over
# 96 classes, labels of up to 16 (CTC_RTOL: the loss relative, the
# Logits' grad |k - p| <= CTC_RTOL * (1 + |p|)).  top_k over [32, 30000]
# rows of four values each
SRL_B, SRL_LENS, SRL_STEPS, SRL_D = 10, (5, 61), 3, 128
SRL_ARMS = (("srl_b10_d128_peep", ("sigmoid", "sigmoid", "relu")),
            ("identity_b10_d128_peep", ("sigmoid", "identity", "identity")))
SRL_TIE_GAP = 1e-4
SRL_TIMED_STEPS = 3
REC_B, REC_STEPS = 256, 3
CTC_B, CTC_T, CTC_C, CTC_L = 32, 64, 96, 16
CTC_RTOL = 1e-5
TIES_SHAPE, TIES_K = (32, 30000), 50


# the script's start (main), which each phase's heading counts from
T_START = [None]


def phase(name):
    at = "" if T_START[0] is None else \
        f" (at {time.perf_counter() - T_START[0]:.1f} s)"
    print(f"== {name}{at}", flush=True)


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


def time_ms(torch, fn, reps=50, before=None):
    """Median of `reps` CUDA-event timings of fn() after a warm-up.  A
    spin kernel keeps the card busy while the host enqueues every call,
    so each event pair brackets device time, not Python launch time; the
    spin lasts at least twice the measured enqueue time of all the calls
    (at a 2 GHz clock, more than the card's).  `before`, where given,
    runs ahead of each call outside its event pair (the cold timings
    flush L2 with it: l2_flush)."""
    def one():
        if before is not None:
            before()
        fn()

    for _ in range(5):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(max(1e8, 2e9 * 2 * reps * enqueue_s)))
    for a, b in events:
        if before is not None:
            before()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def launch_floor_ms(torch):
    """The launch floor: a one-element Tensor.zero_ timed by time_ms,
    the least a single kernel launch shows between CUDA events."""
    z = torch.zeros(1, device="cuda")
    return time_ms(torch, z.zero_)


def l2_flush(torch):
    """A callable that writes L2_FLUSH_BYTES of device memory, more than
    the H100's 50 MB L2: run before a launch, it leaves the launch's
    inputs in device memory, as a caller that ran other work finds them."""
    buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    return buf.zero_


def wall_ms(torch, fn, reps=50):
    """Median host wall of `reps` calls of fn() after 5 warm-up calls,
    each ended by a synchronisation of the card (fn's own, or added)."""
    walls = []
    for i in range(5 + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= 5:
            walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


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


def attention_bound_row(nbytes, flops, dtype):
    """bound_row of an attention kernel on inputs of `dtype`: fp32 runs
    on the tensor cores in 3xTF32 (K1, K2a, K2b), so its bound takes the
    "tf32x3" rate, with the CUDA-core bound (the fp32 rate) beside it as
    "cuda_core_bound_ms" and "cuda_core_bound_by"."""
    if dtype != "float32":
        return bound_row(nbytes, flops, dtype)
    cc = bound_row(nbytes, flops)
    return dict(bound_row(nbytes, flops, "tf32x3"),
                cuda_core_bound_ms=cc["bound_ms"],
                cuda_core_bound_by=cc["bound_by"])


def attention_bound_ms(q, k, bias, causal):
    """Least time of K1 on an H100 SXM: bytes moved (q, k, v, bias read
    once, out written once) over the memory rate, against the operations
    the unmasked (q, k) pairs need over the peak rate of the input type;
    fp32 runs on the tensor cores in 3xTF32, so its bound takes the
    "tf32x3" rate, with the CUDA-core bound (the fp32 rate) beside it.
    {"bound_ms", "bound_by"[, "cuda_core_bound_ms",
    "cuda_core_bound_by"]}."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    if bias is not None:
        nbytes += bias.element_size() * bias.numel()
    pairs = sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk
    flops = 4 * b * h * d * pairs
    return attention_bound_row(nbytes, flops,
                               str(q.dtype).replace("torch.", ""))


def sdpa_mask(torch, q, k, bias, causal):
    """(attn_mask, is_causal) for SDPA, the yardstick: it takes no mask
    together with is_causal, so a causal mask is folded into the bias."""
    mask = None if bias is None else bias.to(q.dtype)
    if not (causal and mask is not None):
        return mask, causal
    keep = torch.ones(q.shape[2], k.shape[2], dtype=torch.bool,
                      device="cuda").tril()
    return mask.masked_fill(~keep, float("-inf")), False


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
        mask, is_causal = sdpa_mask(torch, q, k, bias, causal)
        row = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: ak.flash_attention(
                q, k, v, bias=bias, causal=causal)),
            "plain_ms": time_ms(torch, lambda: ak.flash_attention_reference(
                q, k, v, bias, causal, scale)),
            "library_ms": time_ms(torch, lambda: sdpa(
                q, k, v, attn_mask=mask, is_causal=is_causal, scale=scale)),
        }
        row.update(attention_bound_ms(q, k, bias, causal))
        rows[name] = row
        print(f"{name}: shape {tuple(q.shape)} {dtype} max_abs_err {err:.3e}"
              f" (atol {ATOL[dtype]:g}) kernel {row['ms']:.6f} ms plain "
              f"{row['plain_ms']:.6f} ms sdpa {row['library_ms']:.6f} ms "
              f"bound {row['bound_ms']:.6f} ms ({row['bound_by']})"
              f"{cuda_core_note(row)}", flush=True)
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
        ("d128_bf16_drop", *qkv(bf16, d=128), pad_mask(), False, 0.1,
         False),
        ("masked_row_dbias_f32", *qkv(f32), masked, False, 0.0, True),
        # 64 query rows over 128 keys, causal (top-left): the last K tile
        # sees no query, every row sees a padded key
        ("causal_tq64_tk128_row_dbias_f32", qkv(f32, t=64)[0],
         *qkv(f32)[1:], pad_mask(), True, 0.1, True),
    ]


def train_bounds_ms(q, k, bias, causal, dbias):
    """Least time on an H100 SXM of K1 (with lse), K2a and K2b: each
    input read once and each output written once over the memory rate,
    against the products the unmasked (q, k) pairs need (4, 8 and 6
    FLOP per pair and head dim) over the peak rate of the input type.
    All three run fp32 on the tensor cores (3xTF32), so on fp32 inputs
    their own bound takes the "tf32x3" rate, with the CUDA-core bound
    (the fp32 rate) beside it.  {kernel: {"bound_ms", "bound_by"[,
    "cuda_core_bound_ms", "cuda_core_bound_by"]}}."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    es = q.element_size()
    nq, nk = es * q.numel(), es * k.numel()
    rows = 4 * b * h * tq                       # one fp32 lse or delta
    nbias = 0 if bias is None else 4 * bias.numel()
    ndbias = 0 if not dbias else 4 * (
        b * tk if bias.shape[1] == bias.shape[2] == 1 else b * h * tq * tk)
    pairs = sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk
    dtype = str(q.dtype).replace("torch.", "")
    work = {"fwd": (2 * nq + 2 * nk + nbias + rows, 4),
            "dkv": (2 * nq + 4 * nk + nbias + 2 * rows, 8),
            "dq": (3 * nq + 2 * nk + nbias + 2 * rows + ndbias, 6)}
    return {kern: attention_bound_row(nbytes, per_pair * b * h * d * pairs,
                                      dtype)
            for kern, (nbytes, per_pair) in work.items()}


def cuda_core_note(row):
    return (f"; CUDA-core bound {row['cuda_core_bound_ms']:.6f} ms "
            f"({row['cuda_core_bound_by']})" if "cuda_core_bound_ms" in row
            else "")


def max_err(torch, got, want):
    """Max |got - want|; -inf entries (lse of a fully masked row) must sit
    at the same places in both."""
    got, want = got.float(), want.float()
    inf = torch.isinf(want)
    if not torch.equal(inf, torch.isinf(got)):
        return float("inf")
    return (got - want).abs()[~inf].max().item()


# SASS instructions counted by sass_counts (beside the warpgroup MMAs)
SASS_OPS = ("HMMA", "LDGSTS", "UTMALDG", "LDL", "STL")


def sass_counts(source):
    """{kernel function: counts} of a built library's SASS (cuobjdump):
    its instructions, how many of them are each op of SASS_OPS, and the
    warpgroup MMAs ("GMMA" counts every form, "gmma" names the forms)."""
    from paddle_tpu_torch.ops import cuda_build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    cuda_build.load(source)
    sass = subprocess.run([tool, "-sass", cuda_build.lib_path(source)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(
                SASS_OPS + ("GMMA", "instructions"), 0)
            counts[name]["gmma"] = set()
        elif name is not None:
            c = counts[name]
            c["instructions"] += bool(re.search(r"/\*[0-9a-f]{4,}\*/", line))
            g = re.search(r"\b([A-Z]+GMMA)\b", line)
            if g:
                c["GMMA"] += 1
                c["gmma"].add(g.group(1))
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    c[op] += 1
    return counts


def sass_check():
    """The flash-attention kernels as built: K1, K2a and K2b must each be
    instantiated at exactly the widths the C entries dispatch over
    (``HeadWidths`` of csrc/flash_attention_mma.cuh) in fp32 and bf16;
    every instantiation must hold tensor-core products (HMMA) and
    asynchronous copies (LDGSTS, or UTMALDG for TMA); and at width 64
    (BERT's, NMT's and the ring's head dim) K1 and the fp32 K2a and K2b,
    the main paths' kernels, no local-memory traffic (LDL, STL: register
    spills).  Prints the counts of each; raises SystemExit when one is
    missing."""
    from paddle_tpu_torch.ops import attention_kernels as ak

    want = {(w, dt) for w in ak.kernel_widths()
            for dt in ("float32", "bfloat16")}
    bad = []
    for source, kernels in (
            ("flash_attention_fwd", ("flash_fwd_kernel",)),
            ("flash_attention_bwd", ("flash_bwd_dkv_kernel",
                                     "flash_bwd_dq_kernel"))):
        counts = sass_counts(source)
        for kern in kernels:
            found = set()
            for n, c in sorted(counts.items()):
                if kern not in n:
                    continue
                m = re.search(r"ILi(\d+)E(f|13__nv_bfloat16)E", n)
                inst = (int(m.group(1)),
                        "float32" if m.group(2) == "f" else "bfloat16") \
                    if m else (None, n)
                found.add(inst)
                print(f"  SASS {kern} W {inst[0]} {inst[1]}: "
                      f"{c['instructions']} instructions, " +
                      " ".join(f"{op} {c[op]}" for op in SASS_OPS))
                if not c["HMMA"] or not (c["LDGSTS"] or c["UTMALDG"]):
                    bad.append(n)
                main_path = inst[0] == 64 and (
                    kern == "flash_fwd_kernel" or inst[1] == "float32")
                if main_path and (c["LDL"] or c["STL"]):
                    bad.append(f"{n}: spills")
            if found != want:
                bad.append(f"{kern}: instantiations {sorted(found, key=str)}"
                           f", not {sorted(want)}")
    if bad:
        raise SystemExit(f"flash-attention kernels without tensor-core "
                         f"products or asynchronous copies, spilling, or "
                         f"not at the dispatched widths: {bad}")


def k6_sass_check():
    """K6 as built: its kernel must run the integer warpgroup MMA
    (IGMMA: wgmma.mma_async .s32.s8.s8) fed by TMA loads (UTMALDG), with
    no local-memory traffic (LDL, STL: register spills)."""
    bad, seen = [], 0
    for n, c in sorted(sass_counts("quant_matmul").items()):
        if "quant_matmul_kernel" not in n:
            continue
        seen += 1
        print(f"  SASS {n}: GMMA {c['GMMA']} {sorted(c['gmma'])} "
              f"UTMALDG {c['UTMALDG']} LDL {c['LDL']} STL {c['STL']}")
        if "IGMMA" not in c["gmma"] or not c["UTMALDG"] or c["LDL"] \
                or c["STL"]:
            bad.append(n)
    if not seen or bad:
        raise SystemExit(f"quant_matmul kernels without integer warpgroup "
                         f"MMA or TMA loads, or spilling: {bad or 'none'}")


def float64_bar(torch, got, plain, exact):
    """(printed parts, failures) of outputs `got` (name -> tensor) held
    against their float64 answers `exact` beside the fp32 plain
    versions' errors `plain`: within GRAD64_FACTOR times the plain
    error or GRAD64_FLOOR of the answer's largest magnitude; entries
    that are -inf in the answer (lse of a masked row) must be -inf in
    both."""
    parts, bad = [], {}
    for n in got:
        ex = exact[n]
        fin = torch.isfinite(ex)
        errs = []
        for x in (got[n], plain[n]):
            same_inf = torch.equal(torch.isinf(x) & ~fin, ~fin)
            errs.append((x.double() - ex)[fin].abs().max().item()
                        if same_inf else float("inf"))
        e_k, e_p = errs
        bar = max(GRAD64_FACTOR * e_p,
                  GRAD64_FLOOR * ex[fin].abs().max().item())
        ratio = e_k / e_p if e_p else float("inf")
        parts.append(f"{n} kernel {e_k:.3e} plain {e_p:.3e} "
                     f"(x{ratio:.3f}) bar {bar:.3e}")
        if not e_k <= bar:
            bad[n] = (e_k, bar)
    return parts, bad


def grad64_check(torch, ak, name, bwd, got):
    """The backward kernels' fp32 (dq, dk, dv) `got` from the inputs `bwd`
    (q, k, v, bias, dout, lse, delta, causal, scale, p, seed) against the
    plain version computed in float64 on the card from the same inputs,
    beside the fp32 plain version's own error (float64_bar)."""
    tensors, rest = bwd[:7], bwd[7:]
    plain = ak._backward_plain(*bwd)[:3]
    exact = ak._backward_plain(
        *[None if x is None else x.double() for x in tensors], *rest,
        dtype=torch.float64)[:3]
    names = ("dq", "dk", "dv")
    parts, bad = float64_bar(torch, dict(zip(names, got)),
                             dict(zip(names, plain)),
                             dict(zip(names, exact)))
    print("  against float64: " + "; ".join(parts), flush=True)
    if bad:
        raise SystemExit(f"backward kernels miss the float64 precision bar "
                         f"on {name}: {bad}")


def fwd64_check(torch, ak, name, args, out, lse):
    """K1's fp32 out and lse from the forward inputs `args` (q, k, v,
    bias, causal, scale, p, seed) against the plain forward computed in
    float64 on the card from the same inputs (the same dropout bits),
    beside the fp32 plain version's own error (float64_bar)."""
    plain = ak.flash_attention_reference(*args, return_lse=True)
    exact = ak.flash_attention_reference(
        *[None if x is None else x.double() for x in args[:4]], *args[4:],
        return_lse=True, dtype=torch.float64)
    names = ("out", "lse")
    parts, bad = float64_bar(torch, dict(zip(names, (out, lse))),
                             dict(zip(names, plain)),
                             dict(zip(names, exact)))
    print("  forward against float64: " + "; ".join(parts), flush=True)
    if bad:
        raise SystemExit(f"flash_attention_fwd misses the float64 precision"
                         f" bar on {name}: {bad}")


def backward_vs_library(torch, ak, label, fwd_args, dout, out, lse, lib_bwd,
                        dlse=None):
    """One line: K2a + K2b + attention_delta (delta - dlse under an lse
    cotangent) against one library backward call on the same inputs."""
    q, k, v, bias, causal, scale, p, seed = fwd_args

    def ours():
        delta = ak.attention_delta(dout, out)
        if dlse is not None:
            delta = delta - dlse
        args = (q, k, v, bias, dout, lse, delta, causal, scale, p, seed)
        ak.flash_attention_bwd_dkv(*args)
        ak.flash_attention_bwd_dq(*args)

    ms, lib_ms = time_ms(torch, ours), time_ms(torch, lib_bwd)
    print(f"  backward vs library at {label}: K2a + K2b + attention_delta "
          f"{ms:.6f} ms, library backward {lib_ms:.6f} ms ({ms / lib_ms:.3f}"
          f"x: {'no slower' if ms <= lib_ms else 'slower'})", flush=True)


def nmt_backward_vs_library(torch, ak):
    """backward_vs_library at NMT's T 64 bucket: [64, 8, 64, 64] fp32, the
    decoder self-attention's full causal-and-padding bias, dropout 0.1
    (nmt_kernel_phase's case), against SDPA's backward; K2a's and K2b's
    own times beside their bounds."""
    from paddle_tpu_torch.models.transformer import make_attn_biases

    t = 64
    b, h, d = NMT_TOKENS // t, NMT["n_head"], NMT["d_model"] // NMT["n_head"]
    i = NMT_BUCKETS.index(t)
    lens = np.random.RandomState(SEED + i).randint(t // 2 + 1, t + 1, b)
    bias = torch.from_numpy(make_attn_biases(lens, lens, h, t, t)[1]).cuda()
    g = torch.Generator(device="cuda").manual_seed(SEED + 50 + i)
    q, k, v, dout = (torch.randn(b, h, t, d, generator=g, device="cuda")
                     for _ in range(4))
    args = (q, k, v, bias, False, d ** -0.5, 0.1, SEED + 50 + i)
    out, lse = ak.flash_attention_fwd(*args, with_lse=True)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=bias, dropout_p=0.1, scale=d ** -0.5)
    backward_vs_library(
        torch, ak, f"NMT T {t} {tuple(q.shape)} full bias dropout 0.1",
        args, dout, out, lse, lambda: torch.autograd.grad(
            lib_out, leaves, dout, retain_graph=True))
    delta = ak.attention_delta(dout, out)
    bwd = (q, k, v, bias, dout, lse, delta, *args[4:])
    bounds = train_bounds_ms(q, k, bias, False, False)
    for kern, fn in (("dkv", ak.flash_attention_bwd_dkv),
                     ("dq", ak.flash_attention_bwd_dq)):
        b_ = bounds[kern]
        print(f"  {KERNELS[kern]['name']}: kernel "
              f"{time_ms(torch, lambda: fn(*bwd)):.6f} ms bound "
              f"{b_['bound_ms']:.6f} ms ({b_['bound_by']}); CUDA-core bound "
              f"{b_['cuda_core_bound_ms']:.6f} ms "
              f"({b_['cuda_core_bound_by']})", flush=True)

    # the line's pieces on the device (each kernel twice in a row beside
    # the two in turn), and the host's time a pair of wrapper calls
    def pair(first, second):
        return lambda: (first(*bwd), second(*bwd))

    dkv, dq = ak.flash_attention_bwd_dkv, ak.flash_attention_bwd_dq
    pieces = {"attention_delta": lambda: ak.attention_delta(dout, out),
              "K2a then K2b": pair(dkv, dq), "K2a twice": pair(dkv, dkv),
              "K2b twice": pair(dq, dq)}
    print("  its pieces: " + ", ".join(
        f"{n} {time_ms(torch, fn):.6f} ms" for n, fn in pieces.items()) +
        f"; host {host_ms(torch, pair(dkv, dq)):.6f} ms a K2a + K2b pair of "
        f"wrapper calls", flush=True)


def host_ms(torch, fn, reps=100):
    """The median host time of one fn() call over `reps` calls, each timed
    alone, the card kept busy by a spin kernel so that no call waits on
    it (the wrappers' Python and launch cost, which host-bound steps pay
    for every call).  The median, not the mean: on a shared host a burst
    of other work slows a few calls, not the middle one."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e8))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def attention_case(torch, ak, case, seed, rows):
    """One case of train_attention_cases' form on the card: K1 with lse,
    K2a and K2b against the plain forward and backward on the same
    tensors (TRAIN_ATOL), each kernel timed beside its plain version, the
    library call and its bound (into rows[kernel][name]).  Returns what
    the case's further checks need."""
    name, q, k, v, bias, causal, p, dbias = case
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = q.shape[-1] ** -0.5
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
    fwd_mask, lib_causal = sdpa_mask(torch, q, k, bias, causal)
    mask, is_causal = fwd_mask, lib_causal
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
                             is_causal=lib_causal, dropout_p=p,
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
            **bounds[kern]}
    print(f"{name}: q {tuple(q.shape)} {dtype} dropout {p} causal "
          f"{causal} bias {None if bias is None else tuple(bias.shape)}"
          f" dbias {dbias}", flush=True)
    print("  max_abs_err " + " ".join(
        f"{e} {errs[e]:.3e} (atol {tols[e]:g})" for e in errs))
    # the sizes show the comparison is not of zeros
    print("  max |kernel| " + " ".join(
        f"{e} {t.float().abs().max().item():.3e}" for e, t in
        (("dq", dq), ("dk", dk), ("dv", dv), ("dbias", db))
        if t is not None))
    for kern, r in rows.items():
        r = r[name]
        print(f"  {KERNELS[kern]['name']}: kernel {r['ms']:.6f} ms "
              f"plain {r['plain_ms']:.6f} ms sdpa {r['library_ms']:.6f}"
              f" ms bound {r['bound_ms']:.6f} ms ({r['bound_by']})"
              f"{cuda_core_note(r)}", flush=True)
    bad = [e for e in errs if not errs[e] <= tols[e]]
    if bad:
        raise SystemExit(f"training kernels disagree with their plain "
                         f"versions on {name}: "
                         f"{ {e: errs[e] for e in bad} }")
    return {"args": args, "bwd": bwd, "out": out, "lse": lse, "dout": dout,
            "grads": (dq, dk, dv), "lib_bwd": lambda: torch.autograd.grad(
                lib_out, leaves, dout, retain_graph=True)}


def train_kernel_phase(torch):
    from paddle_tpu_torch.ops import attention_kernels as ak

    phase("training kernels vs plain (K1 with lse and dropout, K2a, K2b)")
    sass_check()
    rows = {"fwd": {}, "dkv": {}, "dq": {}}
    for i, case in enumerate(train_attention_cases(torch)):
        name, seed = case[0], SEED + i
        c = attention_case(torch, ak, case, seed, rows)
        if name in ("bert_row_f32", "bert_row_f32_drop"):
            grad64_check(torch, ak, name, c["bwd"], c["grads"])
            fwd64_check(torch, ak, name, c["args"], c["out"], c["lse"])
        if name == "bert_row_f32_drop":
            dropout_checks(torch, ak, c["args"], seed)
            backward_vs_library(
                torch, ak, f"BERT {tuple(case[1].shape)} row bias dropout "
                f"{case[6]}", c["args"], c["dout"], c["out"], c["lse"],
                c["lib_bwd"])
    nmt_backward_vs_library(torch, ak)
    return rows


def head_dim_cases(torch):
    """(name, q, k, v, bias, causal, dropout_p, dbias) on the card, made
    from SEED: K1 and K2 at the head dims of HEAD_DIMS, [B 8, H 12, T 128,
    D] with BERT's padding mask (fp32 with dropout 0.1, and bf16), and
    causal at a ragged T 200 with a full bias and its grad; then the head
    dims of HEAD_DIMS_PADDED, which the wrapper pads to whole 16-byte
    chunks with zero columns; then the wide arm's HEAD_DIMS_WIDE (fp32
    and bf16 with dropout 0.1), D 320 causal at T 200 with a full bias's
    grad and D 512 with a row bias's grad."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 90)
    b, h, t = 8, 12, 128
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def qkv(d, dtype, t=t):
        return [torch.randn(b, h, t, d, generator=g, device="cuda")
                .to(dtypes[dtype]) for _ in range(3)]

    def pad_mask(t=t):
        lens = torch.randint(t // 4, t + 1, (b,), generator=g,
                             device="cuda")
        pad = torch.arange(t, device="cuda")[None, :] >= lens[:, None]
        return (pad.float() * -10000.0).reshape(b, 1, 1, t)

    cases = []
    for d in HEAD_DIMS:
        cases += [
            (f"d{d}_row_f32_drop", *qkv(d, "float32"), pad_mask(), False,
             0.1, False),
            (f"d{d}_row_bf16", *qkv(d, "bfloat16"), pad_mask(), False, 0.0,
             False),
            (f"d{d}_causal_t200_full_dbias_f32", *qkv(d, "float32", 200),
             torch.randn(b, h, 200, 200, generator=g, device="cuda") * 0.5,
             True, 0.0, True)]
    for d, dtype in HEAD_DIMS_PADDED:
        cases.append((f"d{d}_row_{dtype}_drop", *qkv(d, dtype), pad_mask(),
                      False, 0.1, False))
    for d in HEAD_DIMS_WIDE:
        cases += [
            (f"d{d}_row_f32_drop", *qkv(d, "float32"), pad_mask(), False,
             0.1, False),
            (f"d{d}_row_bf16_drop", *qkv(d, "bfloat16"), pad_mask(), False,
             0.1, False)]
    cases += [
        ("d320_causal_t200_full_dbias_f32", *qkv(320, "float32", 200),
         torch.randn(b, h, 200, 200, generator=g, device="cuda") * 0.5,
         True, 0.0, True),
        ("d512_row_dbias_f32_drop", *qkv(512, "float32"),
         torch.randn(b, 1, 1, t, generator=g, device="cuda") * 0.5, False,
         0.1, True)]
    return cases


def head_dim_phase(torch):
    """K1, K2a and K2b at head dims off BERT's 64 against their plain
    versions (TRAIN_ATOL), each timed beside its plain version and SDPA;
    the launch counts show the kernels ran."""
    from paddle_tpu_torch.ops import attention_kernels as ak

    phase(f"K1, K2a, K2b vs plain at head dims {HEAD_DIMS}, (padded) "
          f"{[d for d, _ in HEAD_DIMS_PADDED]} and (wide arm) "
          f"{HEAD_DIMS_WIDE}")
    rows = {"fwd": {}, "dkv": {}, "dq": {}}
    counters = (ak.flash_attention, ak.flash_attention_bwd_dkv,
                ak.flash_attention_bwd_dq)
    for i, case in enumerate(head_dim_cases(torch)):
        for c in counters:
            c.launches = 0
        attention_case(torch, ak, case, SEED + 100 + i, rows)
        if not all(c.launches for c in counters):
            raise SystemExit(f"{case[0]}: a kernel did not launch: "
                             f"{[c.launches for c in counters]}")
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
    """K6 against its plain version, which must give the same bits, with
    the weight in the serving layout (K-major, as apply_to_scope stores
    it) and row-major (the wrapper lays it out each call); times on the
    serving layout beside the plain version and _int_mm + scale.  First
    the SASS (k6_sass_check)."""
    from paddle_tpu_torch.ops import quant_kernels as qk

    phase("int8 kernel vs plain (quant_matmul)")
    k6_sass_check()
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = {}
    for name, m, k, n in QUANT_CASES:
        xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                           dtype=torch.int8)
        wk = qk.k_major(wq)           # the serving layout, same values
        cs = torch.rand(n, generator=g, device="cuda") * 1e-4 + 1e-6
        ref = qk.int8_matmul_reference(xq, wq, cs)
        outs = {"k_major": qk.int8_matmul(xq, wk, cs),
                "row_major": qk.int8_matmul(xq, wq, cs)}
        torch.cuda.synchronize()
        errs = {lay: (o - ref).abs().max().item() for lay, o in outs.items()}
        err = max(errs.values())
        lib = int8_library(torch, xq, wq)
        nbytes = m * k + k * n + 4 * n + 4 * m * n
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = 2 * m * k * n / PEAK_FLOPS["int8"] * 1e3
        row = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: qk.int8_matmul(xq, wk, cs)),
            "plain_ms": time_ms(torch, lambda: qk.int8_matmul_reference(
                xq, wk, cs)),
            "library_ms": None if lib is None else time_ms(
                torch, lambda: lib().float() * cs),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "row_major_ms": time_ms(torch, lambda: qk.int8_matmul(
                xq, wq, cs))}
        rows[name] = row
        host = row["host_ms"] = host_ms(torch,
                                        lambda: qk.int8_matmul(xq, wk, cs))
        lib_txt = "refused" if lib is None else \
            f"{row['library_ms']:.6f} ms"
        print(f"{name}: M {m} K {k} N {n} max_abs_err K-major "
              f"{errs['k_major']:.3e}, row-major {errs['row_major']:.3e} "
              f"(must be 0; max |out| {ref.abs().max().item():.3e}) kernel "
              f"{row['ms']:.6f} ms (row-major weight, laid out each call: "
              f"{row['row_major_ms']:.6f}), host {host:.6f} ms a call; plain "
              f"{row['plain_ms']:.6f} ms _int_mm+scale {lib_txt} bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']})",
              flush=True)
        if err != 0.0:
            raise SystemExit(f"quant_matmul disagrees with its plain version "
                             f"on {name}: {errs}")
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


class interpreted:
    """Within it, `pred`'s executor runs its programs op by op: a check
    that swaps a kernel's Python wrapper, or records what the wrapper is
    handed, needs the wrappers called, and a captured CUDA graph's replay
    calls none."""

    def __init__(self, pred):
        self.exe = pred._exe

    def __enter__(self):
        self.exe._captured = lambda program: False

    def __exit__(self, *exc):
        del self.exe._captured


def code_flips(qk, card_pred, cpu_pred, feed):
    """The int8 activation codes of every quantized matmul of one batch,
    on the card (op by op) and on the CPU: how many differ, per
    matmul."""
    codes, quantize = [], qk.quantize_activation

    def recording(x):
        xq, xs = quantize(x)
        codes.append(xq.cpu())
        return xq, xs

    qk.quantize_activation = recording
    try:
        with interpreted(card_pred):
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
    # deterministic sequence of kernels, so the answers must be equal.
    # The engine's batch replayed its captured graph; the plain version
    # runs op by op (a replay would not call the swapped wrapper)
    feed, outs = executed[0]
    qk.int8_matmul = qk.int8_matmul_reference
    try:
        with interpreted(pred):
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
    prof = profile_batch(torch, pred, fp32["batch"], smi)
    k6 = [(ms, c) for name, ms, c in prof["rows"]
          if "quant_matmul_kernel" in name]
    k6_ms = sum(ms for ms, _ in k6)
    print(f"[{smi}] int8 batch device busy {prof['busy']:.6f} ms: K6 "
          f"{k6_ms:.6f} ms over {sum(c for _, c in k6)} launches, share "
          f"{k6_ms / prof['busy']:.4f}")
    run["busy_ms"], run["k6_ms"] = prof["busy"], k6_ms
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
    return profile_run(torch, lambda: pred.run(feed),
                       "one batch (Predictor.run)", smi)


def profile_run(torch, run, label, smi):
    """One run() under torch.profiler: its wall time, the device's busy
    time and idle share, and the kernels that fill it.  Returns {"wall",
    "busy" (ms), "rows" [(device kernel, ms, count)], "calls" (torch
    operator calls)}."""
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
    calls = sum(r[2] for r in host)
    print(f"  host: {calls} torch operator calls, "
          f"{sum(r[1] for r in host):.6f} ms of self CPU time; top: " +
          ", ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in host[:6]))
    return {"wall": prof_wall, "busy": busy, "rows": rows, "calls": calls}


def pretrain_program(fluid, num_layers, dropout, clip=None):
    """BERT-base-width pretraining (MLM + NSP heads) with Adam(1e-4):
    (main, startup, loss), random seeds fixed to SEED; with `clip`, the
    gradient clip set (fluid.clip.set_gradient_clip) for its minimize."""
    from paddle_tpu_torch.models.bert import BertConfig, bert_pretrain

    cfg = BertConfig(num_layers=num_layers, dropout=dropout, **BERT_BASE)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        loss, _ = bert_pretrain(cfg, TRAIN_T)
        fluid.clip.set_gradient_clip(clip)
        try:
            fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
        finally:
            fluid.clip.set_gradient_clip(None)
    return main, startup, loss


def pretrain_feed(b, t, m, seed, vocab=BERT_BASE["vocab_size"]):
    """A pretraining batch from a numpy seed: token ids, padding masks,
    two segments, `m` masked positions per sequence (absolute flattened
    indices inside each sequence's length) with their labels, NSP
    labels."""
    rng = np.random.RandomState(seed)
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


def narrow_heads_phase(torch):
    """The reference zoo's two configurations whose head dims the
    attention kernels used not to take, built with the port's own model
    builders (paddle_tpu/models/zoo.py's `transformer`: d_key = d_value
    = 8; its `bert_pretrain`: hidden 32 over 2 heads, D 16): 3 Adam steps
    on the card against 3 on the CPU from one state (PARITY_RTOL), with
    K1, K2a and K2b launched on the card."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.bert import BertConfig, bert_pretrain
    from paddle_tpu_torch.models.transformer import transformer
    from paddle_tpu_torch.ops import attention_kernels as ak

    phase("narrow heads: the zoo's transformer (d_key 8) and bert_pretrain "
          "(D 16), card vs CPU")
    counters = (ak.flash_attention, ak.flash_attention_bwd_dkv,
                ak.flash_attention_bwd_dq)

    def program(build, lr):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = SEED
        with fluid.program_guard(main, startup):
            loss = build()
            fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
        return main, startup, loss

    cfg = BertConfig(vocab_size=64, hidden_size=32, num_layers=1,
                     num_heads=2, intermediate_size=64, max_position=32,
                     type_vocab_size=2, dropout=0.1)
    runs = [
        ("transformer d_key 8",
         program(lambda: transformer(32, 32, 16, 1, 2, 8, 8, 16, 32,
                                     dropout_rate=0.1)[0], 1e-3),
         nmt_batch(np.random.RandomState(SEED + 20), 8, 32, 2,
                   tokens=16)[0]),
        ("bert_pretrain D 16",
         program(lambda: bert_pretrain(cfg, 16)[0], 1e-4),
         pretrain_feed(2, 16, 3, SEED + 21, vocab=64))]
    for label, (main, startup, loss), feed in runs:
        launches = card_vs_cpu(fluid, main, startup, loss, [feed] * 3,
                               label, counters=counters)
        if not all(launches.values()):
            raise SystemExit(f"{label}: the attention kernels did not all "
                             f"run on the card: {launches}")
    torch.cuda.empty_cache()


def training_phase(torch, smi):
    """BERT-base pretraining on the card: the main path of this slice."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import dropout_kernels as dk

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

    def one_step():
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)

    busy = {False: profile_run(
        torch, one_step, f"one training step (batch {TRAIN_B}, seq "
        f"{TRAIN_T})", smi)["busy"]}
    # the same step with every dropout through K10
    n_drop = sum(op.type == "dropout" for op in main.global_block().ops)
    fluid.set_flags({"use_fused_dropout": True})
    one_step()
    torch.cuda.synchronize()
    dk.fused_dropout.launches = 0
    one_step()
    launches["dropout_bert"] = dk.fused_dropout.launches
    busy[True] = profile_run(
        torch, one_step, f"one training step with FLAGS_use_fused_dropout "
        f"(batch {TRAIN_B}, seq {TRAIN_T})", smi)["busy"]
    fluid.set_flags({"use_fused_dropout": False})
    print(f"[{smi}] BERT-base step device busy: plain dropout "
          f"{busy[False]:.6f} ms, K10 {busy[True]:.6f} ms; K10 launches a "
          f"step {launches['dropout_bert']} ({n_drop} dropout ops, forward "
          f"and backward)")
    if launches["dropout_bert"] != 2 * n_drop:
        raise SystemExit(f"fused_dropout ran {launches['dropout_bert']} "
                         f"times in a BERT step, expected {2 * n_drop}")
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


def bound_row(nbytes, flops, peak="float32"):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def lstm_step_unfused(rk, xg, h_prev, c_prev, w, lens, step):
    """The LSTM time step as the scan ran it before K8 took the whole
    step: the product and the add, K8 on the gates alone, then the mask's
    torch ops."""
    h, c = rk.fused_lstm_cell(xg + h_prev @ w, c_prev)
    valid = rk.valid_mask(lens, step, xg.dtype)
    h = h * valid + h_prev * (1 - valid)
    c = c * valid + c_prev * (1 - valid)
    return h, c, h * valid, c * valid


def gru_step_unfused(torch, rk, xg, h_prev, w, lens, step, mode):
    """The GRU time step as the scan ran it before K9 took the candidate's
    product and the mask: two products, the gates' torch ops, K9 on the
    output gate alone, then the mask's torch ops."""
    d = h_prev.shape[1]
    ur_pre = xg[:, :2 * d] + h_prev @ w[:, :2 * d]
    _, r = torch.chunk(torch.sigmoid(ur_pre), 2, dim=-1)
    cand_pre = xg[:, 2 * d:] + (r * h_prev) @ w[:, 2 * d:]
    h = rk.fused_gru_output(ur_pre[:, :d], cand_pre, h_prev, mode)
    valid = rk.valid_mask(lens, step, xg.dtype)
    h = h * valid + h_prev * (1 - valid)
    return h, h * valid


def thnn_lstm_step(torch, xg, h_prev, c_prev, w):
    """The two-call yardstick of the LSTM time step: torch.addmm for the
    gates, then PyTorch's fused LSTM cell (no mask), the input and W
    reordered from (c, i, f, o) to its (i, f, g, o) order here, outside
    the timed call."""
    def reorder(t):
        gc, gi, gf, go = t.chunk(4, dim=-1)
        return torch.cat([gi, gf, gc, go], dim=-1).contiguous()

    xr, wr = reorder(xg), reorder(w)
    hg = torch.zeros_like(xr)
    return lambda: torch.ops.aten._thnn_fused_lstm_cell(
        torch.addmm(xr, h_prev, wr), hg, c_prev)


def thnn_gru_step(torch, xg, h_prev, w):
    """The two-call yardstick of the GRU time step: torch.addmm for the
    three gates' products at once, then PyTorch's fused GRU cell (whose
    reset gate scales the product rather than h_prev: the same work in
    another formula; no mask)."""
    xr, hg = xg.contiguous(), torch.zeros_like(xg)
    return lambda: torch.ops.aten._thnn_fused_gru_cell(
        torch.addmm(xr, h_prev, w), hg, h_prev)


def lstm_step_bound(b, d, peep=False):
    """xg, h_prev, c_prev, W (and the three peephole weights) and the
    lengths read once, the four outputs written once; the product's
    2·B·D·4D flops at 3xTF32's rate (the cell's 15 an element beside
    them, and the peepholes' 6)."""
    nbytes = 4 * (4 * b * d + 2 * b * d + 4 * d * d + 4 * b * d + b
                  + (3 * d if peep else 0))
    return bound_row(nbytes, 2 * b * d * 4 * d + (21 if peep else 15)
                     * b * d, "tf32x3")


def gru_step_bound(b, d):
    """ur_pre [B, 2D], xg_c, h_prev, W_c and the lengths read once, the
    two outputs written once; the product's 2·B·D·D flops at 3xTF32's
    rate (the gates' 13 an element beside them)."""
    nbytes = 4 * (2 * b * d + 2 * b * d + d * d + 2 * b * d + b)
    return bound_row(nbytes, 2 * b * d * d + 13 * b * d, "tf32x3")


def rnn_sass_check():
    """K8 and K9 as built: every instantiation of lstm_step_kernel and
    gru_step_kernel (16- and 4-byte staging) must hold tensor-core
    products (HMMA) and asynchronous copies (LDGSTS), with no
    local-memory traffic (LDL, STL: register spills)."""
    bad, seen = [], {"lstm_step_kernel": 0, "gru_step_kernel": 0}
    for n, c in sorted(sass_counts("rnn_cells").items()):
        kern = next((k for k in seen if k in n), None)
        if kern is None:
            continue
        seen[kern] += 1
        print(f"  SASS {n}: {c['instructions']} instructions, " +
              " ".join(f"{op} {c[op]}" for op in SASS_OPS))
        if not c["HMMA"] or not c["LDGSTS"] or c["LDL"] or c["STL"]:
            bad.append(n)
    if bad or sorted(seen.values()) != [2, 2]:
        raise SystemExit(f"rnn_cells kernels without tensor-core products "
                         f"or asynchronous copies, or spilling: {bad}; "
                         f"instantiations {seen}")


def rnn_kernel_phase(torch):
    """K8 and K9 as whole time steps, and their cell entries, and K7,
    against their plain versions at the shapes of the slice's programs and
    at edge shapes; then whole scans (rnn_scan_checks).  Each step row
    times the kernel, the plain step, the step as the scan ran it before
    (the product and the mask around the cell kernel) and the two-call
    yardstick (torch.addmm + PyTorch's fused cell), and the host's time a
    call of the first and the third.  Bounds count each input read once
    and each output written once (fp32), and the flops the function needs
    with a transcendental as one: the products at 3xTF32's rate, 15 an
    element for the LSTM cell (three sigmoids of exp, add, divide; two
    tanh; three multiplies and an add), 8 for the GRU output, 7 per valid
    element for the softmax."""
    from paddle_tpu_torch.ops import rnn_kernels as rk
    from paddle_tpu_torch.ops import sequence_kernels as sk

    phase("RNN and sequence kernels vs plain (lstm_step, gru_step and "
          "their cells, masked_softmax)")
    rnn_sass_check()
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda") * 2.0

    def step_inputs(b, d, gates):
        """x[:, RNN_STEP] of x [b, RNN_STEP_T, gates·D], h_prev in tanh's
        range, W at 1/sqrt(D), lengths with a zero and one past the
        step (all past it at B 1)."""
        x = randn(b, RNN_STEP_T, gates * d) / 2
        w = randn(d, gates * d) * (0.5 / d ** 0.5)
        lens = torch.randint(0, RNN_STEP_T + 1, (b,), generator=g,
                             device="cuda", dtype=torch.int32)
        lens[0], lens[-1] = (0, RNN_STEP_T) if b > 1 else (RNN_STEP_T,) * 2
        return x[:, RNN_STEP], torch.tanh(randn(b, d)), w, lens

    rows = {"lstm": {}, "gru": {}, "softmax": {}}

    def report(kern, name, err, fwd, plain, lib, bound, note, extra=None):
        row = {"max_abs_err": err, "ms": time_ms(torch, fwd),
               "plain_ms": time_ms(torch, plain),
               "library_ms": None if lib is None else time_ms(torch, lib),
               **bound}
        for key, fn in (extra or {}).items():
            row[key] = fn()
        rows[kern][name] = row
        lib_txt = "–" if lib is None else f"{row['library_ms']:.6f} ms"
        more = "".join(f" {k} {v:.6f}" for k, v in row.items()
                       if k not in ("max_abs_err", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by"))
        print(f"{KERNELS[kern]['name']} {name}: {note} max_abs_err "
              f"{err:.3e} (outputs and grads, atol {RNN_ATOL:g}) kernel "
              f"{row['ms']:.6f} ms plain {row['plain_ms']:.6f} ms library "
              f"{lib_txt} bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']}){more}", flush=True)
        if not err <= RNN_ATOL:
            raise SystemExit(f"{KERNELS[kern]['name']} disagrees with its "
                             f"plain version on {name}: {err}")

    # K8's whole step: the seq2seq encoder's (B 16, D 512), B 1, D not a
    # multiple of 4 (4-byte staging), and B * D not a multiple of 32; then
    # the machine-translation encoder's step with the lstm op's peepholes
    for name, b, d in (("seq2seq_b16_d512", 16, 512), ("b1_d512", 1, 512),
                       ("b16_d129", 16, 129), ("b3_d37", 3, 37)):
        xg, h, w, lens = step_inputs(b, d, 4)
        c = randn(b, d) / 2
        diff = (rk.lstm_step(xg, h, c, w, lens, RNN_STEP)[0]
                - lstm_step_unfused(rk, xg, h, c, w, lens, RNN_STEP)[0])
        print(f"  the step as the scan ran it before vs kernel: "
              f"max_abs_diff {diff.abs().max().item():.3e}")
        err = grads_err(
            torch, lambda *a: rk.lstm_step(*a, lens, RNN_STEP),
            lambda *a: rk.lstm_step_reference(*a, lens, RNN_STEP),
            (xg, h, c, w), tuple(randn(b, d) for _ in range(4)))
        step = lambda: rk.lstm_step(xg, h, c, w, lens, RNN_STEP)  # noqa
        before = lambda: lstm_step_unfused(  # noqa: E731
            rk, xg, h, c, w, lens, RNN_STEP)
        report("lstm", name, err, step,
               lambda: rk.lstm_step_reference(xg, h, c, w, lens, RNN_STEP),
               thnn_lstm_step(torch, xg, h, c, w), lstm_step_bound(b, d),
               f"step B {b} D {d}",
               {"unfused_ms": lambda: time_ms(torch, before),
                "host_ms": lambda: host_ms(torch, step),
                "unfused_host_ms": lambda: host_ms(torch, before)})

    for name, b, d in (("mt_b16_d32_peep", 16, 32),
                       ("b16_d129_peep", 16, 129)):
        xg, h, w, lens = step_inputs(b, d, 4)
        c, peep = randn(b, d) / 2, randn(3 * d) / 4
        err = grads_err(
            torch, lambda *a: rk.lstm_step(*a[:4], lens, RNN_STEP, a[4]),
            lambda *a: rk.lstm_step_reference(*a[:4], lens, RNN_STEP, a[4]),
            (xg, h, c, w, peep), tuple(randn(b, d) for _ in range(4)))
        step = lambda: rk.lstm_step(  # noqa: E731
            xg, h, c, w, lens, RNN_STEP, peep)
        # no library call takes peepholes: library_ms is null
        report("lstm", name, err, step,
               lambda: rk.lstm_step_reference(xg, h, c, w, lens, RNN_STEP,
                                              peep),
               None, lstm_step_bound(b, d, peep=True),
               f"step B {b} D {d} with peepholes",
               {"host_ms": lambda: host_ms(torch, step)})

    # K9's step after the addmm, in both modes, on the gru op's operands
    # (xg_c and W_c read in place: row strides 3D); the time step (addmm
    # + K9) timed beside; and D not a multiple of 4
    for name, b, d, mode in (("gru_b16_d512", 16, 512, False),
                             ("gru_b16_d512_origin", 16, 512, True),
                             ("gru_b5_d129", 5, 129, False)):
        xg, h, w, lens = step_inputs(b, d, 3)
        ur = rk.gru_gate_pre(xg[:, :2 * d], h, w[:, :2 * d])
        xc, wc = xg[:, 2 * d:], w[:, 2 * d:]
        diff = (rk.gru_step(ur, xc, h, wc, lens, RNN_STEP, mode)[0]
                - gru_step_unfused(torch, rk, xg, h, w, lens, RNN_STEP,
                                   mode)[0])
        print(f"  the step as the scan ran it before vs kernel: "
              f"max_abs_diff {diff.abs().max().item():.3e}")
        err = grads_err(
            torch, lambda *a: rk.gru_step(*a, lens, RNN_STEP, mode),
            lambda *a: rk.gru_step_reference(*a, lens, RNN_STEP, mode),
            (ur, xc, h, wc), (randn(b, d), randn(b, d)))
        time_step = lambda: rk.gru_step(  # noqa: E731
            rk.gru_gate_pre(xg[:, :2 * d], h, w[:, :2 * d]), xc, h, wc,
            lens, RNN_STEP, mode)
        before = lambda: gru_step_unfused(  # noqa: E731
            torch, rk, xg, h, w, lens, RNN_STEP, mode)
        report("gru", name, err,
               lambda: rk.gru_step(ur, xc, h, wc, lens, RNN_STEP, mode),
               lambda: rk.gru_step_reference(ur, xc, h, wc, lens, RNN_STEP,
                                             mode),
               thnn_gru_step(torch, xg, h, w), gru_step_bound(b, d),
               f"step B {b} D {d} origin_mode {mode}",
               {"step_ms": lambda: time_ms(torch, time_step),
                "unfused_ms": lambda: time_ms(torch, before),
                "host_ms": lambda: host_ms(torch, time_step),
                "unfused_host_ms": lambda: host_ms(torch, before)})

    # the cell entries, the same kernels with no product and no mask: K8
    # at the step shapes, K9 on gu read in place out of a [B, 2D] buffer
    # (row stride 2D) in both modes and contiguous at an edge shape
    for name, b, d in (("seq2seq_b16_d512", 16, 512), ("b1_d512", 1, 512),
                       ("b16_d129", 16, 129), ("b3_d37", 3, 37)):
        gates, c_prev = randn(b, 4 * d), randn(b, d)
        lib = thnn_lstm_cell(torch, gates, c_prev)
        diff = max((a - b).abs().max().item() for a, b in zip(
            rk.fused_lstm_cell(gates, c_prev), lib()))
        print(f"  _thnn_fused_lstm_cell vs kernel: max_abs_diff {diff:.3e}")
        err = grads_err(torch, rk.fused_lstm_cell, rk.lstm_cell_reference,
                        (gates, c_prev), (randn(b, d), randn(b, d)))
        report("lstm", f"cell_{name}", err,
               lambda: rk.fused_lstm_cell(gates, c_prev),
               lambda: rk.lstm_cell_reference(gates, c_prev), lib,
               bound_row(4 * b * d * 7, 15 * b * d), f"cell B {b} D {d}")
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
        report("gru", f"cell_{name}", err,
               lambda: rk.fused_gru_output(gu, gc, h_prev, mode),
               lambda: rk.gru_output_reference(gu, gc, h_prev, mode), lib,
               bound_row(4 * b * d * 4, 8 * b * d),
               f"cell B {b} D {d} origin_mode {mode} strided {strided}")

    # K7: the sequence-softmax program's [16, 128] and ragged lengths in
    # [1, 50] with an empty row (a warp a row up to T 64); T = 1000,
    # 1025 (4-byte loads) and 4096 (16-byte loads), a CTA a row with the
    # row in registers; T = 10000, a CTA walking the row in shared
    # memory; the last three each with an empty and a full row
    def lens(b, t, lo, edges=False):
        n = torch.randint(lo, t + 1, (b,), generator=g, device="cuda",
                          dtype=torch.int32)
        if edges:
            n[0], n[1] = 0, t
        return n

    ragged = lens(16, 50, 1)
    ragged[3] = 0
    floor = launch_floor_ms(torch)
    print(f"  launch floor (one-element Tensor.zero_): {floor:.6f} ms")
    for name, x, n in (
            ("b16_t128", randn(16, 128), torch.full(
                (16,), 128, dtype=torch.int32, device="cuda")),
            ("ragged_t50_empty_row", randn(16, 50), ragged),
            ("b16_t1000", randn(16, 1000), lens(16, 1000, 1)),
            ("b16_t1025", randn(16, 1025), lens(16, 1025, 1, True)),
            ("b8_t4096", randn(8, 4096), lens(8, 4096, 1, True)),
            ("b4_t10000", randn(4, 10000), lens(4, 10000, 1, True))):
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
               f"x {tuple(x.shape)} ({valid} valid)",
               {"launch_floor_ms": lambda: floor})
    rnn_scan_checks(torch)
    rnn_scan_launch_check(torch)
    return rows


class plain_rnn_steps:
    """Within it, the scans' step entries run their plain versions on the
    card (the scans look them up at each step)."""

    def __init__(self, rk):
        self.rk = rk

    def __enter__(self):
        rk = self.rk
        self.saved = rk.lstm_step, rk.gru_step
        rk.lstm_step = rk.lstm_step_reference
        rk.gru_step = rk.gru_step_reference

    def __exit__(self, *exc):
        self.rk.lstm_step, self.rk.gru_step = self.saved


def rnn_scan_checks(torch):
    """The lstm and gru ops over a whole scan at the seq2seq width (B 16,
    T 64, D 512, lengths 10-50), forward and reverse: outputs and the
    grads of x, W, the bias and the initial state against the same op
    with the plain steps (RNN_ATOL), and against the plain scan in
    float64 (float64_bar: within GRAD64_FACTOR times the plain fp32
    scan's error)."""
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops import rnn_kernels as rk

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    b, t, d = S2S_B, RNN_SCAN_T, S2S_FULL["hidden"]
    lens = torch.randint(S2S_LENS[0], S2S_LENS[1] + 1, (b,), generator=g,
                         device="cuda", dtype=torch.int32)
    print(f"  scans at B {b} T {t} D {d}, lengths {lens.tolist()}")

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    for kind, reverse in (("lstm", False), ("lstm", True), ("gru", False),
                          ("gru", True), ("gru_origin", False)):
        lstm = kind == "lstm"
        gates = 4 if lstm else 3
        tensors = [randn(b, t, gates * d), randn(d, gates * d,
                                                 scale=d ** -0.5),
                   randn(1, gates * d, scale=0.1),
                   torch.tanh(randn(b, d))] + ([randn(b, d, scale=0.5)]
                                               if lstm else [])
        names = ["Input", "Weight", "Bias", "H0"] + (["C0"] if lstm else [])
        attrs = {"is_reverse": reverse}
        attrs.update({"use_peepholes": False} if lstm
                     else {"origin_mode": kind == "gru_origin"})
        cots = [randn(b, t, d) for _ in range(2 if lstm else 1)]

        def ins(ts):
            return dict({n: [x] for n, x in zip(names, ts)},
                        SeqLen=[lens])

        def run(ts, cots, plain):
            leaves = [x.detach().requires_grad_() for x in ts]
            op = "lstm" if lstm else "gru"
            if plain:
                with plain_rnn_steps(rk):
                    out = registry.run_op(op, ins(leaves), dict(attrs))
            else:
                out = registry.run_op(op, ins(leaves), dict(attrs))
            outs = [out["Hidden"][0]] + ([out["Cell"][0]] if lstm else [])
            return outs + list(torch.autograd.grad(outs, leaves, cots))

        labels = ["hidden"] + (["cell"] if lstm else []) + \
            [f"d{n}" for n in names]
        got, plain = run(tensors, cots, False), run(tensors, cots, True)
        exact = run([x.double() for x in tensors],
                    [c.double() for c in cots], True)
        torch.cuda.synchronize()
        # elementwise |kernel - plain| <= RNN_ATOL * (1 + |plain|): the
        # grads sum over the scan's B·T steps (dBias ~10 at this shape),
        # where two fp32 answers differ by their own rounding
        errs = {n: ((a - p).abs().max().item(),
                    ((a - p).abs() / (1 + p.abs())).max().item(),
                    p.abs().max().item())
                for n, a, p in zip(labels, got, plain)}
        err = max(e[1] for e in errs.values())
        parts, bad = float64_bar(torch, dict(zip(labels, got)),
                                 dict(zip(labels, plain)),
                                 dict(zip(labels, exact)))
        print(f"  {kind} scan reverse {reverse}: max |kernel - plain| / (1 "
              f"+ |plain|) {err:.3e} (outputs and grads, bar "
              f"{RNN_ATOL:g}; abs err, max |plain|: " + ", ".join(
                  f"{n} {e[0]:.3e} {e[2]:.3g}" for n, e in errs.items()) +
              "); against float64: " + "; ".join(parts), flush=True)
        if not err <= RNN_ATOL or bad:
            raise SystemExit(f"{kind} scan (reverse {reverse}) departs from "
                             f"the plain scan ({err}) or misses the float64 "
                             f"bar: {bad}")



def rnn_scan_launch_check(torch):
    """One forward scan of the lstm and gru ops (B 16, T 64, D 512): the
    step kernel launched once a step (its wrapper's counter); under the
    profiler, the gru op's one torch.addmm a step and each op's one stack
    per emitted output (torch operator calls: the host's record, which
    does not depend on the device trace); the device kernels printed
    beside (a trace may drop the first events of its window, so a short
    kernel runs first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops import rnn_kernels as rk

    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    b, t, d = S2S_B, RNN_SCAN_T, S2S_FULL["hidden"]
    lens = torch.randint(S2S_LENS[0], S2S_LENS[1] + 1, (b,), generator=g,
                         device="cuda", dtype=torch.int32)
    for kind in ("lstm", "gru"):
        gates = 4 if kind == "lstm" else 3
        ins = {"Input": [torch.randn(b, t, gates * d, generator=g,
                                     device="cuda")],
               "Weight": [torch.randn(d, gates * d, generator=g,
                                      device="cuda") * d ** -0.5],
               "SeqLen": [lens]}
        attrs = {"use_peepholes": False} if kind == "lstm" else {}
        counter = rk.fused_lstm_cell if kind == "lstm" else \
            rk.fused_gru_output
        with torch.no_grad():
            registry.run_op(kind, ins, dict(attrs))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                before = counter.launches
                registry.run_op(kind, ins, dict(attrs))
                torch.cuda.synchronize()
        steps = counter.launches - before
        ops = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CPU}
        kernels = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
        addmm, stacks = ops.get("aten::addmm", 0), ops.get("aten::stack", 0)
        print(f"  {kind} op, T {t}: {kind}_step launched {steps} times, "
              f"torch.addmm {addmm}, torch.stack {stacks}; device kernels "
              f"traced: " + ", ".join(f"{k[:60]} x{c}"
                                      for k, c in kernels.items()),
              flush=True)
        want = (t, 0, 2) if kind == "lstm" else (t, t, 1)
        if (steps, addmm, stacks) != want:
            raise SystemExit(f"{kind} op over T {t}: {kind}_step "
                             f"{steps}, torch.addmm {addmm}, torch.stack "
                             f"{stacks}; expected {want}")


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


def host_state(scope):
    return {n: t.cpu().numpy() for n, t in scope.vars.items()
            if t is not None}


def card_vs_cpu(fluid, main, startup, loss, feeds, label, counters=(),
                min_move=None, smi=None, forced=False, rtol=PARITY_RTOL):
    """One startup state (run on the CPU), the losses of `feeds` on the
    card and on the CPU, held to PARITY_RTOL; `counters` are set to 0
    just before the card's run and read just after.  With `min_move`
    (the feeds are one batch repeated), the CPU's losses after step 1
    must each differ from its step-1 loss by at least that much,
    relatively: a card run that skipped the updates would repeat its
    step-1 loss and fail the comparison.  With `smi`, one more card step
    on feeds[0] runs under the profiler.  With `forced`, for a model
    whose own trajectory is chaotic (a change of its start state at the
    card's step-1 gap moves its later losses by more than the bars),
    every card step starts from the CPU's state before it and is held to
    the step-1 bar, and so is its update of every leaf
    (forced_card_vs_cpu).  `rtol` holds the unforced run's step-1 and
    step-3 bars.  Returns the card's launches."""
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = host_state(init)
    if forced:
        return forced_card_vs_cpu(fluid, main, loss, feeds, label, state,
                                  min_move)
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
            card_run = (exe, scope)
    card, cpu = losses[True], losses[False]
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    print(f"{label}: card {card} cpu {cpu} relative differences {rel} "
          f"(bounds {rtol[1]:g} at step 1, {rtol[3]:g} at "
          f"step 3)" + (f", card launches {launches}" if counters else ""),
          flush=True)
    if not np.isfinite(card + cpu).all() or rel[0] > rtol[1] \
            or max(rel) > rtol[3]:
        raise SystemExit(f"{label}: the card departs from the CPU: {rel}")
    if min_move is not None:
        moves = [abs(a - cpu[0]) / abs(cpu[0]) for a in cpu[1:]]
        print(f"  the updates move the loss from step 1 by {moves} "
              f"relative (at least {min_move:g} required)")
        if min(moves) < min_move:
            raise SystemExit(f"{label}: the updates move the loss by "
                             f"{moves}, under {min_move:g}")
    if smi is not None:
        import torch

        exe, scope = card_run
        profile_run(torch, lambda: exe.run(main, feed=feeds[0],
                                           fetch_list=[loss], scope=scope),
                    f"one step of {label}", smi)
    return launches


def leaf_gaps(before, after, ref):
    """{leaf: |after − ref| / |ref − before|} (2-norms) over the float
    leaves of `before` that `ref`'s step changed: each leaf's change over
    a step against the reference's change.  A leaf that `ref` left alone
    and `after` changed gaps by inf."""
    gaps = {}
    for n, b in before.items():
        if b.dtype.kind != "f":
            continue
        b = b.astype(np.float64)
        moved = float(np.linalg.norm(ref[n] - b))
        off = float(np.linalg.norm(after[n].astype(np.float64) - ref[n]))
        if moved > 0:
            gaps[n] = off / moved
        elif off > 0:
            gaps[n] = float("inf")
    return gaps


def gap_summary(gaps):
    worst = max(gaps, key=gaps.get)
    return (f"worst {worst} {gaps[worst]:.3e}, median "
            f"{float(np.median(list(gaps.values()))):.3e} over "
            f"{len(gaps)} leaves")


def forced_card_vs_cpu(fluid, main, loss, feeds, label, state, min_move):
    """card_vs_cpu(forced=True).  Each card step starts from the CPU's
    state before it; its loss is held to the step-1 bar, and its change of
    every leaf (parameters, optimizer accumulators, moving statistics) to
    the CPU's change of that leaf, within LEAF_GAP of it (2-norms of the
    leaf; the gradients of a chaotic model move by a share of themselves
    under rounding).  The control runs each card step again with TF32 on
    for the convolutions and matmuls: its leaves must land beyond
    LEAF_GAP, or the check could not see a lower precision."""
    import torch

    def scope_of(st, place):
        return fluid.io.state_from_numpy(st, scope=fluid.Scope(),
                                         place=place, main_program=main)

    def run(exe, scope, feed):
        return float(exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope)[0])

    def card_step(before, feed, tf32):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            scope = scope_of(before, fluid.CUDAPlace(0))
            return run(card_exe, scope, feed), host_state(scope)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    card_exe = fluid.Executor(fluid.CUDAPlace(0))
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu_scope = scope_of(state, fluid.CPUPlace())
    params = [p.name for p in main.all_parameters()]
    card, cpu, ctl, sound, control = [], [], [], [], []
    for feed in feeds:
        before = host_state(cpu_scope)
        value, card_after = card_step(before, feed, False)
        card.append(value)
        value, ctl_after = card_step(before, feed, True)
        ctl.append(value)
        cpu.append(run(cpu_exe, cpu_scope, feed))
        cpu_after = host_state(cpu_scope)
        sound.append(leaf_gaps(before, card_after, cpu_after))
        control.append(leaf_gaps(before, ctl_after, cpu_after))
        if len(card) == 1:
            # how far the card's parameters depart from the CPU's after
            # step 1: the 2-norm over all of them, relative
            drift = float(np.sqrt(
                sum(np.sum((card_after[n] - cpu_after[n]).astype(
                    np.float64) ** 2) for n in params) /
                sum(np.sum(cpu_after[n].astype(np.float64) ** 2)
                    for n in params)))
        del before, card_after, ctl_after, cpu_after

    def rel(xs):
        return [abs(a - b) / abs(b) for a, b in zip(xs, cpu)]

    print(f"{label}, each card step from the CPU's state before it: card "
          f"{card} cpu {cpu} relative differences {rel(card)} (bound "
          f"{PARITY_RTOL[1]:g} at every step)", flush=True)
    for i, (s, c) in enumerate(zip(sound, control)):
        print(f"  step {i + 1}, each leaf's change against the CPU's "
              f"(bound {LEAF_GAP:g}): {gap_summary(s)}; TF32 control "
              f"(loss {ctl[i]}, relative {rel(ctl)[i]:.3e}; must exceed "
              f"the bound): {gap_summary(c)}", flush=True)
    # the free-running card beside the CPU from a start state nudged by
    # the card's departure after step 1: how far a difference of that
    # size carries
    nudge = drift
    free_scope = scope_of(state, fluid.CUDAPlace(0))
    free = [run(card_exe, free_scope, feed) for feed in feeds]
    rng = np.random.RandomState(SEED)
    nudged = {n: (v * (1 + nudge * rng.standard_normal(v.shape))).astype(
        v.dtype) if v.dtype == np.float32 else v for n, v in state.items()}
    nudged_scope = scope_of(nudged, fluid.CPUPlace())
    spread = [run(cpu_exe, nudged_scope, feed) for feed in feeds]
    print(f"  free-running card {free}: relative {rel(free)}; the CPU from "
          f"its start state nudged by {nudge:.3e} relative (the card's "
          f"parameters after step 1 depart from the CPU's by that much, "
          f"2-norm over all of them): {spread}, relative {rel(spread)} "
          f"(not gated)",
          flush=True)
    if not np.isfinite(card + cpu).all() or \
            max(rel(card)) > PARITY_RTOL[1]:
        raise SystemExit(f"{label}: the card departs from the CPU: "
                         f"{rel(card)}")
    worst = max(max(s.values()) for s in sound)
    if not worst <= LEAF_GAP:
        raise SystemExit(f"{label}: a leaf's change on the card departs "
                         f"from the CPU's by {worst}, over {LEAF_GAP}")
    seen = min(max(c.values()) for c in control)
    if not seen > LEAF_GAP:
        raise SystemExit(f"{label}: the TF32 control stays within "
                         f"{LEAF_GAP} ({seen}): the leaf check cannot see "
                         f"a lower precision")
    if min_move is not None:
        moves = [abs(a - cpu[0]) / abs(cpu[0]) for a in cpu[1:]]
        print(f"  the updates move the loss from step 1 by {moves} "
              f"relative (at least {min_move:g} required)")
        if min(moves) < min_move:
            raise SystemExit(f"{label}: the updates move the loss by "
                             f"{moves}, under {min_move:g}")
    return {}


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
    print(f"lstm_step launches {launches} (expected {want}: 4 x {t_src} "
          f"per step)")
    print(f"[{smi}] step {step_s * 1e3:.6f} ms (median of steps 2-"
          f"{S2S_STEPS}; first step {walls[0] * 1e3:.6f} ms), "
          f"{n_trg / step_s:.3f} target tokens/s, peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise SystemExit(f"seq2seq losses are not finite and falling: "
                         f"{losses}")
    if launches != want:
        raise SystemExit(f"lstm_step launches {launches}, expected {want}")
    profile_run(torch, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope),
                f"one seq2seq training step (batch {S2S_B})", smi)
    return launches


def rnn_programs_phase(torch, smi):
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
                          f" {mode}", [rk.fused_gru_output], MIN_MOVE,
                          smi=smi if not mode else None)
        n = got["fused_gru_output"]
        if n != 2 * 3 * t_words:
            raise SystemExit(f"gru_step launched {n} times, expected "
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


def lookup_walls(torch, ids):
    """SparseShardServer.lookup_local's median wall (wall_ms) on shard 0
    of the CTR config's deep and wide tables (a 500,000-row block on the
    card each), at one step's lookup `ids`, after a first lookup checked
    against the host block bit for bit; every call one K11 launch.
    Returns {"deep": ms, "wide": ms}."""
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.sparse as sparse
    from paddle_tpu_torch.models.ctr import CTR_DIM, CTR_VOCAB

    walls = {}
    for label, dim in (("deep", CTR_DIM), ("wide", 1)):
        cfg = sparse.ShardedTableConfig(
            f"lookup_{label}", CTR_VOCAB, dim, ["127.0.0.1:0"] * CTR_SHARDS,
            seed=SEED)
        srv = sparse.SparseShardServer("127.0.0.1:0", 0, {cfg.name: cfg},
                                       device_table=True,
                                       place=fluid.CUDAPlace(0))
        got = srv.lookup_local(cfg.name, ids)
        if not np.array_equal(got, srv.values[cfg.name][ids]):
            raise SystemExit(f"lookup_local on the {label} table departs "
                             f"from the host block")
        before, calls = sparse.gather_rows.launches, [0]

        def lookup():
            calls[0] += 1
            srv.lookup_local(cfg.name, ids)

        walls[label] = wall_ms(torch, lookup)
        per_call = (sparse.gather_rows.launches - before) / calls[0]
        if per_call != 1:
            raise SystemExit(f"lookup_local launched gather_rows "
                             f"{per_call} times a call, expected 1")
        del srv
    torch.cuda.empty_cache()
    return walls


def ctr_kernel_phase(torch):
    """K11 against its plain version (index_select), bit for bit, at the
    CTR step's deep and wide lookups (the ids one shard gathers in one
    step, from a 500,000-row shard block), D = 129, a bf16 table, N = 1
    and a table whose row stride (68 bytes) is not a multiple of 16; and
    ids outside [0, V), whose rows K11 writes as zeros.  At every case
    also the host entry lookup_local runs (gather_rows_to_host: host ids
    in, numpy rows out, written by K11 into pinned host memory): equal
    bit for bit, its output pinned, one launch a call.  At the deep and
    wide lookups: the kernel's time warm and cold (L2 flushed before
    each launch), into device memory and into pinned host memory, the
    host entry's and lookup_local's walls, and the launch floor.  Bound:
    each gathered row read once and written once, 8 bytes an id, over
    3.35 TB/s; index_select is the plain version and the library call."""
    from paddle_tpu_torch.models.ctr import CTR_VOCAB
    from paddle_tpu_torch.sparse import gather as ga

    phase("row gather kernel vs plain (gather_rows, K11)")
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rng = np.random.RandomState(SEED + 9)
    height = CTR_VOCAB // CTR_SHARDS
    deep_np = path_ids(rng, CTR_VOCAB, 0)
    deep_ids = torch.from_numpy(deep_np).cuda()

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
    flush = l2_flush(torch)
    floor = launch_floor_ms(torch)
    print(f"launch floor (one-element Tensor.zero_): {floor:.6f} ms")
    rows = {}
    for name, t, idx in cases:
        out = ga.gather_rows(t, idx)
        ref = ga.gather_rows(t, idx, impl="plain")
        torch.cuda.synchronize()
        exact = bits_equal(torch, out, ref)
        err = (out.float() - ref.float()).abs().max().item()
        host_idx = idx.cpu().numpy()
        before = ga.gather_rows.launches
        # the host entry's rows as bytes, in the memory it returned
        host = torch.from_numpy(ga.gather_rows_to_host(t, host_idx).view(
            np.uint8))
        host_launches = ga.gather_rows.launches - before
        host_ok = (host.is_pinned() and host_launches == 1 and torch.equal(
            host, ref.cpu().contiguous().view(torch.uint8)))
        n, d, s = idx.numel(), t.shape[1], t.element_size()
        row = {"max_abs_err": err, **bound_row(2 * n * d * s + 8 * n, 0)}
        if name.startswith(("deep_n", "wide_n")):
            ids_pin = idx.cpu().pin_memory()
            out_pin = torch.empty(tuple(ref.shape), dtype=t.dtype,
                                  pin_memory=True)

            def kernel():
                return ga.gather_rows(t, idx)

            def pinned():
                return ga._launch(t, ids_pin, out_pin)

            row.update(
                ms=time_ms(torch, kernel),
                cold_ms=time_ms(torch, kernel, before=flush),
                pinned_ms=time_ms(torch, pinned),
                pinned_cold_ms=time_ms(torch, pinned, before=flush),
                host_entry_ms=wall_ms(
                    torch, lambda: ga.gather_rows_to_host(t, host_idx)),
                launch_floor_ms=floor,
                plain_ms=time_ms(torch, lambda: ga.gather_rows_reference(
                    t, idx)),
                library_ms=time_ms(torch, lambda: torch.index_select(
                    t, 0, idx)))
            times = (f" kernel {row['ms']:.6f} ms (cold {row['cold_ms']:.6f})"
                     f", into pinned memory {row['pinned_ms']:.6f} ms (cold "
                     f"{row['pinned_cold_ms']:.6f}), host entry wall "
                     f"{row['host_entry_ms']:.6f} ms, plain "
                     f"{row['plain_ms']:.6f} ms, index_select "
                     f"{row['library_ms']:.6f} ms")
        else:
            times = ""
        rows[name] = row
        print(f"gather_rows {name}: table {tuple(t.shape)} stride "
              f"{t.stride(0) * s} B {str(t.dtype)[6:]} N {n}: equal bit for "
              f"bit {exact} (max_abs_err {err:.3e}); host entry equal, "
              f"pinned, {host_launches} launch: {host_ok}{times} bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']})", flush=True)
        if not exact:
            raise SystemExit(f"gather_rows disagrees with its plain version "
                             f"on {name}: {err}")
        if not host_ok:
            raise SystemExit(f"gather_rows' host entry on {name}: pinned "
                             f"{host.is_pinned()}, {host_launches} launches,"
                             f" or rows unequal to the plain version's")
    t = table(1000, 16)
    bad = torch.tensor([3, -1, 1000, 999, 10 ** 12], device="cuda")
    out = ga.gather_rows(t, bad)
    host = torch.from_numpy(ga.gather_rows_to_host(t, bad.cpu().numpy()))
    want = torch.zeros_like(out)
    want[[0, 3]] = t[[3, 999]]
    torch.cuda.synchronize()
    same = torch.equal(out, want) and torch.equal(host, want.cpu())
    print(f"gather_rows ids outside [0, V): their rows zero, the others "
          f"equal, on the card and through the host entry: {same}")
    if not same:
        raise SystemExit("gather_rows read or wrote wrong rows for ids "
                         "outside the table")
    del cases, flush
    walls = lookup_walls(torch, deep_np)
    print(f"lookup_local wall (median of 50, one shard, one step's ids): "
          f"deep {walls['deep']:.6f} ms, wide {walls['wide']:.6f} ms")
    rows["deep_n65536_d16_f32"]["lookup_ms"] = walls["deep"]
    rows["wide_n65536_d1_f32"]["lookup_ms"] = walls["wide"]
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


# ---------------------------------------------------------------------------
# the NMT slice: K10, transformer-base NMT training, decode serving
# ---------------------------------------------------------------------------

def bits_equal(torch, a, b):
    """Equal bit for bit (signed zeros and NaN payloads included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return torch.equal(a.contiguous().view(view[a.dtype]),
                       b.contiguous().view(view[b.dtype]))


def nmt_kernel_phase(torch):
    """K10 against its plain version, bit for bit, Out and the input-grad
    (the backward is K10 on the cotangent), at the dropout shapes of
    BERT-base training and of NMT's three buckets and a ragged one, with
    both implementations, p 0.1 and 0.5, fp32 and bf16; the keep rate
    within 4 sigma of 1 - p; kernel, plain and F.dropout times (F.dropout
    draws other bits: a yardstick of time only) against the bound (x
    read once, out written once, over 3.35 TB/s).  Then K1, K2a and K2b
    against their plain versions at NMT's attention shapes (D 64, 8
    heads, T 16/32/64 at 4096 tokens, a full causal-and-padding bias,
    attention dropout 0.1, no bias grad)."""
    from paddle_tpu_torch.models.transformer import make_attn_biases
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import dropout_kernels as dk

    phase("fused dropout kernel vs plain (K10); K1/K2 at the NMT shapes")
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rows = {}
    for si, (name, shape) in enumerate(DROPOUT_SHAPES):
        n = int(np.prod(shape))
        checked, worst = [], 0.0
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            cot = torch.randn(shape, generator=g, device="cuda").to(dtype)
            for p in (0.1, 0.5):
                for upscale in (True, False):
                    seed = SEED + 100 * si + int(p * 10) + 2 * upscale
                    leaf = x.detach().requires_grad_()
                    out = dk.fused_dropout(leaf, p, seed, upscale)
                    (dx,) = torch.autograd.grad(out, leaf, cot)
                    ref_leaf = x.detach().requires_grad_()
                    ref = dk.fused_dropout_reference(ref_leaf, p, seed,
                                                     upscale)
                    (dref,) = torch.autograd.grad(ref, ref_leaf, cot)
                    torch.cuda.synchronize()
                    same = bits_equal(torch, out, ref) and \
                        bits_equal(torch, dx, dref)
                    errs = (max_err(torch, out, ref),
                            max_err(torch, dx, dref))
                    checked.append(same)
                    worst = max(worst, *errs)
                    if not same:
                        raise SystemExit(
                            f"fused_dropout disagrees with its plain "
                            f"version on {name} {dtype} p {p} upscale "
                            f"{upscale}: max_abs_err {errs[0]:.3e}, grad "
                            f"{errs[1]:.3e}")
        rates = []
        for p in (0.1, 0.5):
            keep = dk.fused_dropout_fwd(torch.ones(shape, device="cuda"), p,
                                        SEED + si, upscale=False)
            rate = keep.mean(dtype=torch.float64).item()
            sigma = (p * (1 - p) / n) ** 0.5
            rates.append(f"p {p}: keep rate {rate:.6f} "
                         f"({(rate - (1 - p)) / sigma:+.2f} sigma)")
            if abs(rate - (1 - p)) > 4 * sigma:
                raise SystemExit(f"fused_dropout keep rate {rate} at p {p} "
                                 f"on {name}: beyond 4 sigma of {1 - p}")
        x = torch.randn(shape, generator=g, device="cuda")
        row = {"max_abs_err": worst, **bound_row(2 * 4 * n, n),
               "ms": time_ms(torch, lambda: dk.fused_dropout_fwd(
                   x, 0.1, SEED, True)),
               "plain_ms": time_ms(torch, lambda: dk.fused_dropout_reference(
                   x, 0.1, SEED, True)),
               "library_ms": time_ms(torch, lambda: torch.nn.functional
                                     .dropout(x, 0.1, training=True))}
        rows[name] = row
        print(f"fused_dropout {name} {tuple(shape)}: {len(checked)} cases "
              f"(fp32, bf16; p 0.1, 0.5; both implementations) equal bit "
              f"for bit, Out and grad; {'; '.join(rates)}; fp32 p 0.1: "
              f"kernel {row['ms']:.6f} ms plain {row['plain_ms']:.6f} ms "
              f"F.dropout {row['library_ms']:.6f} ms bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']})", flush=True)

    h, d = NMT["n_head"], NMT["d_model"] // NMT["n_head"]
    for i, t in enumerate(NMT_BUCKETS):
        b = NMT_TOKENS // t
        lens = np.random.RandomState(SEED + i).randint(t // 2 + 1, t + 1, b)
        _, trg_bias, _ = make_attn_biases(lens, lens, h, t, t)
        bias = torch.from_numpy(trg_bias).cuda()
        q, k, v = [torch.randn(b, h, t, d, generator=g, device="cuda")
                   for _ in range(3)]
        dout = torch.randn_like(q)
        seed = SEED + 50 + i
        args = (q, k, v, bias, False, d ** -0.5, 0.1, seed)
        out, lse = ak.flash_attention_fwd(*args, with_lse=True)
        delta = ak.attention_delta(dout, out)
        bwd = (q, k, v, bias, dout, lse, delta, False, d ** -0.5, 0.1, seed)
        dk_, dv = ak.flash_attention_bwd_dkv(*bwd)
        dq, _ = ak.flash_attention_bwd_dq(*bwd)
        out_r, lse_r = ak.flash_attention_reference(*args, return_lse=True)
        dq_r, dk_r, dv_r, _ = ak.flash_attention_backward_reference(
            q, k, v, bias, out, lse, dout, False, d ** -0.5, 0.1, seed)
        torch.cuda.synchronize()
        errs = {"out": max_err(torch, out, out_r),
                "lse": max_err(torch, lse, lse_r),
                "dq": max_err(torch, dq, dq_r),
                "dk": max_err(torch, dk_, dk_r),
                "dv": max_err(torch, dv, dv_r)}
        tols = {"out": TRAIN_ATOL["out"]["float32"],
                "lse": TRAIN_ATOL["lse"]}
        tols.update((e, TRAIN_ATOL["grad"]["float32"])
                    for e in ("dq", "dk", "dv"))
        fwd_ms = time_ms(torch, lambda: ak.flash_attention_fwd(
            *args, with_lse=True))
        bwd_ms = time_ms(torch, lambda: (ak.flash_attention_bwd_dkv(*bwd),
                                         ak.flash_attention_bwd_dq(*bwd)))
        print(f"NMT attention T {t}: q {tuple(q.shape)} fp32, full bias "
              f"{tuple(bias.shape)}, dropout 0.1: max_abs_err " +
              " ".join(f"{e} {errs[e]:.3e} (atol {tols[e]:g})"
                       for e in errs) +
              f"; K1 {fwd_ms:.6f} ms, K2a + K2b {bwd_ms:.6f} ms", flush=True)
        bad = [e for e in errs if not errs[e] <= tols[e]]
        if bad:
            raise SystemExit(f"K1/K2 disagree with their plain versions at "
                             f"the NMT shape T {t}: "
                             f"{ {e: errs[e] for e in bad} }")
    torch.cuda.empty_cache()
    return rows


def paged_operands(torch, case, kind, rng):
    """(q, k, v, k_scale, v_scale, table, lengths) on the card for one
    paged case: float32 or bf16 arenas from normal draws, or the int8
    arm's arenas quantized from them with quantize_kv; a random table
    (slot 1 starting with slot 0's block), or for PAGED_PERMUTED cases a
    permutation of blocks 1..S*MB."""
    from paddle_tpu_torch.ops import quant_kernels as qk

    name, s_, h, d, bs, mb, n, lens = case
    if lens is None:
        lens = rng.randint(3 * mb * bs // 4, mb * bs + 1, s_)
    if name in PAGED_PERMUTED:
        table = rng.permutation(np.arange(1, n, dtype=np.int32)).reshape(
            s_, mb)
    else:
        table = rng.randint(1, n, (s_, mb)).astype(np.int32)
        if s_ > 1:
            table[1, 0] = table[0, 0]
    q = rng.randn(s_, h, d).astype(np.float32)
    k = rng.randn(n, bs, h, d).astype(np.float32)
    v = rng.randn(n, bs, h, d).astype(np.float32)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    ks = vs = None
    if kind == "int8":
        (k, ks), (v, vs) = qk.quantize_kv(k), qk.quantize_kv(v)
        ks, vs = dev(ks), dev(vs)
    dt = torch.bfloat16 if kind == "bfloat16" else torch.float32
    kv_dt = torch.int8 if kind == "int8" else dt
    return (dev(q).to(dt), dev(k).to(kv_dt), dev(v).to(kv_dt), ks, vs,
            dev(table), dev(np.asarray(lens, np.int32)))


def paged_library(torch, q, k, v, ks, vs, table, lens):
    """The two-call yardstick of paged attention: index_select of the
    slots' blocks (K and V; dequantized by their scale rows in the int8
    arm) and masked F.scaled_dot_product_attention over them.  Not the
    port's code: a time to set beside the kernel's."""
    import torch.nn.functional as F

    s_, mb = table.shape
    _, bs, h, d = k.shape
    idx = table.reshape(-1).long()
    mask = (torch.arange(mb * bs, device=q.device)[None, :] <
            lens[:, None]).reshape(s_, 1, 1, mb * bs)

    def run():
        kk, vv = k.index_select(0, idx), v.index_select(0, idx)
        if ks is not None:
            kk = kk.float() * ks.index_select(0, idx)[..., None, None]
            vv = vv.float() * vs.index_select(0, idx)[..., None, None]
        kk = kk.reshape(s_, mb * bs, h, d).transpose(1, 2)
        vv = vv.reshape(s_, mb * bs, h, d).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None, :], kk, vv,
                                              attn_mask=mask)
    return run


def paged_bound(q, k, lens, quant):
    """Bytes: every live token's K and V rows read once (int8: 1 B a value
    and two fp32 scales a token), q and the block table and lengths read
    once, out written once; operations: 4 a K/V value (the dot and the
    weighted sum), at the fp32 rate."""
    live = int(lens.sum().item())
    s_, h, d = q.shape
    nbytes = 2 * live * h * d * k.element_size() + \
        2 * s_ * h * d * q.element_size() + 4 * (s_ + lens.numel())
    if quant:
        nbytes += 2 * 4 * live
    return bound_row(nbytes, 4 * live * h * d)


def k5_sass_check():
    """K5's split-KV kernel as built: asynchronous copies into shared
    memory (LDGSTS) and no local-memory traffic (LDL, STL: register
    spills), in each of its four instantiations (float32 and bf16 q, at
    most 4 and 8 tokens a lane)."""
    bad, seen = [], 0
    for n, c in sorted(sass_counts("paged_attention").items()):
        if "paged_attention_split_kernel" not in n:
            continue
        seen += 1
        print(f"  SASS {n}: {c['instructions']} instructions, " +
              " ".join(f"{op} {c[op]}" for op in SASS_OPS))
        if not c["LDGSTS"] or c["LDL"] or c["STL"]:
            bad.append(n)
    if seen != 4 or bad:
        raise SystemExit(f"paged_attention_split_kernel: {seen} "
                         f"instantiations (want 4), without asynchronous "
                         f"copies or spilling: {bad}")


def k5_launch_check(torch, args):
    """K5_PROFILED_CALLS calls of paged_attention_quant under the
    profiler, after a warm-up call: its wrapper's counter and the host's
    record of kernel launches (the CUDA runtime's launch calls) must both
    count one a call, so the splits are merged in the same launch; the
    device kernels traced are printed beside."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import quant_kernels as qk

    qk.paged_attention_quant(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        before = qk.paged_attention_quant.launches
        for _ in range(K5_PROFILED_CALLS):
            qk.paged_attention_quant(*args)
        torch.cuda.synchronize()
    calls = qk.paged_attention_quant.launches - before
    host = {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and "Launch" in e.key}
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    # the _sleep ahead of the calls is one launch of its own
    launched = sum(host.values()) - 1
    print(f"  paged_attention_quant: {calls} calls, host launch calls "
          f"{host} (less the _sleep: {launched}); device kernels traced: "
          + ", ".join(f"{k[:60]} x{c}" for k, c in kernels.items()),
          flush=True)
    if calls != K5_PROFILED_CALLS or launched != K5_PROFILED_CALLS:
        raise SystemExit(f"paged_attention_quant: {calls} counted and "
                         f"{launched} launched in {K5_PROFILED_CALLS} "
                         f"calls; want one launch a call")


def paged_case(torch, case, kind, rng, timed, cold=None):
    """One paged case on the card: the wrapper against its plain version
    (within PAGED_ATOL, empty slots exactly zero), and where `timed`,
    kernel, plain and two-call yardstick times against the bound, with
    the kernel also timed cold (`cold`: the L2 flush) where given.
    Returns (the row, the operands)."""
    from paddle_tpu_torch.ops import paged_kernels as pk
    from paddle_tpu_torch.ops import quant_kernels as qk

    q, k, v, ks, vs, table, lens = paged_operands(torch, case, kind, rng)
    scale = 1.0 / q.shape[-1] ** 0.5
    if kind == "int8":
        args = (q, k, v, ks, vs, table, lens)

        def fn():
            return qk.paged_attention_quant(*args)

        def plain():
            return qk.paged_attention_quant_reference(*args, scale)
    else:
        args = (q, k, v, table, lens)

        def fn():
            return pk.paged_attention(*args)

        def plain():
            return pk.paged_attention_reference(*args, scale)
    out, ref = fn(), plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    empty = lens == 0
    zeros = bool((out[empty] == 0).all().item())
    row = {"max_abs_err": err, **paged_bound(q, k, lens, kind == "int8")}
    times = ""
    if timed:
        row.update(ms=time_ms(torch, fn), plain_ms=time_ms(torch, plain),
                   library_ms=time_ms(torch, paged_library(
                       torch, q, k, v, ks, vs, table, lens)))
        times = (f" kernel {row['ms']:.6f} ms plain {row['plain_ms']:.6f} "
                 f"ms index_select + masked SDPA {row['library_ms']:.6f} "
                 f"ms bound {row['bound_ms']:.6f} ms ({row['bound_by']})")
        if cold is not None:
            row["cold_ms"] = time_ms(torch, fn, before=cold)
            times += f"; kernel cold (L2 flushed) {row['cold_ms']:.6f} ms"
    shown = lens.tolist() if case[7] else \
        f"in [{lens.min().item()}, {lens.max().item()}]"
    print(f"paged_attention {case[0]} {kind}: lengths {shown} max_abs_err "
          f"{err:.3e} (atol {PAGED_ATOL[kind]}), empty slots zero "
          f"{zeros}{times}", flush=True)
    if not err <= PAGED_ATOL[kind] or not zeros:
        raise SystemExit(f"paged attention ({kind}) disagrees with its "
                         f"plain version on {case[0]}: {err}, empty slots "
                         f"zero {zeros}")
    return row, args


def paged_kernel_phase(torch):
    """K4 (float32 and bf16 arenas) and K5 (int8 arenas with fp32 scale
    rows) against their plain versions on the same tensors, at
    bench_kernels.py's decode shape, the disaggregated path's own call
    and at ragged and odd ones (D 4, 8, 64, 100 and 320, above 256;
    blocks of 4 and 5; an empty slot, a 1-token slot, a block shared by
    two slots): within PAGED_ATOL, empty slots exactly zero.  At the
    shapes of PAGED_TIMED: kernel, plain and two-call yardstick times
    against the bound (K5 also cold).  Then K5's split-KV kernel: its
    SASS, the cases of PAGED_SPLIT_CASES (distinct blocks at the decode
    shape and a long context, timed warm and cold; the split edges), and
    one launch a call from the profiler's host record."""
    from paddle_tpu_torch.ops import paged_kernels as pk

    phase("paged attention kernel vs plain (K4 float32/bf16, K5 int8)")
    rng = np.random.RandomState(SEED + 17)
    flush = l2_flush(torch)
    rows = {}
    for case in PAGED_CASES:
        for kind in ("float32", "bfloat16", "int8"):
            rows[f"{case[0]}_{kind}"], _ = paged_case(
                torch, case, kind, rng, case in PAGED_TIMED,
                flush if kind == "int8" else None)
    k5_sass_check()
    for case in PAGED_SPLIT_CASES:
        plan = pk.split_plan(*case[1:4], case[4], case[5])
        print(f"  split plan {case[0]}: {plan}")
        row, args = paged_case(torch, case, "int8", rng,
                               case is not PAGED_EDGES, flush)
        rows[f"{case[0]}_int8"] = row
        if case is PAGED_DISTINCT:
            k5_launch_check(torch, args)
        del args
        torch.cuda.empty_cache()
    del flush
    return rows


def nmt_program(fluid, vocab, n_layer, n_head, d_model, d_inner):
    """bench.py's NMT training program (transformer(...), label smoothing
    0.1, dropout 0.1, Adam 2e-4) with seeds fixed to SEED: (main,
    startup, loss, predict, infer).  `infer` is the forward cloned for
    test before minimize, pruned to `predict`: the decode program."""
    from paddle_tpu_torch.models.transformer import transformer

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        loss, predict, _ = transformer(
            vocab, vocab, max(NMT_BUCKETS) + 1, n_layer, n_head,
            d_model // n_head, d_model // n_head, d_model, d_inner,
            dropout_rate=0.1, label_smooth_eps=0.1)
        infer = main.clone(for_test=True)._prune([predict])
        fluid.optimizer.Adam(learning_rate=2e-4).minimize(loss)
    return main, startup, loss, predict, infer


def nmt_batch(rng, t, vocab, n_head, tokens=NMT_TOKENS):
    """bench.py's make_batch (bench.py:221-236): tokens // t sentences,
    lengths in (t/2, t], padded to t; the real target tokens counted."""
    from paddle_tpu_torch.models.transformer import make_attn_biases

    b = max(1, tokens // t)
    src_lens = rng.randint(t // 2 + 1, t + 1, b)
    trg_lens = rng.randint(t // 2 + 1, t + 1, b)
    sw = rng.randint(1, vocab, (b, t)).astype(np.int64)
    tw = rng.randint(1, vocab, (b, t)).astype(np.int64)
    pos = np.tile(np.arange(t, dtype=np.int64), (b, 1))
    sb, tb, xb = make_attn_biases(src_lens, trg_lens, n_head, t, t)
    lblw = (np.arange(t)[None, :] < trg_lens[:, None]).astype(
        np.float32)[..., None]
    return {"src_word": sw, "src_pos": pos, "trg_word": tw, "trg_pos": pos,
            "src_slf_attn_bias": sb, "trg_slf_attn_bias": tb,
            "trg_src_attn_bias": xb, "lbl_word": tw[..., None],
            "lbl_weight": lblw}, int(trg_lens.sum())


def nmt_parity_phase(torch):
    """NMT at full width, 2 layers, dictionary 1000, dropout 0.1 with
    FLAGS_use_fused_dropout on: 3 Adam steps on the card (every dropout
    through K10) against 3 on the CPU (the plain version: the same
    bits) from one state."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import dropout_kernels as dk

    phase(f"NMT parity: {NMT_PARITY['n_layer']} layers, width "
          f"{NMT_PARITY['d_model']}, dictionary {NMT_PARITY['vocab']}, "
          f"dropout 0.1 through K10, card vs CPU")
    fluid.set_flags({"use_fused_dropout": True})
    main, startup, loss, _, _ = nmt_program(fluid, **NMT_PARITY)
    n_drop = sum(op.type == "dropout" for op in main.global_block().ops)
    feed, _ = nmt_batch(np.random.RandomState(SEED + 14), 32,
                        NMT_PARITY["vocab"], NMT_PARITY["n_head"],
                        tokens=512)
    launches = card_vs_cpu(fluid, main, startup, loss, [feed] * 3,
                           f"NMT {NMT_PARITY['n_layer']} layers, dropout 0.1",
                           counters=(dk.fused_dropout,))
    want = 2 * n_drop * 3
    if launches["fused_dropout"] != want:
        raise SystemExit(f"fused_dropout launches {launches}, expected "
                         f"{want} (forward and backward of {n_drop} "
                         f"dropout ops, 3 steps)")
    fluid.set_flags({"use_fused_dropout": False})
    torch.cuda.empty_cache()


def nmt_training_phase(torch, smi):
    """Transformer-base NMT trained on the card at bench.py's fp32
    configuration, FLAGS_use_fused_dropout on: the main path of this
    slice.  Two batches per bucket, each run once to warm its shape, then
    once more timed with the kernels' launches counted."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import dropout_kernels as dk

    phase(f"training NMT: transformer-base ({NMT['n_layer']} + "
          f"{NMT['n_layer']} layers, d_model {NMT['d_model']}, d_inner "
          f"{NMT['d_inner']}, vocabulary {NMT['vocab']}), {NMT_TOKENS} "
          f"tokens a batch bucketed to T {NMT_BUCKETS}, label smoothing "
          f"0.1, dropout 0.1 through K10, Adam 2e-4")
    fluid.set_flags({"use_fused_dropout": True})
    t0 = time.perf_counter()
    main, startup, loss, predict, infer = nmt_program(fluid, **NMT)
    ops = main.global_block().ops
    n_drop = sum(op.type == "dropout" for op in ops)
    n_attn = sum(op.type == "fused_attention" for op in ops)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    print(f"NMT: {n_params} parameters, {len(ops)} ops ({n_drop} dropout, "
          f"{n_attn} fused_attention), built and started on the card in "
          f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.RandomState(SEED + 15)
    batches = [(t, *nmt_batch(rng, t, NMT["vocab"], NMT["n_head"]))
               for t in NMT_BUCKETS for _ in range(NMT_BATCHES_PER_BUCKET)]

    def step(feed):
        return float(exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope)[0])

    warm = [step(feed) for _, feed, _ in batches]
    counters = {"dropout": dk.fused_dropout, "fwd": ak.flash_attention,
                "dkv": ak.flash_attention_bwd_dkv,
                "dq": ak.flash_attention_bwd_dq}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses, walls = [], {}
    for t, feed, _ in batches:
        t0 = time.perf_counter()
        losses.append(step(feed))
        walls.setdefault(t, []).append(time.perf_counter() - t0)
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    steps = len(batches)
    # per step: every dropout op once forward and once on its cotangent;
    # K1 in the forward op and again in the generic grad's recompute;
    # K2a and K2b once per attention op
    want = {"dropout": 2 * n_drop * steps, "fwd": 2 * n_attn * steps,
            "dkv": n_attn * steps, "dq": n_attn * steps}
    ntok = sum(n for _, _, n in batches)
    total = sum(sum(w) for w in walls.values())
    print(f"losses: warm pass {warm}, timed pass {losses}")
    print(f"launches {launches} (expected {want}; per step "
          f"{ {k: v // steps for k, v in launches.items()} })")
    for t, w in walls.items():
        b = NMT_TOKENS // t
        print(f"[{smi}] bucket T {t} (batch {b}): step "
              f"{statistics.median(w) * 1e3:.6f} ms (median of {len(w)})")
    print(f"[{smi}] {ntok} real target tokens in {total:.6f} s: "
          f"{ntok / total:.3f} target tokens/s; peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    if not np.isfinite(warm + losses).all() or \
            not np.mean(losses) < np.mean(warm):
        raise SystemExit(f"NMT losses are not finite and falling: warm "
                         f"{warm}, then {losses}")
    if launches != want:
        raise SystemExit(f"NMT kernel launches {launches}, expected {want}")
    feed32 = batches[2][1]
    profile_run(torch, lambda: step(feed32),
                f"one NMT training step (T 32, batch {NMT_TOKENS // 32})",
                smi)
    fluid.set_flags({"use_fused_dropout": False})
    return launches["dropout"], (exe, scope, infer, predict)


def nmt_decode_phase(torch, smi, trained):
    """The trained NMT model decoded through ContinuousBatchingEngine over
    the paged KV pool (bench.py:613-720's contract: make_program_step_fn
    over the infer program, a feed_builder from lengths): greedy tokens
    equal lockstep_decode's; a mixed run with sampled requests keeps the
    greedy ones' tokens and a sampled request re-run with its seed gives
    its tokens again; a speculative run (the target as its own draft,
    k 2) accepts every draft and gives the greedy tokens; one step shape;
    no block held after the drain."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.transformer import make_attn_biases
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import dropout_kernels as dk
    from paddle_tpu_torch.serving.fleet import (
        ContinuousBatchingEngine, ContinuousConfig, PagedKVConfig,
        SpeculativeConfig, lockstep_decode, make_program_step_fn,
        make_program_verify_fn)

    exe, scope, infer, predict = trained
    h, L, ts, vocab = NMT["n_head"], DEC_LEN, DEC_SRC, NMT["vocab"]
    phase(f"decode NMT: ContinuousBatchingEngine over the paged KV pool, "
          f"{DEC_SLOTS} slots, max_len {L}, source length {ts}, "
          f"{DEC_GROUPS} groups of budgets {DEC_LONG} + {DEC_SHORT} x "
          f"{DEC_SLOTS - 1}")

    def feed_builder(prefix, lengths, context):
        n = prefix.shape[0]
        sb, tb, cb = make_attn_biases([ts] * n, [int(x) for x in lengths],
                                      h, ts, L)
        return {"src_word": context["src"],
                "src_pos": np.tile(np.arange(ts), (n, 1)).astype(np.int64),
                "trg_word": np.asarray(prefix)[:, :L],
                "trg_pos": np.tile(np.arange(L), (n, 1)).astype(np.int64),
                "src_slf_attn_bias": sb, "trg_slf_attn_bias": tb,
                "trg_src_attn_bias": cb}

    cfg = ContinuousConfig(
        slots=DEC_SLOTS, max_len=L, bos_id=0, eos_id=-1,
        context_spec={"src": ((ts,), np.int64)},
        kv=PagedKVConfig(block_size=16))
    rng = np.random.RandomState(SEED + 16)
    budgets = ([DEC_LONG] + [DEC_SHORT] * (DEC_SLOTS - 1)) * DEC_GROUPS
    srcs = [rng.randint(2, vocab, (ts,)).astype(np.int64) for _ in budgets]
    sampled = {i: {"temperature": 0.8, "top_k": 40, "top_p": 0.9,
                   "seed": SEED + i} for i in range(1, len(budgets), 2)}

    def run(step, speculative=None, n=len(budgets), sampling=None):
        eng = ContinuousBatchingEngine(step, cfg, speculative=speculative)
        done = {}
        try:
            t0 = time.perf_counter()
            reqs = []
            for i in range(n):
                r = eng.submit(DEC_SYS, context={"src": srcs[i]},
                               max_new_tokens=budgets[i],
                               sampling=(sampling or {}).get(i))
                r.add_done_callback(
                    lambda _r, i=i: done.setdefault(i, time.perf_counter()))
                reqs.append(r)
            outs = [r.result(600) for r in reqs]
            wall = time.perf_counter() - t0
            st = eng.stats()
            eng._store.pool.check_invariants()
        finally:
            eng.stop()
        per_tok = [(done[i] - t0) / budgets[i] * 1e3 for i in range(n)]
        return outs, wall, st, per_tok

    with fluid.scope_guard(scope):
        step = make_program_step_fn(exe, infer, predict, feed_builder)
        verify = make_program_verify_fn(exe, infer, predict, feed_builder,
                                        k=2)
        requests = [(DEC_SYS, {"src": s}, b) for s, b in zip(srcs, budgets)]
        t0 = time.perf_counter()
        lock, lock_steps = lockstep_decode(step, requests, cfg)
        lock_s = time.perf_counter() - t0
        counters = {"fwd": ak.flash_attention, "dropout": dk.fused_dropout}
        for c in counters.values():
            c.launches = 0
        outs, wall, st, per_tok = run(step)
        launches = {k: c.launches for k, c in counters.items()}
        mixed, _, mst, _ = run(step, sampling=sampled)
        first = min(sampled)
        again, _, _, _ = run(step, n=first + 1, sampling={
            first: sampled[first]})
        spec, _, sst, _ = run(step, SpeculativeConfig(step, verify, k=2),
                              n=DEC_SLOTS)
        # one step's parts: the program's run, then the fetch of the
        # whole [slots, L, V] probability tensor the step contract reads
        probe = (np.zeros((DEC_SLOTS, L), np.int64),
                 np.full(DEC_SLOTS, 8, np.int64),
                 {"src": np.stack(srcs[:DEC_SLOTS])})
        t0 = time.perf_counter()
        (probs,) = exe.run(infer, feed=feed_builder(*probe),
                           fetch_list=[predict], return_numpy=False)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        probs.cpu()
        d2h_ms = (time.perf_counter() - t0) * 1e3
        rows = profile_run(
            torch, lambda: step(*probe),
            f"one decode step ([{DEC_SLOTS}, {L}] prefix, "
            f"[{DEC_SLOTS}, {L}, {vocab}] probabilities to the host)",
            smi)["rows"]
    dtoh = [(ms, c) for name, ms, c in rows if "DtoH" in name]
    greedy_ok = all(np.array_equal(a, b) for a, b in zip(outs, lock))
    mixed_ok = all(np.array_equal(mixed[i], lock[i])
                   for i in range(len(budgets)) if i not in sampled)
    reseed_ok = np.array_equal(again[first], mixed[first])
    spec_ok = all(np.array_equal(a, b) for a, b in zip(spec, lock))
    gen = sum(budgets)
    kv = st["kv"]
    held = kv["blocks_live"] - kv["blocks_cached"]
    print(f"lockstep baseline: {lock_steps} steps in {lock_s:.6f} s")
    print(f"[{smi}] continuous greedy: {gen} tokens in {wall:.6f} s, "
          f"{gen / wall:.3f} tokens/s, {st['counters']['steps']} steps; "
          f"per-token latency p50 {np.percentile(per_tok, 50):.6f} ms p99 "
          f"{np.percentile(per_tok, 99):.6f} ms; step_ms {st['step_ms']}")
    print(f"greedy tokens equal lockstep_decode's: {greedy_ok}; with "
          f"{len(sampled)} sampled slot-mates the greedy ones unchanged: "
          f"{mixed_ok}, sampled tokens {mst['counters']['sampled_tokens']};"
          f" sampled request {first} re-run with its seed equal: "
          f"{reseed_ok}; speculative (k 2, the target as draft) accept rate"
          f" {sst['speculative']['accept_rate']}, tokens equal: {spec_ok}")
    print(f"shape signatures: greedy {st['shape_signatures']}, mixed "
          f"{mst['shape_signatures']}, speculative {sst['shape_signatures']};"
          f" prefix hits {kv['counters']['prefix_hits']}, COW forks "
          f"{kv['counters']['cow_forks']}, blocks held after the drain "
          f"{held} ({kv['blocks_cached']} cached); decode launches "
          f"{launches}")
    print(f"[{smi}] decode step parts: infer program run {run_ms:.6f} ms; "
          f"the [{DEC_SLOTS}, {L}, {vocab}] fp32 probabilities to the host "
          f"{d2h_ms:.6f} ms (host clock); profiled DtoH copies {dtoh}")
    if not (greedy_ok and mixed_ok and reseed_ok and spec_ok):
        raise SystemExit("decode tokens disagree (see above)")
    if sst["speculative"]["accept_rate"] != 1.0:
        raise SystemExit("a target drafting for itself was not accepted")
    if {st["shape_signatures"], mst["shape_signatures"],
            sst["shape_signatures"]} != {1} or held != 0:
        raise SystemExit("decode used more than one step shape or leaked "
                         "KV blocks")
    if launches["fwd"] != NMT["n_layer"] * 3 * st["counters"]["steps"] or \
            launches["dropout"] != 0:
        raise SystemExit(f"decode launches {launches}: expected K1 "
                         f"{3 * NMT['n_layer']} times a step and no K10")
    torch.cuda.empty_cache()
    return launches


def wall_stats(walls):
    """'p50 x ms p99 y ms' of per-request walls (seconds)."""
    ms = np.asarray(walls) * 1e3
    return (f"p50 {np.percentile(ms, 50):.6f} ms p99 "
            f"{np.percentile(ms, 99):.6f} ms")


def chain_slot(pool, prompt, n_blocks):
    """Admit `prompt` on slot 0 of `pool` when the pool's prefix cache
    holds its whole chain (every block a hit); True if it did.  On a
    miss the slot is released again (the chain it cached holds no K/V
    and is never read)."""
    hits = pool.snapshot()["counters"]["prefix_hits"]
    pool.admit(0, prompt)
    if pool.snapshot()["counters"]["prefix_hits"] - hits == n_blocks:
        return True
    pool.release(0)
    return False


def disagg_phase(torch, smi, trained):
    """The disaggregated tier at transformer-base width: one
    PrefillReplica (prefill_fn: the trained decode program over the
    phase's source sentence with the prompt as the target prefix, every
    decoder layer's self-attention K/V quantized by quantize_kv into
    kv_value_spec(8, 64)'s int8 layout), two decode Replicas
    (ContinuousBatchingEngine over make_program_step_fn, int8 paged pools
    of blocks of 16, a KVStreamServer on each), a DisaggRouter with
    prefill_threshold 16.  16 greedy requests: 8 prompts of 32 or 48
    tokens (whole blocks) take the split path, 8 of 3-5 tokens fall back
    to co-located decode.  Then, per split prompt and layer, K5 over the
    decode pool's streamed int8 arenas (the slot's table row from an
    admit that hits the prefix cache for every block) against the
    program's own attention output at the prompt's last position (within
    DISAGG_INT8_ATOL), and K4 over a float32 pool the same chains were
    streamed into (within DISAGG_FP32_ATOL).  Split tokens must equal
    lockstep_decode's over the same step function, every transferred
    block must be a decode-side prefix hit, no pool may hold a block after
    the drain."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed.rpc import RPCClient
    from paddle_tpu_torch.models import transformer as tr
    from paddle_tpu_torch.models.transformer import make_attn_biases
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import paged_kernels as pk
    from paddle_tpu_torch.ops import quant_kernels as qk
    from paddle_tpu_torch.serving.disagg import (
        DisaggConfig, DisaggRouter, KVStreamServer, PrefillReplica,
        stream_slot)
    from paddle_tpu_torch.serving.fleet import (
        ContinuousConfig, PagedKVConfig, Replica, lockstep_decode,
        make_program_step_fn)
    from paddle_tpu_torch.serving.kv import KVBlockPool

    _, scope, infer, predict = trained
    h, L, ts, vocab = NMT["n_head"], DEC_LEN, DEC_SRC, NMT["vocab"]
    d, layers, bs = NMT["d_model"] // h, NMT["n_layer"], DISAGG_BLOCK
    phase(f"disaggregated decode: PrefillReplica -> kv_stream (int8) -> "
          f"2 decode Replicas, DisaggRouter(prefill_threshold "
          f"{DISAGG_THRESHOLD}); K5/K4 over the streamed arenas")
    rng = np.random.RandomState(SEED + 18)
    src = rng.randint(2, vocab, (ts,)).astype(np.int64)
    longs = [np.concatenate([[0], rng.randint(2, vocab, (n - 1,))])
             .astype(np.int64) for n in DISAGG_LONG]
    shorts = [np.concatenate([[0], rng.randint(2, vocab, (n - 1,))])
              .astype(np.int64) for n in DISAGG_SHORT]
    ctx = {"src": src}

    def feed_builder(prefix, lengths, context):
        n = prefix.shape[0]
        sb, tb, cb = make_attn_biases([ts] * n, [int(x) for x in lengths],
                                      h, ts, L)
        return {"src_word": context["src"],
                "src_pos": np.tile(np.arange(ts), (n, 1)).astype(np.int64),
                "trg_word": np.asarray(prefix)[:, :L],
                "trg_pos": np.tile(np.arange(L), (n, 1)).astype(np.int64),
                "src_slf_attn_bias": sb, "trg_slf_attn_bias": tb,
                "trg_src_attn_bias": cb}

    int8_spec = tr.layer_value_spec(PagedKVConfig(block_size=bs,
                                                  kv_dtype="int8"),
                                    layers, h, d)
    fp32_spec = tr.layer_value_spec(PagedKVConfig(block_size=bs), layers,
                                    h, d)
    kv = dict(block_size=bs, num_blocks=DISAGG_BLOCKS, kv_dtype="int8",
              value_spec=int8_spec)
    cfg = ContinuousConfig(slots=DEC_SLOTS, max_len=L, bos_id=0, eos_id=-1,
                           context_spec={"src": ((ts,), np.int64)},
                           kv=PagedKVConfig(**kv))
    counters = {"paged": pk.paged_attention,
                "paged_quant": qk.paged_attention_quant,
                "fwd": ak.flash_attention}
    for c in counters.values():
        c.launches = 0
    walls = {"split": [], "colocated": []}
    servers, pools = [], []
    rpc = RPCClient()
    with fluid.scope_guard(scope):
        def executor():
            return fluid.Executor(fluid.CUDAPlace(0))

        router = DisaggRouter(DisaggConfig(
            prefill_threshold=DISAGG_THRESHOLD, bos_id=0,
            prefill_timeout_s=DISAGG_DEADLINE_MS / 1000))
        try:
            for i in range(2):
                r = Replica(f"d{i}")
                eng = r.add_decode_model(
                    "nmt", make_program_step_fn(executor(), infer, predict,
                                                feed_builder), config=cfg)
                pools.append(eng.kv_pool())
                servers.append(KVStreamServer(pools[-1]))
                router.add_replica(r, kv_endpoint=servers[-1].endpoint)
            pf = PrefillReplica("p0")
            pf_engine = pf.add_prefill_model(
                "nmt", tr.make_prefill_fn(executor(), infer, src, h,
                                          kv_dtype="int8"),
                rpc, kv=dict(kv), slots=2, max_blocks=L // bs)
            router.add_replica(pf)
            jobs = [(p, b, "split") for p, b in zip(longs, DISAGG_LONG_BUDGETS)] \
                + [(p, b, "colocated")
                   for p, b in zip(shorts, DISAGG_SHORT_BUDGETS)]
            outs = [None] * len(jobs)
            errors = []

            def client(i):
                p, b, kind = jobs[i]
                try:
                    t0 = time.perf_counter()
                    outs[i] = router.submit_disagg(
                        "nmt", p, context=ctx, max_new_tokens=b,
                        timeout_ms=DISAGG_DEADLINE_MS).result(600)
                    walls[kind].append(time.perf_counter() - t0)
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(f"request {i}: {type(e).__name__}: {e}")

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(jobs))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(900)
            wall = time.perf_counter() - t0
            st = router.stats()
        finally:
            router.stop()
            for srv in servers:
                srv.shutdown()
        if errors or any(t.is_alive() for t in threads):
            raise SystemExit(f"disaggregated requests failed: {errors}")
        lock, _ = lockstep_decode(
            make_program_step_fn(executor(), infer, predict, feed_builder),
            [(p, ctx, b) for p, b in zip(longs, DISAGG_LONG_BUDGETS)], cfg)
        committed = sum(srv.ingestor.counters()["streams_committed"]
                        for srv in servers)
        hits = sum(pool.snapshot()["counters"]["prefix_hits"]
                   for pool in pools)
        streamed = sum(len(p) // bs for p in longs)
        int8_bytes = pf_engine.stats()["streamed_bytes"]
        # every long prompt took the split path and its chain reached a
        # decode pool's prefix cache; else say which leg fell short
        dis = st["disagg"]
        if dis["split"] != len(longs) or \
                dis["fallback_short"] != len(shorts) or \
                committed != len(longs) or hits != streamed:
            ingests = [srv.ingestor.counters() for srv in servers]
            raise SystemExit(
                f"split path short: {dis}; {committed} streams committed, "
                f"{hits} prefix hits for {streamed} streamed blocks; "
                f"prefill {pf_engine.stats()}; ingestors {ingests}")

        # the same chains as float32 planes, streamed into a float32 pool
        fp32_cfg = dict(block_size=bs, value_spec=fp32_spec)
        stage = KVBlockPool(2, L // bs, PagedKVConfig(num_blocks=L // bs + 1,
                                                      **fp32_cfg))
        fp32 = KVBlockPool(2, L // bs, PagedKVConfig(
            num_blocks=streamed + L // bs + 2, **fp32_cfg))
        fp32_prefill = tr.make_prefill_fn(executor(), infer, src, h)
        fp32_bytes = 0
        with KVStreamServer(fp32) as srv:
            for i, p in enumerate(longs):
                stage.admit(0, p, values=fp32_prefill(p))
                try:
                    fp32_bytes += stream_slot(rpc, srv.endpoint, stage, 0,
                                              f"fp32-{i}")["bytes"]
                finally:
                    stage.release(0)

        err8 = err32 = 0.0
        taps_exe = executor()
        for p in longs:
            taps = tr.attention_taps(taps_exe, infer, p, src, h)
            pool = next((pl for pl in pools if chain_slot(pl, p, len(p) // bs)),
                        None)
            if pool is None or not chain_slot(fp32, p, len(p) // bs):
                raise SystemExit("a streamed chain is missing from the "
                                 "decode pools' prefix cache")
            lens = torch.tensor([len(p)], dtype=torch.int32).cuda()
            try:
                for i, tap in enumerate(taps):
                    q = torch.from_numpy(tap["q"][-1:]).cuda()
                    want = torch.from_numpy(tap["out"][-1:]).cuda()
                    got = qk.paged_attention_quant(
                        q, pool.arena(f"l{i}_k"), pool.arena(f"l{i}_v"),
                        pool.arena(f"l{i}_k_scale"),
                        pool.arena(f"l{i}_v_scale"), pool.table_view()[:1],
                        lens)
                    err8 = max(err8, (got - want).abs().max().item())
                    got = pk.paged_attention(
                        q, fp32.arena(f"l{i}_k"), fp32.arena(f"l{i}_v"),
                        fp32.table_view()[:1], lens)
                    err32 = max(err32, (got - want).abs().max().item())
            finally:
                pool.release(0)
                fp32.release(0)
        torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    all_pools = pools + [pf_engine.pool, stage, fp32]
    for pool in all_pools:
        pool.check_invariants()
    held = [pool.snapshot()["blocks_live"] - pool.snapshot()["blocks_cached"]
            for pool in all_pools]
    split = [outs[i] for i, job in enumerate(jobs) if job[2] == "split"]
    tokens_ok = all(np.array_equal(a, b) for a, b in zip(split, lock))
    gen = sum(b for _, b, _ in jobs)
    print(f"[{smi}] {len(jobs)} requests, {gen} tokens in {wall:.6f} s "
          f"({gen / wall:.3f} tokens/s): split {dis['split']}, fallback "
          f"short {dis['fallback_short']}, no prefill "
          f"{dis['fallback_no_prefill']}, stream failed "
          f"{dis['fallback_stream_failed']}, decode pin "
          f"{dis['fallback_decode_pin']}")
    print(f"[{smi}] per-request wall: split {wall_stats(walls['split'])}; "
          f"co-located {wall_stats(walls['colocated'])}")
    for name in ("d0", "d1"):
        est = st["replicas"][name]["models"]["nmt"]["engine"]
        print(f"[{smi}] decode replica {name}: {est['counters']['steps']} "
              f"steps, step_ms {est['step_ms']}, completed "
              f"{est['counters']['completed']}")
    print(f"[{smi}] prefill replica: {pf_engine.stats()['prefills']} "
          f"prefills, {int8_bytes} bytes streamed")
    print(f"streams committed {committed}; decode-pool prefix hits {hits} "
          f"for {streamed} streamed blocks; wire bytes int8 {int8_bytes}, "
          f"float32 {fp32_bytes} (ratio {int8_bytes / fp32_bytes:.6f})")
    print(f"split tokens equal lockstep_decode's: {tokens_ok}; attention "
          f"over the streamed arenas against the program's at the "
          f"prompt's last position: K5 (int8) max_abs_err {err8:.3e} "
          f"(atol {DISAGG_INT8_ATOL}), K4 (float32) {err32:.3e} (atol "
          f"{DISAGG_FP32_ATOL}); launches {launches}")
    print(f"pools audited (check_invariants): {len(all_pools)}; blocks held "
          f"after the drain {held}")
    want = layers * len(longs)
    if not tokens_ok:
        raise SystemExit("split-path tokens differ from co-located decode")
    if not (err8 < DISAGG_INT8_ATOL and err32 < DISAGG_FP32_ATOL):
        raise SystemExit(f"paged attention over the streamed arenas: int8 "
                         f"{err8}, float32 {err32}")
    if any(held):
        raise SystemExit(f"pools hold blocks after the drain: {held}")
    if launches["paged"] != want or launches["paged_quant"] != want:
        raise SystemExit(f"paged attention launches {launches}, expected "
                         f"{want} each ({layers} layers x {len(longs)} "
                         f"prompts)")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the sequence-parallel slice: K3, the ring, the dp x tp x sp x pp step
# ---------------------------------------------------------------------------

def k3_bounds_ms(q, causal):
    """Least time of K3's forward and of its backward on an H100 SXM: q,
    k, v (and dout, out, lse, dlse) read once and out, lse (dq, dk, dv)
    written once over the memory rate, against 4 FLOP per unmasked (q,
    k) pair and head dim forward and 2.5 times that backward over the
    3xTF32 rate (K1, K2a, K2b run on the tensor cores), with the bound at
    the float32 peak beside (attention_bound_row)."""
    b, h, t, d = q.shape
    pairs = t * (t + 1) // 2 if causal else t * t
    n, rows = 4 * q.numel(), 4 * b * h * t
    fwd = 4 * b * h * d * pairs
    return {"fwd": attention_bound_row(4 * n + rows, fwd, "float32"),
            "bwd": attention_bound_row(8 * n + 2 * rows, 2.5 * fwd,
                                       "float32")}


def k3_library(torch, q, k, v, dout, causal, scale):
    """The yardstick: PyTorch's memory-efficient attention, which returns
    (out, lse) in float32 as K3 does (forward), and its backward through
    SDPA on that backend (which takes no lse cotangent).  (fwd, bwd)
    callables, or None with the reason when this build has no such
    kernel for these inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def fwd():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            q, k, v, None, True, 0.0, causal, scale=scale)

    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    try:
        fwd()
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, is_causal=causal, scale=scale)
    except RuntimeError as e:
        print(f"  no library yardstick: {str(e).splitlines()[0][:120]}")
        return None

    def bwd():
        return torch.autograd.grad(out, leaves, dout, retain_graph=True)

    return fwd, bwd


def k3_kernel_phase(torch):
    """K3 against its plain version at the ring's shard shapes and, in
    the kernels' wide arm, at head dim 320 (SP_WIDE), with cotangents on
    out and on lse: out, lse, dq, dk, dv within TRAIN_ATOL, K3, K2a and
    K2b each launched; forward and backward times beside the bound, the
    plain versions and the library yardstick."""
    from paddle_tpu_torch.ops import attention_kernels as ak

    phase("K3 (flash_attention_with_lse) vs plain at the ring's shard "
          "shapes, with a nonzero lse cotangent")
    g = torch.Generator(device="cuda").manual_seed(SEED + 80)
    b, h, t, d0 = SP_SHARD
    counters = (ak.flash_attention_with_lse, ak.flash_attention_bwd_dkv,
                ak.flash_attention_bwd_dq)
    rows = {}
    for name, tt, causal, d in (
            (f"shard_b{b}_h{h}_t{t}_d{d0}", t, False, d0),
            (f"shard_b{b}_h{h}_t{t}_d{d0}_causal", t, True, d0),
            (f"ragged_t{SP_RAGGED_T}_causal", SP_RAGGED_T, True, d0),
            (f"wide_t{SP_WIDE[0]}_d{SP_WIDE[1]}_causal", SP_WIDE[0], True,
             SP_WIDE[1])):
        scale = d ** -0.5
        q, k, v, dout = (torch.randn(b, h, tt, d, generator=g,
                                     device="cuda") for _ in range(4))
        dlse = torch.randn(b, h, tt, generator=g, device="cuda")
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        for c in counters:
            c.launches = 0
        out, lse = ak.flash_attention_with_lse(*leaves, causal=causal,
                                               scale=scale)
        grads = torch.autograd.grad((out, lse), leaves, (dout, dlse),
                                    retain_graph=True)
        if not all(c.launches for c in counters):
            raise SystemExit(f"{name}: a kernel did not launch: "
                             f"{[c.launches for c in counters]}")
        out_r, lse_r = ak.flash_attention_reference(
            q, k, v, None, causal, scale, return_lse=True)
        # the backward's plain version on the kernel's forward outputs
        ref = ak.flash_attention_backward_reference(
            q, k, v, None, out.detach(), lse.detach(), dout, causal, scale,
            dlse=dlse)
        torch.cuda.synchronize()
        errs = {"out": max_err(torch, out, out_r),
                "lse": max_err(torch, lse, lse_r)}
        errs.update((n, max_err(torch, a, r))
                    for n, a, r in zip(("dq", "dk", "dv"), grads, ref))
        # the kernels' inputs as the backward formed them: delta - dlse
        out_d, lse_d = out.detach(), lse.detach()
        delta = ak.attention_delta(dout, out_d) - dlse
        tols = {"out": TRAIN_ATOL["out"]["float32"],
                "lse": TRAIN_ATOL["lse"]}
        tols.update((n, TRAIN_ATOL["grad"]["float32"])
                    for n in ("dq", "dk", "dv"))
        bounds = k3_bounds_ms(q, causal)
        lib = k3_library(torch, q, k, v, dout, causal, scale)
        row = {
            "max_abs_err": max(errs["out"], errs["lse"]),
            "ms": time_ms(torch, lambda: ak.flash_attention_with_lse(
                q, k, v, causal=causal, scale=scale)),
            "plain_ms": time_ms(torch, lambda: ak.flash_attention_reference(
                q, k, v, None, causal, scale, return_lse=True)),
            "library_ms": None if lib is None else time_ms(torch, lib[0]),
            **bounds["fwd"],
            "bwd_max_abs_err": max(errs[n] for n in ("dq", "dk", "dv")),
            "bwd_ms": time_ms(torch, lambda: torch.autograd.grad(
                (out, lse), leaves, (dout, dlse), retain_graph=True)),
            "bwd_plain_ms": time_ms(
                torch, lambda: ak.flash_attention_backward_reference(
                    q, k, v, None, out.detach(), lse.detach(), dout,
                    causal, scale, dlse=dlse)),
            "bwd_library_ms": None if lib is None else time_ms(torch,
                                                               lib[1]),
            "bwd_bound_ms": bounds["bwd"]["bound_ms"],
            "bwd_bound_by": bounds["bwd"]["bound_by"],
            "bwd_cuda_core_bound_ms": bounds["bwd"]["cuda_core_bound_ms"],
            "bwd_cuda_core_bound_by": bounds["bwd"]["cuda_core_bound_by"]}
        rows[name] = row
        print(f"{name}: q {tuple(q.shape)} float32 causal {causal}")
        print("  max_abs_err " + " ".join(
            f"{e} {errs[e]:.3e} (atol {tols[e]:g})" for e in errs))
        print("  max |kernel| " + " ".join(
            f"{n} {x.abs().max().item():.3e}"
            for n, x in zip(("dq", "dk", "dv"), grads)))
        lib_txt = ("none" if lib is None else
                   f"{row['library_ms']:.6f} ms / {row['bwd_library_ms']:.6f}"
                   f" ms")
        print(f"  forward: kernel {row['ms']:.6f} ms plain "
              f"{row['plain_ms']:.6f} ms bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']}{cuda_core_note(row)}); backward (K2a + "
              f"K2b with delta - dlse):"
              f" {row['bwd_ms']:.6f} ms plain {row['bwd_plain_ms']:.6f} ms "
              f"bound {row['bwd_bound_ms']:.6f} ms ({row['bwd_bound_by']}; "
              f"CUDA-core bound {row['bwd_cuda_core_bound_ms']:.6f} ms); "
              f"efficient-attention yardstick fwd / bwd {lib_txt}",
              flush=True)
        bad = [e for e in errs if not errs[e] <= tols[e]]
        if bad:
            raise SystemExit(f"K3 disagrees with its plain version on "
                             f"{name}: { {e: errs[e] for e in bad} }")
        grad64_check(torch, ak, name, (q, k, v, None, dout, lse_d, delta,
                                       causal, scale, 0.0, 0), grads)
        if tt == t:
            fwd64_check(torch, ak, name, (q, k, v, None, causal, scale, 0.0,
                                          0), out_d, lse_d)
        if tt == t and d == d0 and lib is not None:
            backward_vs_library(
                torch, ak, f"ring shard {tuple(q.shape)} causal {causal}",
                (q, k, v, None, causal, scale, 0.0, 0), dout, out_d, lse_d,
                lib[1], dlse=dlse)
    return rows


def ring_phase(torch):
    """The ring on a 4-way seq mesh whose entries are all cuda:0, at T
    2048, against full_attention on the card: outputs and grads, and K3
    (and K2a, K2b) launched once per computed (shard, step) pair; the
    same at head dim SP_RING_D80's (K3 takes every head dim up to 256).
    CUDA shards never take the blocked torch path: FLAGS_ring_flash=false
    raises."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel import ring_attention as ra

    p = SP_RING["seq"]
    mesh = make_mesh({"seq": p}, devices=[torch.device("cuda", 0)] * p)
    g = torch.Generator(device="cuda").manual_seed(SEED + 81)
    counters = {"k3": ak.flash_attention_with_lse,
                "dkv": ak.flash_attention_bwd_dkv,
                "dq": ak.flash_attention_bwd_dq}
    out = {}
    for ring_cfg, timed in ((SP_RING, True), (SP_RING_D80, False)):
        b, t, h, d = (ring_cfg[k] for k in ("b", "t", "h", "d"))
        phase(f"ring attention on a {p}-way seq mesh of cuda:0 at T {t}, "
              f"head dim {d}, against full attention")
        q, k, v, w = (torch.randn(b, t, h, d, generator=g, device="cuda")
                      for _ in range(4))
        for causal in (False, True):
            res = {}
            for ring in (True, False):
                leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                for c in counters.values():
                    c.launches = 0
                o = ra.ring_attention(*leaves, mesh, causal=causal) if ring \
                    else ra.full_attention(*leaves, causal=causal)
                res[ring] = [o] + list(torch.autograd.grad((o * w).sum(),
                                                           leaves))
                torch.cuda.synchronize()
                if ring:
                    launches = {n: c.launches for n, c in counters.items()}
            pairs = p * (p + 1) // 2 if causal else p * p
            want = {n: pairs for n in counters}
            errs = {n: max_err(torch, a, r) for n, a, r in
                    zip(("out", "dq", "dk", "dv"), res[True], res[False])}
            tols = {"out": TRAIN_ATOL["out"]["float32"]}
            tols.update((n, TRAIN_ATOL["grad"]["float32"])
                        for n in ("dq", "dk", "dv"))
            times = ""
            if timed:
                ring_ms = time_ms(torch, lambda: ra.ring_attention(
                    q, k, v, mesh, causal=causal), reps=10)
                full_ms = time_ms(torch, lambda: ra.full_attention(
                    q, k, v, causal=causal), reps=10)
                times = (f"; forward: ring {ring_ms:.6f} ms, full attention "
                         f"{full_ms:.6f} ms")
            print(f"causal {causal}: max_abs_err " + " ".join(
                f"{e} {errs[e]:.3e} (atol {tols[e]:g})" for e in errs) +
                f"; launches {launches} (expected {want}){times}",
                flush=True)
            if any(not errs[e] <= tols[e] for e in errs) or launches != want:
                raise SystemExit(f"the ring departs from full attention "
                                 f"(head dim {d}, causal {causal}): {errs}, "
                                 f"launches {launches}, expected {want}")
            out[(d, causal)] = {"errs": errs, "launches": launches}
    flags.set_flags({"ring_flash": "false"})
    try:
        ra.ring_attention(q[:1, :4 * p], q[:1, :4 * p], q[:1, :4 * p], mesh)
    except ValueError as e:
        if "CPU shards" not in str(e):
            raise
        print(f"FLAGS_ring_flash=false on the card raises: {e}", flush=True)
    else:
        raise SystemExit("the ring ran FLAGS_ring_flash=false on the card")
    finally:
        flags.set_flags({"ring_flash": "auto"})
    return out


def dryrun_state(fluid, dryrun, d_model, heads, micro):
    """(main, loss, startup state as numpy, feed) of the dry-run step at
    seq 512 x sp and batch 4 x dp, its startup run on the card from
    SEED."""
    from paddle_tpu_torch.core import unique_name

    dp, sp, pp = SP_MESH["data"], SP_MESH["seq"], SP_MESH["pipe"]
    seq_len = 512 * sp
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard(), fluid.program_guard(main, startup):
        loss = dryrun.dryrun_program(fluid, d_model, heads, seq_len, pp,
                                     micro)
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    state = {n: x.cpu().numpy() for n, x in scope.vars.items()
             if x is not None}
    return main, loss, state, dryrun.dryrun_feed(4 * dp, seq_len, SEED)


def sequence_parallel_phase(torch, smi):
    """The dp x tp x sp x pp step of __graft_entry__._dryrun_one through
    CompiledProgram over a mesh of cuda:0 entries: its losses within
    SP_LOSS_RTOL of the single-device run on the card (ring attention
    off the mesh: K1) and on the CPU; K3 and K2 launch counts, step
    time and the idle share.  Returns the mesh run's launches."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import dryrun
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.parallel import make_mesh

    dp, sp = SP_MESH["data"], SP_MESH["seq"]
    n_dev = int(np.prod(list(SP_MESH.values())))
    mesh = make_mesh(SP_MESH, devices=[torch.device("cuda", 0)] * n_dev)
    counters = {"k3": ak.flash_attention_with_lse,
                "fwd": ak.flash_attention,
                "dkv": ak.flash_attention_bwd_dkv,
                "dq": ak.flash_attention_bwd_dq}
    result = {}
    for label, d_model, heads, micro, with_cpu in SP_CONFIGS:
        phase(f"dp x tp x sp x pp step ({label}: d_model {d_model}, "
              f"{heads} heads) over {SP_MESH} on cuda:0, against one "
              f"device")
        main, loss, state, feed = dryrun_state(fluid, dryrun, d_model,
                                               heads, micro)
        places = [fluid.CUDAPlace(0)] + ([fluid.CPUPlace()] if with_cpu
                                         else [])
        runs = {}
        for place, on_mesh in [(places[0], True)] + [(pl, False)
                                                      for pl in places]:
            scope = fluid.io.state_from_numpy(state, scope=fluid.Scope(),
                                              place=place, main_program=main)
            exe = fluid.Executor(place)
            prog = main
            if on_mesh:
                prog = fluid.CompiledProgram(main).with_data_parallel(
                    loss_name=loss.name)
                prog._mesh = mesh
            steps = SP_TIMED_STEPS if on_mesh else SP_PARITY_STEPS
            on_card = isinstance(place, fluid.CUDAPlace)
            if on_card:
                torch.cuda.synchronize()
                for c in counters.values():
                    c.launches = 0
            losses, walls = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                losses.append(float(exe.run(prog, feed=feed,
                                            fetch_list=[loss],
                                            scope=scope)[0]))
                walls.append(time.perf_counter() - t0)
            launches = {n: c.launches for n, c in counters.items()} \
                if on_card else {}
            key = ("mesh" if on_mesh else "card") if on_card else "cpu"
            runs[key] = {"losses": losses, "walls": walls,
                         "launches": launches, "exe": exe, "prog": prog,
                         "scope": scope}
            print(f"{key}: losses {losses}, step walls "
                  f"{[round(w * 1e3, 3) for w in walls]} ms, launches "
                  f"{launches}", flush=True)
        mesh_losses = runs["mesh"]["losses"][:SP_PARITY_STEPS]
        rel = {k: max(abs(a - b) / abs(b) for a, b in
                      zip(mesh_losses, runs[k]["losses"]))
               for k in runs if k != "mesh"}
        pairs = dp * sp * (sp + 1) // 2       # causal (shard, step) pairs
        steps = SP_TIMED_STEPS
        # per step: the ring's K3 in the forward op and again in the
        # generic grad's recompute; K2a and K2b once per pair
        want = {"k3": 2 * pairs * steps, "fwd": 2 * pairs * steps,
                "dkv": pairs * steps, "dq": pairs * steps}
        want_card = {"k3": 0, "fwd": 2 * SP_PARITY_STEPS,
                     "dkv": SP_PARITY_STEPS, "dq": SP_PARITY_STEPS}
        step_ms = statistics.median(runs["mesh"]["walls"][1:]) * 1e3
        print(f"[{smi}] {label}: mesh step {step_ms:.6f} ms (median of "
              f"steps 2-{steps}; first {runs['mesh']['walls'][0] * 1e3:.6f}"
              f" ms); single-device card step "
              f"{statistics.median(runs['card']['walls'][1:]) * 1e3:.6f} ms"
              f"; relative loss differences of the mesh run {rel} (bound "
              f"{SP_LOSS_RTOL:g}); mesh launches {runs['mesh']['launches']}"
              f" (expected {want}), card launches "
              f"{runs['card']['launches']} (expected {want_card})",
              flush=True)
        finite = all(np.isfinite(r["losses"]).all() for r in runs.values())
        if not finite or max(rel.values()) > SP_LOSS_RTOL:
            raise SystemExit(f"{label}: the mesh step departs from one "
                             f"device: {rel}")
        if runs["mesh"]["launches"] != want or \
                runs["card"]["launches"] != want_card:
            raise SystemExit(f"{label}: launches {runs['mesh']['launches']}"
                             f" / {runs['card']['launches']}, expected "
                             f"{want} / {want_card}")
        if with_cpu:
            m = runs["mesh"]

            def one_step():
                m["exe"].run(m["prog"], feed=feed, fetch_list=[loss],
                             scope=m["scope"])

            prof = profile_run(torch, one_step, f"one dp x tp x sp x pp "
                               f"step ({label})", smi)
            result = {"launches": m["launches"], "step_ms": step_ms,
                      "idle": 1.0 - prof["busy"] / prof["wall"]}
        del runs
        torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# the dense image slice: LeNet-5 and ResNet-50 (cuDNN; no hand kernel)
# ---------------------------------------------------------------------------

def lenet_program(fluid):
    """bench.py::bench_mnist's program, seeds fixed to SEED."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        conv1 = fluid.nets.simple_img_conv_pool(
            input=img, filter_size=5, num_filters=6, pool_size=2,
            pool_stride=2, act="relu")
        conv2 = fluid.nets.simple_img_conv_pool(
            input=conv1, filter_size=5, num_filters=16, pool_size=2,
            pool_stride=2, act="relu")
        pred = fluid.layers.fc(input=conv2, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9) \
            .minimize(loss)
    return main, startup, loss


def lenet_phase(torch, smi):
    """LeNet-5 at bench_mnist's configuration: card vs CPU, then timed."""
    import paddle_tpu_torch as fluid

    t_phase = time.perf_counter()
    phase(f"LeNet-5 (bench_mnist): batch {LENET_B}, Momentum 0.01/0.9")
    main, startup, loss = lenet_program(fluid)
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(LENET_B, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (LENET_B, 1)).astype(np.int64)}
    card_vs_cpu(fluid, main, startup, loss, [feed] * 3,
                f"LeNet-5 batch {LENET_B}", min_move=MIN_MOVE)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    walls = []
    for i in range(LENET_WARMUP + LENET_ITERS):
        t0 = time.perf_counter()
        (value,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        if i >= LENET_WARMUP:
            walls.append(time.perf_counter() - t0)
    step = statistics.median(walls)
    if not np.isfinite(value):
        raise SystemExit(f"LeNet-5 loss is not finite: {value}")
    print(f"[{smi}] LeNet-5: step {step * 1e3:.6f} ms (median of "
          f"{LENET_ITERS} after {LENET_WARMUP}; each fetches its loss), "
          f"{LENET_B / step:.3f} examples/s, "
          f"{len(main.global_block().ops)} ops a step", flush=True)
    prof = profile_run(torch, lambda: exe.run(main, feed=feed,
                                              fetch_list=[loss],
                                              scope=scope),
                       f"one LeNet-5 step (batch {LENET_B})", smi)
    print(f"[{smi}] LeNet-5 phase: {time.perf_counter() - t_phase:.3f} s")
    return {"step_ms": step * 1e3, "examples_s": LENET_B / step,
            "busy": prof["busy"], "wall": prof["wall"]}


def resnet50_program(fluid, is_test=False, optimizer=None):
    """bench.py::bench_resnet50's program at amp=False (its reader and
    read_file, resnet_imagenet depth 50, Momentum 0.001/0.9, or
    `optimizer`(fluid) where given), seeds fixed to SEED; with `is_test`,
    __graft_entry__.entry's forward.  Names are fresh, so the two
    programs' parameters share theirs."""
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if is_test:
            img = fluid.layers.data(name="img", shape=[3, R50_HW, R50_HW],
                                    dtype="float32")
            return main, startup, resnet.resnet_imagenet(
                img, class_dim=1000, depth=50, is_test=True)
        reader = fluid.layers.py_reader(
            capacity=4, shapes=[(-1, 3, R50_HW, R50_HW), (-1, 1)],
            dtypes=["float32", "int64"], name="bench_reader",
            cache_on_device=True)
        img, label = fluid.layers.read_file(reader)
        pred = resnet.resnet_imagenet(img, class_dim=1000, depth=50)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        opt = fluid.optimizer.Momentum(learning_rate=0.001, momentum=0.9) \
            if optimizer is None else optimizer(fluid)
        opt.minimize(loss)
    return main, startup, loss, reader


def image_batch(rng, b):
    return (rng.randn(b, 3, R50_HW, R50_HW).astype(np.float32),
            rng.randint(0, 1000, (b, 1)).astype(np.int64))


def resnet50_inference_check(fluid, state):
    """__graft_entry__.entry's forward (is_test, [8, 3, 224, 224]) on the
    card against the CPU: the logits (the last softmax's input) within
    PARITY_RTOL[1] of their largest magnitude, the probabilities of
    theirs.  The moving statistics are first calibrated: one
    training-mode forward on the CPU with momentum 0 makes them one
    batch's statistics (at the startup's 0 and 1 the is_test activations
    grow without bound and the softmax saturates to 0 and 1)."""
    main, _, pred = resnet50_program(fluid, is_test=True)
    logits = [op for op in main.global_block().ops
              if op.type == "softmax"][-1].inputs["X"][0]
    calib = main.clone()
    for op in calib.global_block().ops:
        if op.type == "batch_norm":
            op.attrs.update(is_test=False, momentum=0.0)
    calib._is_test = False
    rng = np.random.RandomState(SEED + 20)
    scope = fluid.io.state_from_numpy(state, scope=fluid.Scope(),
                                      place=fluid.CPUPlace(),
                                      main_program=main)
    cpu = fluid.Executor(fluid.CPUPlace())
    cpu.run(calib, feed={"img": image_batch(rng, 8)[0]}, fetch_list=[pred],
            scope=scope)
    state = host_state(scope)
    img = image_batch(rng, 8)[0]
    want = cpu.run(main, feed={"img": img}, fetch_list=[logits, pred],
                   scope=scope)
    card_scope = fluid.io.state_from_numpy(state, scope=fluid.Scope(),
                                           place=fluid.CUDAPlace(0),
                                           main_program=main)
    got = fluid.Executor(fluid.CUDAPlace(0)).run(
        main, feed={"img": img}, fetch_list=[logits, pred],
        scope=card_scope)
    errs = [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]
    print(f"ResNet-50 is_test forward [8, 3, {R50_HW}, {R50_HW}] "
          f"(__graft_entry__.entry): logits max |cpu| "
          f"{np.abs(want[0]).max():.6f}, softmax max {want[1].max():.6f}; "
          f"card vs CPU max |diff| / max |cpu| {errs[0]:.3e} on the logits, "
          f"{errs[1]:.3e} on the softmax (bound {PARITY_RTOL[1]:g} each); "
          f"top-1 equal on "
          f"{int((got[1].argmax(1) == want[1].argmax(1)).sum())} of 8",
          flush=True)
    if not all(np.isfinite(g).all() for g in got) or \
            max(errs) > PARITY_RTOL[1]:
        raise SystemExit(f"ResNet-50 inference: the card departs from the "
                         f"CPU by {errs}")


def resnet50_parity(fluid, main, startup, loss, reader):
    """Three forced card steps against the CPU on each of two batches of
    R50_PARITY_B, then the is_test forward."""
    slots = [v.name for v in reader.feed_vars]
    for seed in (SEED + 21, SEED + 22):
        img, label = image_batch(np.random.RandomState(seed), R50_PARITY_B)
        card_vs_cpu(fluid, main, startup, loss,
                    [dict(zip(slots, (img, label)))] * 3,
                    f"ResNet-50 batch {R50_PARITY_B} (seed {seed})",
                    min_move=MIN_MOVE, forced=True)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    resnet50_inference_check(fluid, host_state(init))


def resnet50_phase(torch, smi):
    """ResNet-50 at bench_resnet50's fp32 configuration through the
    port's py_reader: card vs CPU, the is_test forward, then timed."""
    import paddle_tpu_torch as fluid

    t_phase = time.perf_counter()
    phase(f"ResNet-50 (bench_resnet50, amp=False): batch {R50_B}, "
          f"{R50_HW}x{R50_HW}, Momentum 0.001/0.9, fp32, TF32 off")
    main, startup, loss, reader = resnet50_program(fluid)
    resnet50_parity(fluid, main, startup, loss, reader)
    t_parity = time.perf_counter() - t_phase

    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)               # bench.py's pool
    pool = [image_batch(rng, R50_B) for _ in range(4)]
    # + the window, the profile and the cudnn.benchmark steps
    n_steps = R50_WARMUP + R50_ITERS + 2 + R50_WARMUP + R50_ITERS // 2
    reader.decorate_batch_generator(
        lambda: (pool[i % len(pool)] for i in range(n_steps)))
    reader.start()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(R50_WARMUP + R50_ITERS):
        t0 = time.perf_counter()
        (out,) = exe.run(main, fetch_list=[loss], scope=scope,
                         return_numpy=False)
        torch.cuda.synchronize()
        if i >= R50_WARMUP:
            walls.append(time.perf_counter() - t0)
    # bench.py's own window: no synchronisation between steps
    t0 = time.perf_counter()
    (out,) = exe.run(main, fetch_list=[loss], scope=scope,
                     return_numpy=False)
    final = float(out.item())
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step = statistics.median(walls)
    ips = R50_B / step
    n_ops = len(main.global_block().ops)
    print(f"[{smi}] ResNet-50 fp32 batch {R50_B}: step {step * 1e3:.6f} ms "
          f"(median of {R50_ITERS} after {R50_WARMUP}, each ended by a "
          f"synchronisation; min {min(walls) * 1e3:.6f}, max "
          f"{max(walls) * 1e3:.6f}), {ips:.3f} images/s; one unsynchronised "
          f"step after them {window * 1e3:.6f} ms; peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB); {n_ops} ops a step; share of the "
          f"fp32 bound ({R50_FLOP_PER_IMAGE / 1e9:g} GFLOP an image at "
          f"{PEAK_FLOPS['float32'] / 1e12:g} TFLOP/s, least step "
          f"{R50_B * R50_FLOP_PER_IMAGE / PEAK_FLOPS['float32'] * 1e3:.3f} "
          f"ms) {ips * R50_FLOP_PER_IMAGE / PEAK_FLOPS['float32']:.4f}; "
          f"loss {final:.6f}", flush=True)
    if not np.isfinite(final):
        raise SystemExit(f"ResNet-50 loss is not finite: {final}")
    prof = profile_run(torch, lambda: exe.run(main, fetch_list=[loss],
                                              scope=scope),
                       f"one ResNet-50 step (batch {R50_B}, through "
                       f"py_reader)", smi)
    print(f"ResNet-50: {n_ops} ops and {prof['calls']} torch operator calls "
          f"a step; the reader's device cache holds "
          f"{len(reader._dev_cache)} arrays ({reader._cache_bytes} bytes)")
    # what cuDNN's own algorithm search would give (printed only: the
    # port leaves torch.backends.cudnn.benchmark to its user, off by
    # default, and so does every number above)
    torch.backends.cudnn.benchmark = True
    try:
        tuned = []
        for i in range(R50_WARMUP + R50_ITERS // 2):
            t0 = time.perf_counter()
            exe.run(main, fetch_list=[loss], scope=scope, return_numpy=False)
            torch.cuda.synchronize()
            if i >= R50_WARMUP:
                tuned.append(time.perf_counter() - t0)
    finally:
        torch.backends.cudnn.benchmark = False
    print(f"[{smi}] ResNet-50 with torch.backends.cudnn.benchmark on: step "
          f"{statistics.median(tuned) * 1e3:.6f} ms (median of "
          f"{len(tuned)} after {R50_WARMUP}), "
          f"{R50_B / statistics.median(tuned):.3f} images/s (not gated)")
    try:
        exe.run(main, fetch_list=[loss], scope=scope)
        raise SystemExit("ResNet-50: the reader did not end its epoch")
    except fluid.EOFException:
        pass
    reader.reset()
    print(f"[{smi}] ResNet-50 phase: {time.perf_counter() - t_phase:.3f} s "
          f"({t_parity:.3f} s of it card vs CPU)")
    del exe, scope
    torch.cuda.empty_cache()
    return {"step_ms": step * 1e3, "images_s": ips, "peak": peak,
            "busy": prof["busy"], "wall": prof["wall"]}


# ---------------------------------------------------------------------------
# bf16 AMP: the headline configurations (bench.py at amp=True)
# ---------------------------------------------------------------------------

def bf16_keys(row, launches):
    """A kernel's bf16 row at an AMP path's shape, as bf16_* keys of the
    kernels line."""
    return {"bf16_launches": launches,
            **{f"bf16_{k}": row[k] for k in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")}}


class _Tally:
    """One (kernel name, dtype) entry of launch_dtypes' dict as a launch
    counter, which a CUDA-graph capture notes and its replays add to."""

    def __init__(self, seen, key):
        self.seen, self.key = seen, key

    @property
    def launches(self):
        return self.seen.get(self.key, 0)

    @launches.setter
    def launches(self, n):
        self.seen[self.key] = n


class launch_dtypes:
    """Count the operand dtype of every K1, K2a, K2b and K10 launch made
    on the card inside the block: {(kernel name, dtype): launches}.  A
    replayed CUDA graph runs no wrapper, so each entry is also a launch
    counter of ``cuda_build.launch_counters`` while the block is open: a
    capture inside the block notes its delta, and every replay adds it
    (the block must hold the capture, and so the signature's first,
    op-by-op run too)."""

    def __enter__(self):
        from paddle_tpu_torch.ops import attention_kernels as ak
        from paddle_tpu_torch.ops import cuda_build
        from paddle_tpu_torch.ops import dropout_kernels as dk

        self.seen = {}
        self.mods = (ak, dk, cuda_build)
        self.saved = (ak._launch, dk.fused_dropout_fwd,
                      cuda_build.launch_counters)
        launch, drop, counters = self.saved
        tallies = {}

        def all_counters():
            for key in self.seen:
                tallies.setdefault(key, _Tally(self.seen, key))
            return counters() + list(tallies.values())

        def note(name, t):
            if t.device.type == "cuda":
                key = (name, str(t.dtype).replace("torch.", ""))
                self.seen[key] = self.seen.get(key, 0) + 1

        def rec_launch(name, q, *a, **kw):
            note(name, q)
            return launch(name, q, *a, **kw)

        def rec_drop(x, *a, **kw):
            note("fused_dropout", x)
            return drop(x, *a, **kw)

        ak._launch, dk.fused_dropout_fwd = rec_launch, rec_drop
        cuda_build.launch_counters = all_counters
        return self.seen

    def __exit__(self, *exc):
        ak, dk, cuda_build = self.mods
        ak._launch, dk.fused_dropout_fwd, cuda_build.launch_counters = \
            self.saved


def check_launch_dtypes(seen, label, main, steps, attention=True):
    """K1, K2a and K2b (with `attention`) launched on bf16 operands
    only; K10 on bf16 operands twice a step for each dropout op the AMP
    plan (the pass pipeline's ``__amp__`` annotations of the program the
    run took) marks bf16.  A dropout the plan leaves unmarked follows
    its input, as in the JAX package: BERT's embedding dropout, after its
    fp32 layer norm, runs K10 in fp32."""
    print(f"{label}: launches by operand dtype {seen}")
    ran = next(iter(main._pass_memo.values()))[0]
    drops = [op.attrs.get("__amp__") for op in ran.global_block().ops
             if op.type == "dropout" and 0 < op.attrs.get("dropout_prob",
                                                          0.5) < 1]
    attn = ("flash_attention_fwd", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq") if attention else ()
    bad = {k: n for k, n in seen.items() if k[0] in attn and
           k[1] != "bfloat16"}
    missing = [k for k in attn if (k, "bfloat16") not in seen]
    want = 2 * steps * drops.count("bf16")
    got = seen.get(("fused_dropout", "bfloat16"), 0)
    if bad or missing or got != want:
        raise SystemExit(f"{label}: K1/K2a/K2b not all on bf16 operands "
                         f"({bad or missing}), or K10 on bf16 {got} times "
                         f"where the plan gives {want}: {seen}")


def amp_kernel_phase(torch):
    """K1, K2a, K2b and K10 in bf16 at the AMP paths' shapes, against
    their plain versions on the same tensors, timed beside the plain
    versions, the library call and the bound: bench_bert's attention
    (batch 128, 12 heads, T 128, D 64, a row padding bias rounded to
    bf16 as the gray rule rounds it, dropout 0.1), bench_nmt's at the T
    64 bucket (64 x 8 heads, a full bias in bf16, dropout 0.1), and the
    dropouts of both (BERT's hidden and FFN planes, downgrade_in_infer;
    NMT's FFN plane, upscale_in_train), bit for bit."""
    from paddle_tpu_torch.models.transformer import make_attn_biases
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import dropout_kernels as dk

    phase("bf16 kernels at the AMP paths' shapes (K1, K2a, K2b, K10)")
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    b, h, t, d = AMP_BERT_B, BERT_BASE["num_heads"], TRAIN_T, 64
    lens = torch.randint(t // 4, t + 1, (b,), generator=g, device="cuda")
    pad = (torch.arange(t, device="cuda")[None, :] >= lens[:, None])
    bert = ("amp_bert_b128_row_bf16_drop",
            *[torch.randn(b, h, t, d, generator=g, device="cuda").to(bf16)
              for _ in range(3)],
            (pad.float() * -10000.0).reshape(b, 1, 1, t).to(bf16),
            False, 0.1, False)
    t2, h2 = max(NMT_BUCKETS), NMT["n_head"]
    b2, d2 = NMT_TOKENS // t2, NMT["d_model"] // h2
    nlens = np.random.RandomState(SEED + 31).randint(t2 // 2 + 1, t2 + 1, b2)
    _, trg_bias, _ = make_attn_biases(nlens, nlens, h2, t2, t2)
    nmt = (f"amp_nmt_t{t2}_full_bf16_drop",
           *[torch.randn(b2, h2, t2, d2, generator=g, device="cuda")
             .to(bf16) for _ in range(3)],
           torch.from_numpy(trg_bias).cuda().to(bf16), False, 0.1, False)
    rows = {"fwd": {}, "dkv": {}, "dq": {}}
    for i, case in enumerate((bert, nmt)):
        attention_case(torch, ak, case, SEED + 40 + i, rows)
    drop = {}
    for name, shape, upscale in (
            ("amp_bert_b128_t128_d768", (b, t, 768), False),
            ("amp_bert_b128_t128_d3072", (b, t, 3072), False),
            ("amp_nmt_b128_t32_d2048", (128, 32, 2048), True)):
        x = torch.randn(shape, generator=g, device="cuda").to(bf16)
        cot = torch.randn(shape, generator=g, device="cuda").to(bf16)
        leaf = x.detach().requires_grad_()
        out = dk.fused_dropout(leaf, 0.1, SEED, upscale)
        (dx,) = torch.autograd.grad(out, leaf, cot)
        ref_leaf = x.detach().requires_grad_()
        ref = dk.fused_dropout_reference(ref_leaf, 0.1, SEED, upscale)
        (dref,) = torch.autograd.grad(ref, ref_leaf, cot)
        torch.cuda.synchronize()
        if not (bits_equal(torch, out, ref) and bits_equal(torch, dx, dref)):
            raise SystemExit(f"fused_dropout bf16 disagrees with its plain "
                             f"version on {name}")
        n = x.numel()
        drop[name] = {
            "max_abs_err": max(max_err(torch, out, ref),
                               max_err(torch, dx, dref)),
            **bound_row(2 * 2 * n, n, "bfloat16"),
            "ms": time_ms(torch, lambda: dk.fused_dropout_fwd(
                x, 0.1, SEED, upscale)),
            "plain_ms": time_ms(torch, lambda: dk.fused_dropout_reference(
                x, 0.1, SEED, upscale)),
            "library_ms": time_ms(torch, lambda: torch.nn.functional
                                  .dropout(x, 0.1, training=True))}
        r = drop[name]
        print(f"fused_dropout {name} {shape} bf16 p 0.1 upscale {upscale}: "
              f"Out and grad equal bit for bit; kernel {r['ms']:.6f} ms "
              f"plain {r['plain_ms']:.6f} ms F.dropout "
              f"{r['library_ms']:.6f} ms bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})", flush=True)
    torch.cuda.empty_cache()
    return rows, drop


class op_replay:
    """Inside the block, each op that an Executor's interpreter loop runs
    (``registry.run_op``, not its nested calls) runs again on `device`,
    on copies of its inputs taken before the run's own kernel: under AMP
    as the run does, and in fp32 without AMP (every bf16 input cast up)
    as the control.  For each float output of the run's, a row goes to
    the list the block gets: (op, slot, name, the replay's gap, the
    control's gap, a planted no-op's gap, the dtypes equal).  A gap is
    the 2-norm distance from the run's output over the run's output's
    norm; for an output that updates its input in place (the same
    name), over the change, and then the planted no-op (the input left
    as it was) gaps by 1; elsewhere the planted gap is None.  An output
    the replay does not give gaps by inf."""

    def __init__(self, device):
        self.device, self.rows, self.depth = device, [], 0

    def __enter__(self):
        from paddle_tpu_torch.ops import registry

        self.registry, self.run_op = registry, registry.run_op
        registry.run_op = self.replay
        return self.rows

    def __exit__(self, *exc):
        self.registry.run_op = self.run_op

    def nested(self, op_type, ins, attrs):
        self.depth += 1
        try:
            return self.run_op(op_type, ins, attrs)
        finally:
            self.depth -= 1

    def replay(self, op_type, ins, attrs):
        import torch

        if self.depth:
            return self.run_op(op_type, ins, attrs)
        reg = self.registry
        run = reg.current()
        op = run.op
        dev = {s: [v.to(self.device, copy=True)
                   if isinstance(v, torch.Tensor) else v for v in vs]
               for s, vs in ins.items()}
        outs = self.nested(op_type, ins, attrs)
        f32 = {s: [v.float() if isinstance(v, torch.Tensor) and
                   v.dtype == torch.bfloat16 else v for v in vs]
               for s, vs in dev.items()}
        got = []
        for amp, operands in ((True, dev), (False, f32)):
            ctx = reg.ExecContext(device=self.device, seed=run.seed,
                                  step=run.step, is_test=run.is_test,
                                  masks={}, reads=run.reads, amp=amp)
            ctx.op = op
            with reg.exec_context(ctx):
                got.append(self.nested(op_type, operands, attrs))
        self.compare(op, dev, outs, *got)
        return outs

    def compare(self, op, ins, outs, card, control):
        import torch

        name = op.attrs.get("fw_type", op.type) + (
            "_grad" if op.type == "generic_grad" else "")
        if op.attrs.get("fw_attrs", op.attrs).get("pooling_type") == "max":
            name += "[max]"
        given = {n: v for s, names in op.inputs.items()
                 for n, v in zip(names, ins.get(s, []))}
        for slot, names in op.outputs.items():
            for i, (n, c) in enumerate(zip(names, outs.get(slot, []))):
                if not isinstance(c, torch.Tensor) or \
                        not c.dtype.is_floating_point or c.numel() == 0:
                    continue
                before = given.get(n)
                if not isinstance(before, torch.Tensor):
                    before = None
                base = 0 if before is None else before.double()
                ref = c.to(self.device).double() - base
                scale = float(ref.norm())

                def gap(x):
                    if not isinstance(x, torch.Tensor):
                        return float("inf")
                    off = float((x.double() - base - ref).norm())
                    return off / scale if scale else (
                        0.0 if off == 0 else float("inf"))

                outs_of = [r.get(slot, []) for r in (card, control)]
                g, k = (o[i] if i < len(o) else None for o in outs_of)
                self.rows.append((
                    name, slot, n, gap(g), gap(k),
                    None if before is None else gap(before),
                    isinstance(g, torch.Tensor) and g.dtype == c.dtype))


def op_gate(gap, control, name=None):
    """Whether an output of op `name` whose replay gaps by `gap` and
    whose control by `control` passes (see AMP_OP_RTOL, AMP_OP_TIED)."""
    if name in AMP_OP_TIED:
        return gap <= AMP_OP_RTOL
    if control >= AMP_OP_MATERIAL:
        return gap <= AMP_OP_RTOL and gap < 0.5 * control
    return gap <= AMP_OP_MATERIAL


def amp_resnet50_parity(torch, fluid, main, startup, loss, feed):
    """ResNet-50's AMP step, card against CPU, AMP_PARITY_STEPS times on
    one batch.  Each card step (the Executor's, from the CPU's state
    before it) gives a loss within AMP_R50_RTOL of the CPU's, and each
    CPU step is replayed on the card op by op (op_replay), every output
    passing op_gate.  The gate must refuse a planted no-op of every
    output that updates state in place (a step that leaves parameters,
    velocities or moving statistics as they were), and the fp32 control
    wherever the precision moves an output: the convolutions' and the
    batch norms' forward and backward among them."""
    label = f"AMP ResNet-50 batch {R50_PARITY_B}"
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    card_exe = fluid.Executor(fluid.CUDAPlace(0))
    init = fluid.Scope()
    cpu_exe.run(startup, scope=init)

    def scope_of(state, place):
        return fluid.io.state_from_numpy(state, scope=fluid.Scope(),
                                         place=place, main_program=main)

    cpu_scope = scope_of(host_state(init), fluid.CPUPlace())
    losses, rows = [], []
    for _ in range(AMP_PARITY_STEPS):
        card_scope = scope_of(host_state(cpu_scope), fluid.CUDAPlace(0))
        card = float(card_exe.run(main, feed=feed, fetch_list=[loss],
                                  scope=card_scope)[0])
        del card_scope
        with op_replay(torch.device("cuda")) as seen:
            cpu = float(cpu_exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=cpu_scope)[0])
        losses.append((card, cpu))
        rows += seen
    rel = [abs(a - b) / abs(b) for a, b in losses]
    print(f"{label}, each card step from the CPU's state before it: "
          f"(card, cpu) losses {losses}, relative {rel} (bound "
          f"{AMP_R50_RTOL:g})", flush=True)
    by_op = {}
    for r in rows:
        by_op.setdefault(r[0], []).append(r)
    for name, rs in sorted(by_op.items()):
        material = [r for r in rs if r[4] >= AMP_OP_MATERIAL]
        print(f"  {name}: {len(rs)} outputs, worst {max(r[3] for r in rs):.3e}"
              f"; {len(material)} where the fp32 control moves the output, "
              f"worst share of the control's distance "
              f"{max((r[3] / r[4] for r in material), default=0.0):.3f}, "
              f"control {min((r[4] for r in material), default=0.0):.3e} to "
              f"{max((r[4] for r in material), default=0.0):.3e}",
              flush=True)
    bad = [r for r in rows if not (op_gate(r[3], r[4], r[0]) and r[6])]
    planted = [r for r in rows if r[5] is not None]
    noop_passed = [r for r in planted if op_gate(r[5], r[4], r[0])]
    refused = {r[0] for r in rows if not op_gate(r[4], r[4], r[0])}
    want = {"conv2d", "conv2d_grad", "batch_norm", "batch_norm_grad"}
    print(f"{label}, op by op on the card (bounds {AMP_OP_RTOL:g}, half the "
          f"fp32 control's distance where it is {AMP_OP_MATERIAL:g} or "
          f"more, else {AMP_OP_MATERIAL:g}): {len(rows)} outputs over "
          f"{AMP_PARITY_STEPS} steps, {len(bad)} refused {bad[:20]}; a "
          f"planted no-op of the {len(planted)} outputs that update state "
          f"refused at {len(planted) - len(noop_passed)}; the fp32 control "
          f"refused at {sum(not op_gate(r[4], r[4], r[0]) for r in rows)} "
          f"outputs of {sorted(refused)}", flush=True)
    if not np.isfinite(losses).all() or max(rel) > AMP_R50_RTOL:
        raise SystemExit(f"{label}: the card's loss departs from the "
                         f"CPU's: {rel}")
    if bad:
        raise SystemExit(f"{label}: {len(bad)} outputs on the card depart "
                         f"from the CPU's: {bad[:20]}")
    updates = sum(op.type == "momentum" for op in main.global_block().ops)
    if noop_passed or len(planted) < 2 * updates * AMP_PARITY_STEPS:
        raise SystemExit(f"{label}: the gate lets a planted no-op through "
                         f"({noop_passed[:20]}), or too few outputs update "
                         f"state ({len(planted)})")
    if not want <= refused:
        raise SystemExit(f"{label}: the fp32 control passes every output "
                         f"of {sorted(want - refused)}: the gate cannot "
                         f"tell their precision")


def amp_parity_phase(torch):
    """Card against CPU, both under AMP: the 2-layer BERT-base-width
    pretraining at dropout 0 and 0.1 (3 Adam steps, every dropout
    through K10 on the card, the same bits as the CPU's plain version),
    K1, K2a, K2b and K10 launched on bf16 operands; then ResNet-50 at
    batch 8, 224x224 (amp_resnet50_parity): each card step's loss, and
    each CPU step replayed on the card op by op."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import dropout_kernels as dk

    mp = fluid.contrib.mixed_precision
    phase("AMP parity: 2-layer BERT-base width and ResNet-50, card vs CPU, "
          "both in bf16")
    t0 = time.perf_counter()
    fluid.set_flags({"use_fused_dropout": True})
    counters = (ak.flash_attention, ak.flash_attention_bwd_dkv,
                ak.flash_attention_bwd_dq, dk.fused_dropout)
    feed = pretrain_feed(8, TRAIN_T, TRAIN_M, SEED)
    for dropout in (0.0, 0.1):
        main, startup, loss = pretrain_program(fluid, 2, dropout)
        mp.enable(main)
        with launch_dtypes() as seen:
            launches = card_vs_cpu(fluid, main, startup, loss, [feed] * 3,
                                   f"AMP 2-layer BERT-base width, dropout "
                                   f"{dropout}", counters=counters,
                                   rtol=AMP_PARITY_RTOL)
        check_launch_dtypes(seen, f"AMP BERT parity, dropout {dropout}",
                            main, 3)
        if not all(launches[c.__name__] for c in counters[:3]):
            raise SystemExit(f"AMP BERT parity: launches {launches}")
    fluid.set_flags({"use_fused_dropout": False})
    t_bert = time.perf_counter() - t0

    main, startup, loss, reader = resnet50_program(fluid)
    mp.enable(main)
    slots = [v.name for v in reader.feed_vars]
    img, label = image_batch(np.random.RandomState(SEED + 23), R50_PARITY_B)
    amp_resnet50_parity(torch, fluid, main, startup, loss,
                        dict(zip(slots, (img, label))))
    print(f"AMP parity phase: {time.perf_counter() - t0:.3f} s ({t_bert:.3f}"
          f" s of it BERT)", flush=True)
    torch.cuda.empty_cache()


def amp_steps(torch, exe, main, loss, scope, feeds, counters):
    """Warm-up steps, then timed steps (each ended by a synchronisation)
    with the counters set to 0 just before them and read just after, and
    every launch's operand dtype counted over the warm-up and timed
    steps (the warm-up holds the CUDA-graph capture whose launches the
    replays count): (losses, walls, launches, dtypes, peak memory)."""
    def step(feed):
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                      return_numpy=False)[0]
        torch.cuda.synchronize()
        return out

    losses, walls = [], []
    with launch_dtypes() as seen:
        for feed in feeds[:AMP_WARMUP]:
            step(feed)
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        for feed in feeds[AMP_WARMUP:]:
            t0 = time.perf_counter()
            out = step(feed)
            walls.append(time.perf_counter() - t0)
            losses.append(float(out.float().item()))
    launches = {k: c.launches for k, c in counters.items()}
    return losses, walls, launches, seen, torch.cuda.max_memory_allocated()


def amp_training_phase(torch, smi):
    """bench.py's three headline programs at amp=True on the card, full
    width: BERT-base pretraining (batch 128, seq 128, Adam 1e-4),
    ResNet-50 (batch 128, 224x224, Momentum, through py_reader) and
    transformer-base NMT (4096 tokens at T 16, 32, 64), every dropout
    through K10: step time, throughput, peak memory, ops and torch calls
    a step, a profile of one step, and K1/K2a/K2b/K10 launches a step on
    bf16 operands equal to the fp32 paths' counts."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import dropout_kernels as dk

    mp = fluid.contrib.mixed_precision
    counters = {"fwd": ak.flash_attention, "dkv": ak.flash_attention_bwd_dkv,
                "dq": ak.flash_attention_bwd_dq, "dropout": dk.fused_dropout}
    t_phase = time.perf_counter()
    out = {}
    fluid.set_flags({"use_fused_dropout": True})

    def per_step(launches, steps, ops):
        n_attn = sum(op.type == "fused_attention" for op in ops)
        n_drop = sum(op.type == "dropout" for op in ops)
        want = {"fwd": 2 * n_attn, "dkv": n_attn, "dq": n_attn,
                "dropout": 2 * n_drop}
        got = {k: v / steps for k, v in launches.items()}
        print(f"launches a step {got} (expected {want}: K1 in the forward "
              f"and the grad's recompute, K2a/K2b once, K10 forward and "
              f"backward of each dropout)")
        if got != want:
            raise SystemExit(f"AMP launches a step {got}, expected {want}")
        return {k: int(v) for k, v in got.items()}

    # BERT-base
    phase(f"AMP training BERT-base: 12 layers, batch {AMP_BERT_B}, seq "
          f"{TRAIN_T}, dropout 0.1 through K10, Adam 1e-4, bf16")
    main, startup, loss = pretrain_program(fluid, 12, 0.1)
    mp.enable(main)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    feeds = [pretrain_feed(AMP_BERT_B, TRAIN_T, AMP_BERT_M, SEED + 32 + i)
             for i in range(2)]
    feeds = [feeds[i % 2] for i in range(AMP_WARMUP + AMP_STEPS)]
    losses, walls, launches, seen, peak = amp_steps(
        torch, exe, main, loss, scope, feeds, counters)
    check_launch_dtypes(seen, "AMP BERT-base", main,
                        AMP_WARMUP + AMP_STEPS)
    step = statistics.median(walls)
    ops = main.global_block().ops
    print(f"[{smi}] AMP BERT-base batch {AMP_BERT_B}: step "
          f"{step * 1e3:.6f} ms (median of {AMP_STEPS} after {AMP_WARMUP}),"
          f" {AMP_BERT_B * TRAIN_T / step:.3f} tokens/s, peak memory {peak}"
          f" bytes ({peak / 2**30:.3f} GiB), {len(ops)} ops; losses "
          f"{losses}", flush=True)
    if not np.isfinite(losses).all():
        raise SystemExit(f"AMP BERT-base losses are not finite: {losses}")
    bert_launches = per_step(launches, AMP_STEPS, ops)
    prof = profile_run(torch, lambda: exe.run(main, feed=feeds[0],
                                              fetch_list=[loss],
                                              scope=scope),
                       f"one AMP BERT-base step (batch {AMP_BERT_B})", smi)
    out["bert"] = {"step_ms": step * 1e3, "launches": bert_launches,
                   "tokens_s": AMP_BERT_B * TRAIN_T / step, "peak": peak,
                   "busy": prof["busy"], "wall": prof["wall"]}
    del exe, scope
    torch.cuda.empty_cache()

    # ResNet-50
    phase(f"AMP training ResNet-50: batch {R50_B}, {R50_HW}x{R50_HW}, "
          f"Momentum 0.001/0.9, bf16, through py_reader")
    main, startup, loss, reader = resnet50_program(fluid)
    mp.enable(main)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)               # bench.py's pool
    pool = [image_batch(rng, R50_B) for _ in range(4)]
    n_steps = AMP_WARMUP + R50_ITERS + 1         # + the profiled step
    reader.decorate_batch_generator(
        lambda: (pool[i % len(pool)] for i in range(n_steps)))
    reader.start()
    losses, walls, _, _, peak = amp_steps(
        torch, exe, main, loss, scope,
        [None] * (AMP_WARMUP + R50_ITERS), {})
    step = statistics.median(walls)
    ips = R50_B / step
    share = ips * R50_FLOP_PER_IMAGE / PEAK_FLOPS["bfloat16"]
    least = R50_B * R50_FLOP_PER_IMAGE / PEAK_FLOPS["bfloat16"] * 1e3
    n_ops = len(main.global_block().ops)
    print(f"[{smi}] AMP ResNet-50 batch {R50_B}: step {step * 1e3:.6f} ms "
          f"(median of {R50_ITERS} after {AMP_WARMUP}; min "
          f"{min(walls) * 1e3:.6f}, max {max(walls) * 1e3:.6f}), "
          f"{ips:.3f} images/s; peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB); {n_ops} ops a step; share of the "
          f"dense bf16 tensor-core peak ({R50_FLOP_PER_IMAGE / 1e9:g} "
          f"GFLOP an image at {PEAK_FLOPS['bfloat16'] / 1e12:g} TFLOP/s, "
          f"least step {least:.3f} ms) {share:.4f}; losses {losses[-3:]}",
          flush=True)
    if not np.isfinite(losses).all():
        raise SystemExit(f"AMP ResNet-50 losses are not finite: {losses}")
    prof = profile_run(torch, lambda: exe.run(main, fetch_list=[loss],
                                              scope=scope),
                       f"one AMP ResNet-50 step (batch {R50_B})", smi)
    print(f"AMP ResNet-50: {n_ops} ops and {prof['calls']} torch operator "
          f"calls a step")
    reader.reset()
    out["resnet50"] = {"step_ms": step * 1e3, "images_s": ips,
                       "share": share, "peak": peak, "busy": prof["busy"],
                       "wall": prof["wall"]}
    del exe, scope
    torch.cuda.empty_cache()

    # transformer-base NMT
    phase(f"AMP training NMT: transformer-base, {NMT_TOKENS} tokens a batch "
          f"at T {NMT_BUCKETS}, dropout 0.1 through K10, Adam 2e-4, bf16")
    main, startup, loss, _, _ = nmt_program(fluid, **NMT)
    mp.enable(main)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED + 33)
    batches = [(t, *nmt_batch(rng, t, NMT["vocab"], NMT["n_head"]))
               for t in NMT_BUCKETS for _ in range(NMT_BATCHES_PER_BUCKET)]
    losses, walls = [], {}
    # the dtype count holds the warm pass, where each bucket is captured
    with launch_dtypes() as seen:
        for _, feed, _ in batches:               # warm every bucket shape
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        for t, feed, _ in batches:
            t0 = time.perf_counter()
            losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope)[0]))
            walls.setdefault(t, []).append(time.perf_counter() - t0)
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    check_launch_dtypes(seen, "AMP NMT", main, 2 * len(batches))
    ntok = sum(n for _, _, n in batches)
    total = sum(sum(w) for w in walls.values())
    for t, w in walls.items():
        print(f"[{smi}] AMP NMT bucket T {t} (batch {NMT_TOKENS // t}): "
              f"step {statistics.median(w) * 1e3:.6f} ms (median of "
              f"{len(w)})")
    print(f"[{smi}] AMP NMT: {ntok} real target tokens in {total:.6f} s: "
          f"{ntok / total:.3f} target tokens/s; peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB); losses {losses}", flush=True)
    if not np.isfinite(losses).all():
        raise SystemExit(f"AMP NMT losses are not finite: {losses}")
    nmt_launches = per_step(launches, len(batches), main.global_block().ops)
    feed32 = batches[2][1]
    prof = profile_run(torch, lambda: exe.run(main, feed=feed32,
                                              fetch_list=[loss],
                                              scope=scope),
                       f"one AMP NMT step (T 32, batch {NMT_TOKENS // 32})",
                       smi)
    out["nmt"] = {"tokens_s": ntok / total, "launches": nmt_launches,
                  "step_ms": {t: statistics.median(w) * 1e3
                              for t, w in walls.items()},
                  "peak": peak, "busy": prof["busy"], "wall": prof["wall"]}
    fluid.set_flags({"use_fused_dropout": False})
    del exe, scope
    torch.cuda.empty_cache()
    print(f"[{smi}] AMP training phase: {time.perf_counter() - t_phase:.3f}"
          f" s", flush=True)
    return out


def amp_serving_phase(torch, smi, fp32):
    """The serving phase's BERT-base model dir through ServingEngine over
    a Predictor with enable_bf16(): the answers within the JAX package's
    bar of the card's fp32 Predictor's (the serving phase's) and of a CPU
    bf16 Predictor's on the same batches; K1 launched on bf16 operands;
    latency and throughput."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import attention_kernels as ak

    phase("AMP serving BERT-base: AnalysisConfig.enable_bf16() -> "
          "ServingEngine")
    cfg = fluid.AnalysisConfig(fp32["model_dir"])
    cfg.enable_bf16()
    pred = fluid.create_paddle_predictor(cfg)
    reqs, feeds = fp32["reqs"], sorted(fp32["batch"])
    with launch_dtypes() as seen:
        run = serve(fluid, pred, reqs, fp32["max_batch"],
                    {"fwd": ak.flash_attention})
    print(f"AMP serving: launches by operand dtype {seen}")
    if set(seen) != {("flash_attention_fwd", "bfloat16")}:
        raise SystemExit(f"AMP serving: K1 not on bf16 operands: {seen}")
    layers = fp32["cfg"].num_layers
    if run["launches"]["fwd"] != layers * run["batches"]:
        raise SystemExit(f"AMP serving: K1 ran {run['launches']} times for "
                         f"{run['batches']} batches")
    cpu_cfg = fluid.AnalysisConfig(fp32["model_dir"])
    cpu_cfg.disable_gpu()
    cpu_cfg.enable_bf16()
    cpu_pred = fluid.create_paddle_predictor(cpu_cfg)
    mb = fp32["max_batch"]
    cpu = np.concatenate([
        cpu_pred.run({n: np.concatenate([r[n] for r in reqs[i:i + mb]])
                      for n in feeds})[0]
        for i in range(0, len(reqs), mb)])
    served = run["served"]
    for label, want in (("the card's fp32 Predictor", fp32["served"]),
                        ("a CPU bf16 Predictor", cpu)):
        err = float(np.abs(served - want).max())
        ok = np.allclose(served, want, rtol=AMP_SERVE_RTOL,
                         atol=AMP_SERVE_ATOL)
        print(f"AMP served vs {label}: max_abs_err {err:.3e} (rtol "
              f"{AMP_SERVE_RTOL:g}, atol {AMP_SERVE_ATOL:g})")
        if not ok:
            raise SystemExit(f"AMP serving departs from {label}: {err}")
    print(f"AMP serving [{smi}]: {run['line']}; fp32 serving p50 "
          f"{fp32['p50']:.6f} ms p99 {fp32['p99']:.6f} ms "
          f"{fp32['req_s']:.3f} req/s")
    batch = {n: np.concatenate([r[n] for r in reqs[:mb]]) for n in feeds}
    prof = profile_batch(torch, pred, batch, smi)
    run.update(busy=prof["busy"], wall=prof["wall"])
    return run


# ---------------------------------------------------------------------------
# the compiled step: _CompiledBlock as one CUDA-graph capture per feed
# signature
# ---------------------------------------------------------------------------

DEVICE_KEY_STEPS = (0, 1, 12345, 2**20)
# each captured step's loss against the uncaptured block's: bit for bit
# expected, and held to this relative bar
COMPILED_RTOL = 1e-6
# each leaf's update over a step, uncaptured against captured from one
# state: 2-norm of the difference over the 2-norm of the change.  A
# stale or skipped write-back gives 1 (or inf); the atomics' rounding in
# the embedding grads gives far less
COMPILED_LEAF_GAP = 0.05
COMPILED_STEPS = 6
# K1, K2a, K2b and K10 launches a step (the tentpole's figures): BERT-base
# 12 layers, every dropout through K10; transformer-base NMT 6 + 6 layers
COMPILED_LAUNCHES = {"bert": {"fwd": 24, "dkv": 12, "dq": 12, "dropout": 74},
                     "nmt": {"fwd": 36, "dkv": 18, "dq": 18, "dropout": 84}}
# device kernels of each wrapper, by the names the profiler records
KERNEL_NAMES = {"fwd": ("flash_fwd_kernel", "wide_fwd_kernel"),
                "dkv": ("flash_bwd_dkv_kernel", "wide_dkv_kernel"),
                "dq": ("flash_bwd_dq_kernel", "wide_dq_kernel"),
                "dropout": ("fused_dropout_kernel",)}


def device_key_check(torch):
    """K1, K2a, K2b and K10 keyed by a device step word
    (``registry.DeviceSeed``) against the same kernels keyed by the host
    int of that step: bit for bit at steps DEVICE_KEY_STEPS, at BERT-base's
    attention (batch 32, row mask, p 0.1) and NMT's FFN dropout plane; and
    each timed in both forms.  Returns {kernel: device-key ms}."""
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import dropout_kernels as dk
    from paddle_tpu_torch.ops import registry

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, dout = (torch.randn(TRAIN_B, 12, TRAIN_T, 64, generator=g,
                                 device="cuda") for _ in range(4))
    bias = torch.zeros(TRAIN_B, 1, 1, TRAIN_T, device="cuda")
    bias[:, ..., TRAIN_T // 2:] = -10000.0
    x = torch.randn(128, 32, 2048, generator=g, device="cuda")
    word = torch.zeros(1, dtype=torch.int64, device="cuda")
    base, p = 987654, 0.1
    scale = 0.125
    ms = {}
    for step in DEVICE_KEY_STEPS:
        word.fill_(step)
        dev = registry.DeviceSeed(base, word)
        host = base ^ (step * registry.STEP_MULTIPLIER)
        outs = {}
        for form, seed in (("device", dev), ("host", host)):
            out, lse = ak.flash_attention_fwd(q, k, v, bias, False, scale, p,
                                              seed, with_lse=True)
            delta = ak.attention_delta(dout, out)
            args = (q, k, v, bias, dout, lse, delta, False, scale, p, seed)
            outs[form] = (out, *ak.flash_attention_bwd_dkv(*args),
                          ak.flash_attention_bwd_dq(*args)[0],
                          dk.fused_dropout_fwd(x, p, seed))
        same = [bits_equal(torch, a, b)
                for a, b in zip(outs["device"], outs["host"])]
        print(f"step {step}: K1 out, K2a dK/dV, K2b dQ, K10 out under the "
              f"device key equal the host key's bit for bit: {same}")
        if not all(same):
            raise SystemExit(f"a device-keyed kernel departs from the host "
                             f"key at step {step}: {same}")
    out, lse = ak.flash_attention_fwd(q, k, v, bias, False, scale, p, dev,
                                      with_lse=True)
    delta = ak.attention_delta(dout, out)
    for form, seed in (("host", host), ("device", dev)):
        args = (q, k, v, bias, dout, lse, delta, False, scale, p, seed)
        row = {"fwd": time_ms(torch, lambda: ak.flash_attention_fwd(
                   q, k, v, bias, False, scale, p, seed, with_lse=True)),
               "dkv": time_ms(torch,
                              lambda: ak.flash_attention_bwd_dkv(*args)),
               "dq": time_ms(torch, lambda: ak.flash_attention_bwd_dq(*args)),
               "dropout": time_ms(torch,
                                  lambda: dk.fused_dropout_fwd(x, p, seed))}
        print(f"{form} key: K1 {row['fwd']:.6f} ms, K2a {row['dkv']:.6f} "
              f"ms, K2b {row['dq']:.6f} ms (BERT-base attention, batch "
              f"{TRAIN_B}, p {p}); K10 {row['dropout']:.6f} ms (NMT "
              f"[128, 32, 2048] fp32)")
        ms[form] = row
    return ms["device"]


def device_record(torch, run):
    """run() under torch.profiler, the device's activity only: (wall ms,
    device busy ms, {kernel: launches} for KERNEL_NAMES).  It reads the
    profiler's raw device events: building `key_averages()` over an
    op-by-op step's ~30,000 events took a second or more a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [(e.name(), e.duration_ns()) for e in
              prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    busy = sum(ns for _, ns in events) / 1e6
    counts = {k: sum(any(n in name for n in names) for name, _ in events)
              for k, names in KERNEL_NAMES.items()}
    return wall, busy, counts


def clone_state(scope):
    return {n: t.clone() for n, t in scope.vars.items()
            if hasattr(t, "clone")}


def scope_from(fluid, state):
    scope = fluid.Scope()
    for n, t in state.items():
        scope.set_var(n, t.clone())
    return scope


def uncaptured(fluid, exe, main, loss):
    """A step function over `_CompiledBlock(use_graph=False)` on `exe`'s
    device and step count: the compiled step's bookkeeping, op by op."""
    from paddle_tpu_torch.core.executor import (_CompiledBlock,
                                                _normalize_feed)

    blocks = {}

    def step(feed, scope):
        feed = _normalize_feed(main, dict(feed))
        program = exe._at_seams(main, sorted(feed), [loss.name])
        block = blocks.get(id(program))
        if block is None:
            block = blocks[id(program)] = _CompiledBlock(
                program, sorted(feed), [loss.name], use_graph=False,
                captures=exe._captures())
        (value,) = block.run(feed, scope, exe._step)
        exe._step += 1
        return float(value)

    return step, blocks


def device_leaf_gaps(torch, before, after, ref):
    """{leaf: ||after − ref|| / ||ref − before||} (2-norms, float64, on
    the card) over the float leaves `ref`'s step changed, inf for one it
    left alone and `after` changed: leaf_gaps for device states."""
    names = [n for n, b in before.items() if b.is_floating_point()]
    norms = torch.stack([torch.stack([
        torch.linalg.vector_norm(ref[n].double() - before[n].double()),
        torch.linalg.vector_norm(after[n].double() - ref[n].double())])
        for n in names]).cpu().tolist()         # one copy to the host
    gaps = {}
    for n, (moved, off) in zip(names, norms):
        if moved > 0:
            gaps[n] = off / moved
        elif off > 0:
            gaps[n] = float("inf")
    return gaps


def compiled_arm(torch, fluid, main, loss, start, feeds, captured, held,
                 counters):
    """COMPILED_STEPS steps of (main, loss) on a fresh executor: through
    Executor.run from `start` (the captured arm, which appends to `held`
    its state before each step and after the last), or through the
    uncaptured block, each step from held[i] and its update held against
    held[i + 1] (device_leaf_gaps).  Returns losses, the worst leaf gap
    of each step, walls, launches of the last (replayed) step, peak
    memory, the executor and scope."""
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = scope_from(fluid, start)
    if captured:
        def step(feed, scope):
            return float(exe.run(main, feed=feed, fetch_list=[loss],
                                 scope=scope)[0])
    else:
        step, _ = uncaptured(fluid, exe, main, loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gaps, walls = [], [], []
    for i, feed in enumerate(feeds):
        if captured:
            held.append(clone_state(scope))
        else:
            scope = scope_from(fluid, held[i])
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        losses.append(step(feed, scope))
        walls.append(time.perf_counter() - t0)
        if not captured:
            g = device_leaf_gaps(torch, held[i], {
                n: scope.find_var(n) for n in held[i]}, held[i + 1])
            worst = max(g, key=g.get)
            gaps.append((worst, g[worst],
                         sum(v == 0.0 for v in g.values()), len(g)))
    if captured:
        held.append(clone_state(scope))
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    # the step wall, each step ended by the fetch's copy to the host: the
    # uncaptured arm's last half of the compared steps; the captured arm
    # runs the last half of the batches once more (all replays), since
    # its compared steps hold the warm-ups and the captures
    walls = walls[len(feeds) // 2:]
    if captured:
        walls = []
        for feed in feeds[len(feeds) // 2:]:
            t0 = time.perf_counter()
            step(feed, scope)
            walls.append(time.perf_counter() - t0)
    return {"losses": losses, "gaps": gaps, "walls": walls,
            "launches": launches, "peak": peak, "exe": exe, "scope": scope,
            "step": step}


def compiled_path(torch, smi, fluid, label, build, feeds, signatures,
                  launches_key=None):
    """One training path, captured against uncaptured: the captured arm
    runs COMPILED_STEPS steps from the startup state, and the uncaptured
    block runs each of them from the captured arm's state before it (the
    embedding and gather grads' `index_add_` adds with atomics, and
    cuDNN's weight grads may too, so two free runs part by rounding):
    each step's loss (bit for bit expected, COMPILED_RTOL) and each
    leaf's update (within COMPILED_LEAF_GAP of the captured one's); the
    captured signatures, the launches of a replayed step from the
    counters and the profiler's device record, and each arm's step wall,
    device busy, idle share and peak memory.  Returns the captured arm's
    numbers."""
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import dropout_kernels as dk

    t_path = time.perf_counter()
    main, startup, loss = build()
    feeds = feeds(main) if callable(feeds) else feeds
    init_exe, init = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    init_exe.run(startup, scope=init)
    start = clone_state(init)
    del init_exe, init
    counters = {"fwd": ak.flash_attention, "dkv": ak.flash_attention_bwd_dkv,
                "dq": ak.flash_attention_bwd_dq, "dropout": dk.fused_dropout}
    held = []
    arms = {}
    for captured in (True, False):
        arm = compiled_arm(torch, fluid, main, loss, start, feeds, captured,
                           held, counters)
        exe, scope, step = arm["exe"], arm["scope"], arm["step"]
        wall, busy, kernels = device_record(
            torch, lambda: step(feeds[-1], scope))
        arm.update(wall=wall, busy=busy, kernels=kernels,
                   compiles=exe.compile_count,
                   capture_ms=exe.capture_ms)
        if captured and label == "BERT-base fp32":
            arm["dropout"] = replay_dropout_check(torch, fluid, exe, scope,
                                                  step, feeds[-1])
        exe.close()
        del arm["exe"], arm["scope"], arm["step"], exe, scope, step
        torch.cuda.empty_cache()
        arms[captured] = arm
    del held, start
    torch.cuda.empty_cache()
    cap, unc = arms[True], arms[False]
    rel = [abs(a - b) / abs(b) for a, b in zip(cap["losses"], unc["losses"])]
    worst_gap = max(g[1] for g in unc["gaps"])
    print(f"{label}: captured losses {cap['losses']}, uncaptured "
          f"{unc['losses']} (each step from the captured arm's state before "
          f"it); bit for bit {cap['losses'] == unc['losses']}, largest "
          f"relative gap {max(rel):.3e} (bar {COMPILED_RTOL:g})")
    print(f"{label}: each step's update, uncaptured against captured (worst "
          f"leaf, its gap, leaves equal bit for bit of leaves moved): "
          f"{unc['gaps']} (bar {COMPILED_LEAF_GAP:g})")
    print(f"{label}: captured signatures {cap['compiles']} (expected "
          f"{signatures}), capture ms {cap['capture_ms']}")
    for name, arm in (("captured", cap), ("uncaptured", unc)):
        step_ms = statistics.median(arm["walls"]) * 1e3
        print(f"[{smi}] {label} {name}: step {step_ms:.6f} ms (median of "
              f"{len(arm['walls'])}: " + ("replays after the compared steps"
                                          if arm is cap else "the last "
                                          "compared steps") + "), "
              f"profiled step {arm['wall']:.6f} ms, device busy "
              f"{arm['busy']:.6f} ms, idle share "
              f"{1.0 - arm['busy'] / arm['wall']:.4f}, peak memory "
              f"{arm['peak']} bytes ({arm['peak'] / 2**30:.3f} GiB); "
              f"launches of the last step {arm['launches']}, in the "
              f"profiled step's device record {arm['kernels']}",
              flush=True)
        arm["step_ms"] = step_ms
    if not np.isfinite(cap["losses"] + unc["losses"]).all() or \
            max(rel) > COMPILED_RTOL or not worst_gap <= COMPILED_LEAF_GAP:
        raise SystemExit(f"{label}: the captured step departs from the "
                         f"uncaptured one: losses {rel}, updates "
                         f"{unc['gaps']}")
    if cap["compiles"] != signatures:
        raise SystemExit(f"{label}: {cap['compiles']} captured signatures, "
                         f"expected {signatures}")
    if launches_key is not None:
        want = COMPILED_LAUNCHES[launches_key]
        for name, arm in (("captured", cap), ("uncaptured", unc)):
            if arm["launches"] != want or arm["kernels"] != want:
                raise SystemExit(f"{label} {name}: launches a step "
                                 f"{arm['launches']}, device record "
                                 f"{arm['kernels']}, expected {want}")
    print(f"{label}: {time.perf_counter() - t_path:.3f} s", flush=True)
    cap["uncaptured"] = {k: unc[k] for k in ("step_ms", "busy", "wall",
                                             "peak")}
    cap["worst_gap"] = worst_gap
    return cap


def replay_dropout_check(torch, fluid, exe, scope, step, feed):
    """Two consecutive replays from one state on one batch draw different
    dropout masks, so their losses differ; the control replays twice at
    one step (what a graph with its key baked in would do) and must give
    one loss bit for bit, or the check could not see a baked key."""
    state = clone_state(scope)

    def replay_at(n):
        exe._step = n
        for name, t in state.items():
            scope.set_var(name, t.clone())
        return step(feed, scope)

    n = exe._step
    a, b, c = replay_at(n), replay_at(n + 1), replay_at(n + 1)
    print(f"consecutive replays from one state: losses {a} and {b} "
          f"(must differ); the same step twice (a baked key): {b} and {c} "
          f"(must be equal)")
    if a == b or b != c:
        raise SystemExit(f"dropout masks: consecutive replays {a}, {b}; "
                         f"same-step control {b}, {c}")
    return (a, b, c)


def compiled_serving(torch, smi, fluid, fp32, bf16):
    """BERT-base serving through ServingEngine over a Predictor whose
    engine warm-up captures the bucket grid: answers equal to an
    uncaptured engine's on the same requests, and no capture after the
    warm-up."""
    label = "bf16" if bf16 else "fp32"
    cfgs = []
    for _ in range(2):
        cfg = fluid.AnalysisConfig(fp32["model_dir"])
        if bf16:
            cfg.enable_bf16()
        cfgs.append(cfg)
    pred = fluid.create_paddle_predictor(cfgs[0])
    plain = fluid.create_paddle_predictor(cfgs[1])
    counts = {}
    run = serve(fluid, pred, fp32["reqs"], fp32["max_batch"], {},
                on_start=lambda: counts.setdefault(
                    "warm", pred._exe.compile_count))
    counts["after"] = pred._exe.compile_count
    with interpreted(plain):
        ref = serve(fluid, plain, fp32["reqs"], fp32["max_batch"], {})
    err = float(np.abs(run["served"] - ref["served"]).max())
    bitwise = bool(np.array_equal(run["served"], ref["served"]))
    print(f"{label} serving: captured signatures after the warm-up "
          f"{counts['warm']}, after serving {counts['after']}; capture ms "
          f"{pred._exe.capture_ms}; answers vs the uncaptured engine: bit "
          f"for bit {bitwise}, max_abs_err {err:.3e}")
    print(f"[{smi}] {label} serving captured: {run['line']}")
    print(f"[{smi}] {label} serving uncaptured: {ref['line']}")
    buckets = len(fluid.serving.buckets.default_batch_buckets(
        fp32["max_batch"]))
    if counts["warm"] != buckets or counts["after"] != counts["warm"]:
        raise SystemExit(f"{label} serving: {counts} captured signatures, "
                         f"expected {buckets} and none after the warm-up")
    if err > COMPILED_RTOL * float(np.abs(ref["served"]).max()):
        raise SystemExit(f"{label} serving: captured answers depart from "
                         f"the uncaptured engine's by {err}")
    return {"p50": run["p50"], "p99": run["p99"], "req_s": run["req_s"],
            "plain_p50": ref["p50"], "plain_p99": ref["p99"]}


def compiled_step_phase(torch, smi, fp32):
    """The compiled step on the card: Executor.run captures each eligible
    program once per feed signature and replays it.  BERT-base training
    fp32 (batch 32, dropout 0.1 through K10) and AMP (batch 128),
    transformer-base NMT at T 16/32/64 fp32 and AMP, fp32 ResNet-50 at
    batch 128, each captured against `_CompiledBlock(use_graph=False)`
    step by step from the same states (compiled_path); BERT-base serving
    in fp32 and
    bf16 against an uncaptured engine.  First the device-keyed kernels
    against the host-keyed ones."""
    import paddle_tpu_torch as fluid

    phase("compiled step: one CUDA graph per feed signature, against the "
          "uncaptured block")
    t0 = time.perf_counter()
    key_ms = device_key_check(torch)
    mp = fluid.contrib.mixed_precision
    fluid.set_flags({"use_fused_dropout": True})

    # each model is built once: its AMP path runs the same program after
    # contrib.mixed_precision.enable (a new version, so new signatures)
    bert = pretrain_program(fluid, 12, 0.1)
    nmt = nmt_program(fluid, **NMT)[:3]

    def amp(prog):
        mp.enable(prog[0])
        return prog

    def resnet():
        main, startup, loss, reader = resnet50_program(fluid)
        return main, startup, loss

    rng = np.random.RandomState(SEED + 40)
    nmt_feeds = [nmt_batch(rng, t, NMT["vocab"], NMT["n_head"])[0]
                 for _ in range(2) for t in NMT_BUCKETS]
    out = {}
    out["bert"] = compiled_path(
        torch, smi, fluid, "BERT-base fp32", lambda: bert,
        [pretrain_feed(TRAIN_B, TRAIN_T, TRAIN_M, SEED + 41 + i % 2)
         for i in range(COMPILED_STEPS)], 1, "bert")
    out["bert_amp"] = compiled_path(
        torch, smi, fluid, "BERT-base AMP", lambda: amp(bert),
        [pretrain_feed(AMP_BERT_B, TRAIN_T, AMP_BERT_M, SEED + 43 + i % 2)
         for i in range(COMPILED_STEPS)], 1, "bert")
    out["nmt"] = compiled_path(torch, smi, fluid, "NMT fp32", lambda: nmt,
                               nmt_feeds, len(NMT_BUCKETS), "nmt")
    out["nmt_amp"] = compiled_path(torch, smi, fluid, "NMT AMP",
                                   lambda: amp(nmt), nmt_feeds,
                                   len(NMT_BUCKETS), "nmt")
    fluid.set_flags({"use_fused_dropout": False})

    def images(main):
        slots = [v.name for v in main._py_readers[0].feed_vars]
        img_rng = np.random.RandomState(0)
        return [dict(zip(slots, image_batch(img_rng, R50_B)))
                for _ in range(COMPILED_STEPS)]

    out["resnet50"] = compiled_path(torch, smi, fluid, "ResNet-50 fp32",
                                    resnet, images, 1)
    out["serving"] = compiled_serving(torch, smi, fluid, fp32, False)
    out["serving_bf16"] = compiled_serving(torch, smi, fluid, fp32, True)
    out["key_ms"] = key_ms
    print(f"[{smi}] compiled step phase: {time.perf_counter() - t0:.3f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# The control-flow slice: the While decode (Path A) and host beam search
# over the captured test program (Path B)
# ---------------------------------------------------------------------------

class counted_syncs:
    """Counts the card's host synchronisations inside the port's while
    loops: torch.cuda's sync debug mode warns at each one it detects (a
    prototype: PyTorch says it does not detect them all), and is on only
    while a loop runs (the feeds' copies and the fetches lie outside);
    `where` counts them by the Python line that waited."""

    def __init__(self, torch):
        self.torch, self.n, self.where = torch, 0, {}

    def __enter__(self):
        import warnings

        from paddle_tpu_torch.core import executor as ex

        self.ex, self.orig = ex, ex._run_while
        torch = self.torch

        def run_while(op, env, read, *body):
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    self.orig(op, env, read, *body)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            for w in seen:
                # (not the note that the debug mode is a prototype)
                if "called a synchronizing" in str(w.message):
                    self.n += 1
                    at = f"{os.path.relpath(w.filename)}:{w.lineno}"
                    self.where[at] = self.where.get(at, 0) + 1

        ex._run_while = run_while
        return self

    def __exit__(self, *a):
        self.ex._run_while = self.orig


class beam_trace:
    """Records, at each beam_search op the port runs inside, the op's
    selected ids and its candidates' scores sorted best first, as the op
    masks them (finished beams: one frozen candidate)."""

    def __init__(self, torch):
        self.torch, self.steps = torch, []

    def __enter__(self):
        from paddle_tpu_torch.ops import registry

        self.kernels, self.orig = registry._KERNELS, \
            registry._KERNELS["beam_search"]
        torch = self.torch

        def traced(ins, attrs):
            out = self.orig(ins, attrs)
            k, end = int(attrs["beam_size"]), int(attrs["end_id"])
            s = ins["scores"][0].float()
            bk, k2 = s.shape
            fin = (ins["pre_ids"][0].reshape(bk // k, k) == end)
            s = s.reshape(bk // k, k, k2).clone()
            s[fin] = -1e9
            s[..., 0] = torch.where(fin, ins["pre_scores"][0].reshape(
                bk // k, k).float(), s[..., 0])
            self.steps.append((
                out["selected_ids"][0].reshape(bk // k, k).cpu().numpy(),
                s.reshape(bk // k, k * k2).sort(
                    dim=1, descending=True).values.cpu().numpy()))
            return out

        self.kernels["beam_search"] = traced
        return self

    def __exit__(self, *a):
        self.kernels["beam_search"] = self.orig


def mt_programs(fluid):
    """(main, startup, loss, decode, (ids, scores)) of the book's
    machine-translation model at its published sizes, seeds SEED."""
    from paddle_tpu_torch.models import machine_translation as mt

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        loss = mt.train_net(fluid, **mt.BOOK)
    dec = fluid.Program()
    with fluid.program_guard(dec, fluid.Program()):
        outs = mt.decode_net(fluid, **mt.BOOK)
    return main, startup, loss, dec, outs


def mt_path(torch, smi):
    """Path A: the book's machine-translation model trained 3 steps on the
    card against the CPU from one state (K8 in the encoder's dynamic_lstm
    with its peepholes, twice a padded source step a training step: the
    lstm op and its generic grad's recompute), then one While decode on
    the card against the CPU from the card's trained state (K8 once a
    padded source step).  Returns the K8 launches and the decode's
    numbers."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as ex
    from paddle_tpu_torch.core.lod import bucket_len
    from paddle_tpu_torch.models import machine_translation as mt
    from paddle_tpu_torch.ops import rnn_kernels as rk

    cfg = mt.BOOK
    main, startup, loss, dec, outs = mt_programs(fluid)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = host_state(init)
    rng = np.random.default_rng(SEED + 20)
    feeds = [mt.train_batch(rng, MT_B, cfg["dict_size"])
             for _ in range(MT_STEPS)]
    srcs = mt.train_batch(rng, MT_B, cfg["dict_size"])["src_word_id"]
    dfeed = mt.decode_feed(srcs, cfg["beam_size"])
    want_train = sum(2 * bucket_len(max(len(x) for x in f["src_word_id"]))
                     for f in feeds)
    want_dec = bucket_len(max(len(x) for x in srcs))

    losses = {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.io.state_from_numpy(state, scope=fluid.Scope(),
                                          place=place, main_program=main)
        exe = fluid.Executor(place)
        on_card = isinstance(place, fluid.CUDAPlace)
        rk.fused_lstm_cell.launches = 0
        losses[on_card] = [float(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0]) for f in feeds]
        if on_card:
            train_launches = rk.fused_lstm_cell.launches
            card_exe, card_scope = exe, scope
    card, cpu = losses[True], losses[False]
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    print(f"[{smi}] machine translation, {MT_STEPS} Adam steps: card "
          f"{card} cpu {cpu} relative differences {rel} (bounds "
          f"{PARITY_RTOL[1]:g} at step 1, {PARITY_RTOL[3]:g} at step 3); "
          f"lstm_step launches "
          f"{train_launches} (expected {want_train}: twice a padded source "
          f"step a step)", flush=True)
    if not np.isfinite(card + cpu).all() or rel[0] > PARITY_RTOL[1] \
            or max(rel) > PARITY_RTOL[3]:
        raise SystemExit(f"machine translation: the card departs from the "
                         f"CPU: {rel}")
    if train_launches != want_train:
        raise SystemExit(f"machine translation training: lstm_step "
                         f"launches {train_launches}, expected {want_train}")

    # the decode, card against CPU from the card's trained state
    trained = host_state(card_scope)
    cpu_scope = fluid.io.state_from_numpy(
        trained, scope=fluid.Scope(), place=fluid.CPUPlace(),
        main_program=dec)
    fetch = list(outs)

    def decode():
        return card_exe.run(dec, feed=dfeed, fetch_list=fetch,
                            scope=card_scope)

    decode()                            # warm: allocator, cuBLAS
    decode()                            # captures the segments
    torch.cuda.synchronize()
    rk.fused_lstm_cell.launches = 0
    ex.loop_counts.update(loops=0, iterations=0, condition_reads=0)
    with counted_syncs(torch) as syncs:
        t0 = time.perf_counter()
        ids, scores = decode()
        wall = (time.perf_counter() - t0) * 1e3
    counts = dict(ex.loop_counts)
    dec_launches = rk.fused_lstm_cell.launches
    prof_wall, busy, _ = device_record(torch, decode)
    cexe = fluid.Executor(fluid.CPUPlace())
    cids, cscores = cexe.run(dec, feed=dfeed, fetch_list=fetch,
                             scope=cpu_scope)
    ids_equal = np.array_equal(ids, cids)
    score_rel = float(np.max(np.abs(scores - cscores)
                             / np.maximum(np.abs(cscores), 1e-30)))
    print(f"[{smi}] While decode of {len(srcs)} sentences, beam "
          f"{cfg['beam_size']}, max length {cfg['max_length']}: wall "
          f"{wall:.6f} ms; profiled {prof_wall:.6f} ms, device busy "
          f"{busy:.6f} ms, idle share {1.0 - busy / prof_wall:.4f}; loop "
          f"{counts['iterations']} iterations, {counts['condition_reads']} "
          f"condition reads, {syncs.n} host synchronisations inside the "
          f"loop (at {syncs.where}); lstm_step launches {dec_launches} "
          f"(expected {want_dec})")
    print(f"[{smi}] decode card vs CPU: SentenceIds equal {ids_equal}; "
          f"SentenceScores largest relative difference {score_rel:.3e} "
          f"(bound {MT_SCORE_RTOL:g}); card ids of sentence 0 "
          f"{ids[0].tolist()}", flush=True)
    if counts["iterations"] != cfg["max_length"] or \
            syncs.n != counts["condition_reads"]:
        raise SystemExit(f"the While decode ran {counts} with {syncs.n} "
                         f"synchronisations: expected {cfg['max_length']} "
                         f"iterations and one synchronisation a "
                         f"condition read")
    if dec_launches != want_dec:
        raise SystemExit(f"While decode: lstm_step launches {dec_launches}, "
                         f"expected {want_dec}")
    if not ids_equal:
        with beam_trace(torch) as on_card:
            decode()
        with beam_trace(torch) as on_cpu:
            cexe.run(dec, feed=dfeed, fetch_list=fetch, scope=cpu_scope)
        k = cfg["beam_size"]
        for t, ((ci, _), (pi, ps)) in enumerate(zip(on_card.steps,
                                                    on_cpu.steps)):
            bad = np.flatnonzero((ci != pi).any(axis=1))
            if bad.size:
                gaps = ps[bad, k - 1] - ps[bad, k]
                print(f"  ids first differ at step {t}, sentences "
                      f"{bad.tolist()}: the CPU's gaps between its "
                      f"{k}-th and {k + 1}-th candidates {gaps.tolist()}")
                if gaps.max() >= MT_TIE_GAP:
                    raise SystemExit("While decode: the card's ids depart "
                                     "from the CPU's where no tie explains "
                                     "it")
                break
    elif score_rel > MT_SCORE_RTOL:
        raise SystemExit(f"While decode scores depart from the CPU's: "
                         f"{score_rel}")
    return {"launches": train_launches + dec_launches, "wall": wall,
            "busy": busy, "iterations": counts["iterations"],
            "syncs": syncs.n}


def beam_decode_path(torch, smi, trained):
    """Path B: the trained transformer-base decoded by
    models/decoding.beam_search over nmt_program's test program, one
    captured graph per step after the first: K1 18 times a run (the
    encoder's, the decoder's and the cross attention of 6 + 6 layers),
    one signature captured, the card's log-probabilities at steps 1, 2
    and the last against the CPU's on the card's own prefixes, and the
    beam bookkeeping run again on the card's recorded log-probabilities
    gives the card's ids."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import decoding
    from paddle_tpu_torch.models.transformer import make_attn_biases
    from paddle_tpu_torch.ops import attention_kernels as ak

    _, scope, infer, predict = trained
    h, vocab, L, ts = NMT["n_head"], NMT["vocab"], BEAM_LEN, BEAM_SRC
    # the test program, and the position-t rows of its softmax gathered
    # on the card from a fed index: a step fetches [rows, vocab]
    dec = infer.clone()
    with fluid.program_guard(dec, fluid.Program()):
        at = fluid.layers.data(name="next_rows", shape=[-1], dtype="int64",
                               append_batch_size=False)
        probs = fluid.layers.reshape(dec.global_block().var(predict.name),
                                     shape=[-1, vocab])
        nxt = fluid.layers.gather(probs, at)
    state = {n: t for n, t in scope.vars.items()
             if t is not None and dec.global_block().has_var(n)}
    bscope = scope_from(fluid, state)
    bexe = fluid.Executor(fluid.CUDAPlace(0))
    src = np.random.RandomState(SEED + 21).randint(
        2, vocab, (BEAM_B, ts)).astype(np.int64)

    def feed_for(prefix, t):
        n = prefix.shape[0]
        sb, tb, cb = make_attn_biases([ts] * n, [t] * n, h, ts, L)
        return {"src_word": np.repeat(src, n // BEAM_B, axis=0),
                "src_pos": np.tile(np.arange(ts), (n, 1)).astype(np.int64),
                "trg_word": np.asarray(prefix)[:, :L],
                "trg_pos": np.tile(np.arange(L), (n, 1)).astype(np.int64),
                "src_slf_attn_bias": sb, "trg_slf_attn_bias": tb,
                "trg_src_attn_bias": cb,
                "next_rows": (np.arange(n) * L + t - 1).astype(np.int64)}

    record = []

    def logits_fn(prefix, t):
        t0 = time.perf_counter()
        (p,) = bexe.run(dec, feed=feed_for(prefix, t), fetch_list=[nxt],
                        scope=bscope)
        out = np.log(np.maximum(p, 1e-9))
        record.append({"prefix": np.array(prefix), "t": t, "logp": out,
                       "start": t0, "ms": (time.perf_counter() - t0) * 1e3,
                       "compiles": bexe.compile_count})
        return out

    ak.flash_attention.launches = 0
    t0 = time.perf_counter()
    seqs, scores = decoding.beam_search(logits_fn, BEAM_B, BEAM_K, BEAM_BOS,
                                        BEAM_EOS, L)
    wall = time.perf_counter() - t0
    launches = ak.flash_attention.launches
    # a step: from one program run's start to the next one's, the host's
    # beam bookkeeping included (the last ends with the search)
    ends = [r["start"] for r in record[1:]] + [t0 + wall]
    steps_ms = [(e - r["start"]) * 1e3 for r, e in zip(record, ends)]
    runs = len(record)
    compiles = [r["compiles"] for r in record]
    last = record[-1]
    prof_wall, busy, _ = device_record(torch, lambda: bexe.run(
        dec, feed=feed_for(last["prefix"], last["t"]), fetch_list=[nxt],
        scope=bscope))

    # the beam bookkeeping again on the card's recorded log-probabilities
    replay = iter(record)

    def replayed(prefix, t):
        r = next(replay)
        if r["t"] != t or not np.array_equal(r["prefix"], prefix):
            raise SystemExit("beam search replay: the prefixes differ")
        return r["logp"]

    seqs2, scores2 = decoding.beam_search(replayed, BEAM_B, BEAM_K,
                                          BEAM_BOS, BEAM_EOS, L)
    same = np.array_equal(seqs2, seqs) and np.array_equal(scores2, scores)

    # the CPU's log-probabilities on the card's own prefixes
    cpu_scope = fluid.io.state_from_numpy(
        {n: t.cpu().numpy() for n, t in state.items()}, scope=fluid.Scope(),
        place=fluid.CPUPlace(), main_program=dec)
    cexe = fluid.Executor(fluid.CPUPlace())
    errs = []
    for i in sorted({0, 1, runs - 1}):
        r = record[i]
        (p,) = cexe.run(dec, feed=feed_for(r["prefix"], r["t"]),
                        fetch_list=[nxt], scope=cpu_scope)
        want = np.log(np.maximum(p, 1e-9))
        errs.append((r["t"], float(np.abs(r["logp"] - want).max()
                                   / np.abs(want).max())))
    # the steady state: steps 3 on (the first two are the warm-up run and
    # the capture)
    step_ms = statistics.median(steps_ms[2:])
    run_ms = statistics.median(r["ms"] for r in record[2:])
    tokens_s = BEAM_B / step_ms * 1e3
    print(f"[{smi}] transformer-base beam decode: {BEAM_B} sentences of "
          f"{ts} tokens, beam {BEAM_K}, max_len {L}: {runs} steps in "
          f"{wall * 1e3:.6f} ms (first step {steps_ms[0]:.6f}, second "
          f"{steps_ms[1]:.6f}); steps 3-{runs}: step {step_ms:.6f} ms "
          f"(median), of which the program's run and fetch {run_ms:.6f} ms "
          f"and numpy's beam bookkeeping the rest; {tokens_s:.3f} generated "
          f"tokens/s ({tokens_s * BEAM_K:.3f} beam rows/s; over the whole "
          f"search with its warm-up and capture {BEAM_B * runs / wall:.3f});"
          f" one run profiled {prof_wall:.6f} ms, device busy {busy:.6f} "
          f"ms, idle share {1.0 - busy / prof_wall:.4f}; a run fetches "
          f"{BEAM_B * BEAM_K} x {vocab} fp32 ({BEAM_B * BEAM_K * vocab * 4} "
          f"bytes)")
    print(f"[{smi}] flash_attention_fwd launches {launches} over {runs} runs "
          f"(expected {3 * NMT['n_layer']} a run); compile_count after "
          f"each step {compiles}; card vs CPU log-probabilities (step, "
          f"largest difference over the largest |value|) {errs} (bound "
          f"{BEAM_ATOL:g}); the bookkeeping again on the card's "
          f"log-probabilities gives its ids and scores: {same}; best beam "
          f"of sentence 0 {seqs[0, 0].tolist()}", flush=True)
    if launches != 3 * NMT["n_layer"] * runs:
        raise SystemExit(f"beam decode: flash_attention_fwd launches "
                         f"{launches}, expected {3 * NMT['n_layer'] * runs}")
    if compiles[0] != 0 or set(compiles[1:]) != {1}:
        raise SystemExit(f"beam decode: captured signatures {compiles}, "
                         f"expected one from the second step on")
    if max(e for _, e in errs) > BEAM_ATOL or not same:
        raise SystemExit("beam decode: the card departs from the CPU, or "
                         "the bookkeeping does not reproduce its ids")
    return {"launches": launches, "runs": runs, "step_ms": step_ms,
            "run_ms": run_ms, "tokens_s": tokens_s, "busy": busy,
            "wall": prof_wall}


def control_flow_phase(torch, smi, trained):
    """The control-flow slice on the card: K1 at Path B's attention shapes
    against its plain version, then Path A (mt_path) and Path B
    (beam_decode_path).  K8 at Path A's step shape is held against its
    plain version in rnn_kernel_phase (mt_b16_d32_peep)."""
    from paddle_tpu_torch.models.transformer import make_attn_biases
    from paddle_tpu_torch.ops import attention_kernels as ak

    phase(f"control flow: the book's machine translation (dictionary "
          f"30000, word 16, hidden 32, beam 2, max length 8) trained and "
          f"decoded by While; transformer-base beam decode ({BEAM_B} x "
          f"{BEAM_SRC} tokens, beam {BEAM_K}, max_len {BEAM_LEN})")
    t_phase = time.perf_counter()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    n, h, d = BEAM_B * BEAM_K, NMT["n_head"], NMT["d_model"] // NMT["n_head"]
    sb, tb, _ = make_attn_biases([BEAM_SRC] * n, [BEAM_LEN // 2] * n, h,
                                 BEAM_SRC, BEAM_LEN)
    rows = {}
    for name, bias in (("beam_enc_self", sb), ("beam_dec_self", tb)):
        q, k, v = (torch.randn(n, h, BEAM_LEN, d, generator=g,
                               device="cuda") for _ in range(3))
        bias = torch.from_numpy(bias).cuda()
        scale = d ** -0.5
        out = ak.flash_attention(q, k, v, bias=bias)
        err = max_err(torch, out, ak.flash_attention_reference(
            q, k, v, bias, False, scale))
        row = {"max_abs_err": err,
               "ms": time_ms(torch, lambda: ak.flash_attention(
                   q, k, v, bias=bias)),
               "plain_ms": time_ms(torch, lambda: ak.flash_attention_reference(
                   q, k, v, bias, False, scale)),
               "library_ms": time_ms(torch, lambda: sdpa(
                   q, k, v, attn_mask=bias, scale=scale)),
               **attention_bound_ms(q, k, bias, False)}
        rows[name] = row
        print(f"[{smi}] flash_attention_fwd {name}: q {tuple(q.shape)} full "
              f"bias, max_abs_err {err:.3e} (atol {ATOL['float32']:g}) "
              f"kernel {row['ms']:.6f} ms plain {row['plain_ms']:.6f} ms "
              f"sdpa {row['library_ms']:.6f} ms bound {row['bound_ms']:.6f}"
              f" ms ({row['bound_by']})", flush=True)
        if not err <= ATOL["float32"]:
            raise SystemExit(f"flash_attention_fwd disagrees with its plain "
                             f"version on {name}: {err}")
    a = mt_path(torch, smi)
    b = beam_decode_path(torch, smi, trained)
    print(f"control flow phase {time.perf_counter() - t_phase:.3f} s")
    torch.cuda.empty_cache()
    return {"mt": a, "beam": b, "rows": rows}


def k8_arm_checks(torch, smi):
    """K8's activation arms at the SRL's step shape (B 10, D 128, the lstm
    op's peepholes) against the plain step, outputs and grads within
    RNN_ATOL, timed beside the plain step and the launch floor (no library
    call takes peepholes or a relu candidate: library_ms is null); then
    the lstm op over a whole scan at that width (T 64, lengths in SRL_LENS)
    in the SRL's arm, forward and reverse, against the same op on the
    plain steps: |kernel - plain| <= RNN_ATOL * (1 + |plain|) over the
    outputs and the grads of the input, weight, bias and initial state."""
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops import rnn_kernels as rk

    g = torch.Generator(device="cuda").manual_seed(SEED + 30)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    b, d = SRL_B, SRL_D
    floor = launch_floor_ms(torch)
    rows = {}
    for name, acts in SRL_ARMS:
        xg = randn(b, RNN_STEP_T, 4 * d, scale=0.5)[:, RNN_STEP]
        h, c = torch.tanh(randn(b, d)), randn(b, d, scale=0.5)
        w, peep = randn(d, 4 * d, scale=0.5 / d ** 0.5), randn(3 * d) / 4
        lens = torch.randint(0, RNN_STEP_T + 1, (b,), generator=g,
                             device="cuda", dtype=torch.int32)
        lens[0], lens[-1] = 0, RNN_STEP_T
        err = grads_err(
            torch, lambda *a: rk.lstm_step(*a[:4], lens, RNN_STEP, a[4],
                                           acts),
            lambda *a: rk.lstm_step_reference(*a[:4], lens, RNN_STEP, a[4],
                                              acts),
            (xg, h, c, w, peep), tuple(randn(b, d) for _ in range(4)))
        step = lambda: rk.lstm_step(  # noqa: E731
            xg, h, c, w, lens, RNN_STEP, peep, acts)
        row = {"max_abs_err": err, "ms": time_ms(torch, step),
               "plain_ms": time_ms(torch, lambda: rk.lstm_step_reference(
                   xg, h, c, w, lens, RNN_STEP, peep, acts)),
               "library_ms": None, "launch_floor_ms": floor,
               "host_ms": host_ms(torch, step),
               **lstm_step_bound(b, d, peep=True)}
        rows[name] = row
        print(f"[{smi}] lstm_step {name}: acts (gate, cell, candidate) "
              f"{acts}, "
              f"step B {b} D {d} with peepholes: max_abs_err {err:.3e} "
              f"(outputs and grads, atol {RNN_ATOL:g}) kernel "
              f"{row['ms']:.6f} ms plain {row['plain_ms']:.6f} ms library "
              f"– (none takes peepholes or these activations) bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']}) launch floor "
              f"{floor:.6f} ms host {row['host_ms']:.6f} ms", flush=True)
        if not err <= RNN_ATOL:
            raise SystemExit(f"lstm_step disagrees with its plain version "
                             f"in the {acts} arm: {err}")

    t = RNN_SCAN_T
    lens = torch.randint(SRL_LENS[0], SRL_LENS[1], (b,), generator=g,
                         device="cuda", dtype=torch.int32)
    acts = SRL_ARMS[0][1]
    names = ["Input", "Weight", "Bias", "H0", "C0"]
    tensors = [randn(b, t, 4 * d, scale=0.5), randn(d, 4 * d,
                                                    scale=d ** -0.5),
               randn(1, 7 * d, scale=0.1), torch.tanh(randn(b, d)),
               randn(b, d, scale=0.5)]
    cots = [randn(b, t, d) for _ in range(2)]
    for reverse in (False, True):
        attrs = {"is_reverse": reverse, "use_peepholes": True,
                 "gate_activation": acts[0], "cell_activation": acts[1],
                 "candidate_activation": acts[2]}

        def run(plain):
            leaves = [x.detach().requires_grad_() for x in tensors]
            ins = dict({n: [x] for n, x in zip(names, leaves)},
                       SeqLen=[lens])
            if plain:
                with plain_rnn_steps(rk):
                    out = registry.run_op("lstm", ins, dict(attrs))
            else:
                out = registry.run_op("lstm", ins, dict(attrs))
            outs = [out["Hidden"][0], out["Cell"][0]]
            return outs + list(torch.autograd.grad(outs, leaves, cots))

        got, plain = run(False), run(True)
        err = max(((a - p).abs() / (1 + p.abs())).max().item()
                  for a, p in zip(got, plain))
        print(f"  lstm scan B {b} T {t} D {d} in the SRL's arm, peepholes, "
              f"reverse {reverse}: max |kernel - plain| / (1 + |plain|) "
              f"{err:.3e} (outputs and grads, bar {RNN_ATOL:g})",
              flush=True)
        if not err <= RNN_ATOL:
            raise SystemExit(f"the SRL's lstm scan (reverse {reverse}) "
                             f"departs from the plain scan: {err}")
    return rows


def srl_programs(fluid):
    """(main, startup, loss, decode, path) of the book's semantic-role
    labeller at its published sizes, seeds SEED."""
    from paddle_tpu_torch.models import label_semantic_roles as srl

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        loss, _ = srl.train_net(fluid, **srl.BOOK)
    dec = fluid.Program()
    with fluid.program_guard(dec, fluid.Program()):
        path = srl.decode_net(fluid, **srl.BOOK)
    return main, startup, loss, dec, path


def step_numbers(torch, exe, main, loss, feed, scope, warm=2,
                 timed=SRL_TIMED_STEPS):
    """A training step's wall (median of `timed` steps, each ended by the
    fetch's copy to the host, after `warm` warm-up runs, so a capturable
    program replays its graph), one more step's device busy
    (device_record), and the idle share of the step wall beside that
    busy and of the profiled wall (the profiler's own host cost
    included)."""
    def run():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope)

    for _ in range(warm):
        run()
    walls = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall, busy, _ = device_record(torch, run)
    step = statistics.median(walls)
    return {"step_ms": step, "profiled_ms": wall, "busy": busy,
            "idle": max(0.0, 1.0 - busy / step),
            "profiled_idle": 1.0 - busy / wall}


def path_score(em, trans, path, n):
    """The CRF score of tag path `path` over the first n steps of the
    emission em [T, K] under the transition [K + 2, K] (float64)."""
    em, trans = em.astype(np.float64), trans.astype(np.float64)
    p = path[:n]
    return (trans[0, p[0]] + em[np.arange(n), p].sum()
            + trans[2:][p[:-1], p[1:]].sum() + trans[1, p[-1]])


def srl_path(torch, smi):
    """The book's semantic-role labeller at its published sizes: 3 Adam
    steps on the card against the CPU from one state (K8 launched twice a
    padded step a layer: the lstm op and its generic grad's recompute),
    the frozen emb unchanged; crf_decoding fed the card's emission on the
    card and on the CPU (equal paths), and the decode program card vs CPU
    from the card's trained state; captured against uncaptured steps bit
    for bit, and the step's wall, busy and idle share."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as ex
    from paddle_tpu_torch.core.lod import bucket_len
    from paddle_tpu_torch.models import label_semantic_roles as srl
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops import rnn_kernels as rk

    cfg = srl.BOOK
    main, startup, loss, dec, path = srl_programs(fluid)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = host_state(init)
    emb = srl.pretrained_embedding(SEED, **cfg)
    state[srl.EMBEDDING_NAME] = emb
    rng = np.random.default_rng(SEED + 33)
    feeds = [srl.train_batch(rng, SRL_B, lens=SRL_LENS, **cfg)
             for _ in range(SRL_STEPS)]
    dbatch = srl.train_batch(rng, SRL_B, lens=SRL_LENS, **cfg)
    dfeed = srl.decode_feed(dbatch)
    pads = [bucket_len(max(len(w) for w in f["word_data"])) for f in feeds]
    want = sum(2 * cfg["depth"] * t for t in pads)

    losses = {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.io.state_from_numpy(state, scope=fluid.Scope(),
                                          place=place, main_program=main)
        exe = fluid.Executor(place)
        on_card = isinstance(place, fluid.CUDAPlace)
        rk.fused_lstm_cell.launches = 0
        losses[on_card] = [float(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0]) for f in feeds]
        if on_card:
            launches = rk.fused_lstm_cell.launches
            card_exe, card_scope = exe, scope
    card, cpu = losses[True], losses[False]
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    frozen = np.array_equal(card_scope.find_var(
        srl.EMBEDDING_NAME).cpu().numpy(), emb)
    print(f"[{smi}] semantic-role labeller (dictionaries "
          f"{cfg['word_dict_len']}/{cfg['pred_dict_len']}/"
          f"{cfg['label_dict_len']}, hidden {cfg['hidden_dim']}, depth "
          f"{cfg['depth']}, batch {SRL_B}, padded T {pads}), {SRL_STEPS} "
          f"Adam steps: card {card} cpu {cpu} relative differences {rel} "
          f"(bounds {PARITY_RTOL[1]:g} at step 1, {PARITY_RTOL[3]:g} at "
          f"step 3); lstm_step launches {launches} (expected {want}: twice "
          f"a padded step a layer); frozen emb unchanged on the card: "
          f"{frozen}", flush=True)
    if not np.isfinite(card + cpu).all() or rel[0] > PARITY_RTOL[1] \
            or max(rel) > PARITY_RTOL[3]:
        raise SystemExit(f"semantic-role labeller: the card departs from "
                         f"the CPU: {rel}")
    if launches != want or not frozen:
        raise SystemExit(f"semantic-role labeller: lstm_step launches "
                         f"{launches} (expected {want}), emb unchanged "
                         f"{frozen}")

    # crf_decoding on one emission tensor, card and CPU; then the decode
    # program on each from the card's trained state
    em_name = next(op.inputs["Emission"][0]
                   for op in dec.global_block().ops
                   if op.type == "crf_decoding")
    card_path, card_em = card_exe.run(dec, feed=dfeed,
                                      fetch_list=[path, em_name],
                                      scope=card_scope)
    trans = card_scope.find_var("crfw")
    lens = torch.tensor([len(w) for w in dfeed["word_data"]],
                        dtype=torch.int32)
    em = torch.from_numpy(np.ascontiguousarray(card_em))
    on_card = registry.run_op("crf_decoding", {
        "Emission": [em.cuda()], "Transition": [trans],
        "SeqLen": [lens.cuda()]}, {})["ViterbiPath"][0].cpu()
    on_cpu = registry.run_op("crf_decoding", {
        "Emission": [em], "Transition": [trans.cpu()], "SeqLen": [lens]},
        {})["ViterbiPath"][0]
    same_op = torch.equal(on_card, on_cpu)
    cpu_scope = fluid.io.state_from_numpy(
        host_state(card_scope), scope=fluid.Scope(), place=fluid.CPUPlace(),
        main_program=dec)
    cpu_path, cpu_em = fluid.Executor(fluid.CPUPlace()).run(
        dec, feed=dfeed, fetch_list=[path, em_name], scope=cpu_scope)
    trans_np = trans.cpu().numpy()
    differ, ties = [], []
    for i, n in enumerate(lens.tolist()):
        a, b = card_path[i, :n, 0], cpu_path[i, :n, 0]
        if np.array_equal(a, b):
            continue
        differ.append(i)
        sa = path_score(cpu_em[i], trans_np, a, n)
        sb = path_score(cpu_em[i], trans_np, b, n)
        if abs(sa - sb) <= SRL_TIE_GAP * max(1.0, abs(sb)):
            ties.append(i)
    pads_zero = all(not card_path[i, n:].any()
                    for i, n in enumerate(lens.tolist()))
    print(f"[{smi}] crf_decoding on the card's emission {tuple(em.shape)}: "
          f"card and CPU paths equal {same_op}; decode program card vs CPU: "
          f"{len(differ)} of {len(lens)} paths differ, {len(ties)} of them "
          f"where the CPU's scores of the two paths lie within "
          f"{SRL_TIE_GAP:g} (relative); zero past every length {pads_zero};"
          f" card path of sentence 0 {card_path[0, :lens[0], 0].tolist()}",
          flush=True)
    if not same_op or len(ties) != len(differ) or not pads_zero:
        raise SystemExit("crf_decoding: the card departs from the CPU")

    # captured against uncaptured from one state, then the step's numbers
    cap = ex.capturable(main)
    print(f"core/executor.capturable admits the training program: {cap}"
          + ("" if cap else f" (refused by {ex.capture_refusals(main)})"))
    start = host_state(card_scope)
    arms = {}
    for captured in (True, False):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        if not captured:
            exe._captured = lambda program: False
        scope = fluid.io.state_from_numpy(start, scope=fluid.Scope(),
                                          place=fluid.CUDAPlace(0),
                                          main_program=main)
        arms[captured] = ([float(exe.run(main, feed=feeds[0],
                                          fetch_list=[loss],
                                          scope=scope)[0])
                           for _ in range(SRL_STEPS)], exe, scope)
    same = arms[True][0] == arms[False][0]
    compiles = arms[True][1].compile_count
    print(f"  {SRL_STEPS} steps of one batch from one state: captured "
          f"{arms[True][0]} uncaptured {arms[False][0]}, bit for bit "
          f"{same}; compile_count {compiles}", flush=True)
    if cap and (not same or compiles != 1):
        raise SystemExit(f"semantic-role labeller: captured steps depart "
                         f"from uncaptured ones ({same}) or captured "
                         f"{compiles} signatures, not 1")
    _, exe, scope = arms[True]
    rk.fused_lstm_cell.launches = 0
    numbers = step_numbers(torch, exe, main, loss, feeds[0], scope)
    # step_numbers runs the step SRL_TIMED_STEPS + 3 times
    per_step = rk.fused_lstm_cell.launches // (SRL_TIMED_STEPS + 3)
    # the uncaptured arm is warm already and host-bound (~2 s a step)
    _, exe, scope = arms[False]
    plain = step_numbers(torch, exe, main, loss, feeds[0], scope, warm=0,
                         timed=1)
    print(f"[{smi}] semantic-role labeller step (batch {SRL_B}, padded T "
          f"{pads[0]}): {numbers['step_ms']:.6f} ms "
          f"({'captured' if cap else 'op by op'}), device busy "
          f"{numbers['busy']:.6f} ms, idle share {numbers['idle']:.4f} "
          f"(of a profiled step's {numbers['profiled_ms']:.6f} ms "
          f"{numbers['profiled_idle']:.4f}); op by op "
          f"{plain['step_ms']:.6f} ms, busy {plain['busy']:.6f} ms, idle "
          f"share {plain['idle']:.4f}; lstm_step launches a step "
          f"{per_step} (expected {2 * cfg['depth'] * pads[0]})",
          flush=True)
    if per_step != 2 * cfg["depth"] * pads[0]:
        raise SystemExit(f"semantic-role labeller: {per_step} lstm_step "
                         f"launches a timed step")
    return {"launches": launches, "captured": cap, "compiles": compiles,
            "decode_differ": len(differ), "decode_ties": len(ties),
            "plain": plain, **numbers}


def recommender_path(torch, smi):
    """The book's recommender at its published sizes, batch 256: 3 SGD
    steps on the card against the CPU from one state; its step's wall,
    busy and idle share."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import recommender_system as rec

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        loss, _ = rec.train_net(fluid, rec.BOOK_LR, **rec.BOOK)
    rng = np.random.default_rng(SEED + 34)
    feeds = [rec.train_batch(rng, REC_B, **rec.BOOK)
             for _ in range(REC_STEPS)]
    card_vs_cpu(fluid, main, startup, loss, feeds,
                f"[{smi}] recommender (users {rec.BOOK['users']}, movies "
                f"{rec.BOOK['movies']}, towers {rec.BOOK['tower']}), batch "
                f"{REC_B}, {REC_STEPS} SGD steps")
    init = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=init)
    numbers = step_numbers(torch, exe, main, loss, feeds[0], init)
    print(f"[{smi}] recommender step (batch {REC_B}): "
          f"{numbers['step_ms']:.6f} ms, device busy "
          f"{numbers['busy']:.6f} ms, idle share {numbers['idle']:.4f} "
          f"(of a profiled step's {numbers['profiled_ms']:.6f} ms "
          f"{numbers['profiled_idle']:.4f}); captured {exe.compile_count} "
          f"signature(s)", flush=True)
    return numbers


def ctc_path(torch, smi):
    """warpctc at an OCR-like shape on the card against the CPU on the
    same logits (the loss and the Logits' grad); the wall of a forward and
    backward (wall_ms: its ~7,000 small launches outrun the launch queue,
    so CUDA events would time the host's pace too) and its device busy;
    the ctc_greedy_decoder program card vs CPU (equal ids)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import registry

    rng = np.random.RandomState(SEED + 35)
    logits = (rng.standard_normal((CTC_B, CTC_T, CTC_C)) * 2
              ).astype(np.float32)
    logit_lens = rng.randint(CTC_T // 2, CTC_T + 1, CTC_B).astype(np.int32)
    label_lens = rng.randint(1, CTC_L + 1, CTC_B).astype(np.int32)
    labels = rng.randint(1, CTC_C, (CTC_B, CTC_L, 1)).astype(np.int64)
    cot = rng.standard_normal((CTC_B, 1)).astype(np.float32)

    def run(dev):
        x = torch.from_numpy(logits).to(dev).requires_grad_()
        ins = {"Logits": [x], "Label": [torch.from_numpy(labels).to(dev)],
               "LogitsLen": [torch.from_numpy(logit_lens).to(dev)],
               "LabelLen": [torch.from_numpy(label_lens).to(dev)]}
        c = torch.from_numpy(cot).to(dev)

        def fwd_bwd():
            with torch.enable_grad():
                loss = registry.run_op("warpctc", ins, {"blank": 0})[
                    "Loss"][0]
                return loss, torch.autograd.grad(loss, x, c)[0]
        return fwd_bwd

    card_fn, cpu_fn = run("cuda"), run("cpu")
    (lk, gk), (lp, gp) = card_fn(), cpu_fn()
    lk, gk = lk.detach().cpu(), gk.cpu()
    loss_rel = ((lk - lp).abs() / lp.abs()).max().item()
    grad_err = ((gk - gp).abs() / (1 + gp.abs())).max().item()
    ms = wall_ms(torch, card_fn, reps=3)
    _, busy, _ = device_record(torch, card_fn)
    t0 = time.perf_counter()
    cpu_fn()
    cpu_ms = (time.perf_counter() - t0) * 1e3

    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.data(name="x", shape=[CTC_C], dtype="float32",
                              lod_level=1)
        out = fluid.layers.ctc_greedy_decoder(input=x, blank=0)
    feed = {"x": [logits[i, :n] for i, n in enumerate(logit_lens)]}
    card_ids, cpu_ids = (fluid.Executor(place).run(
        main, feed=feed, fetch_list=[out], scope=fluid.Scope())[0]
        for place in (fluid.CUDAPlace(0), fluid.CPUPlace()))
    equal = np.array_equal(card_ids, cpu_ids)
    print(f"[{smi}] warpctc B {CTC_B} T {CTC_T} C {CTC_C} labels up to "
          f"{CTC_L}: loss card vs CPU largest relative difference "
          f"{loss_rel:.3e}, Logits grad max |card - cpu| / (1 + |cpu|) "
          f"{grad_err:.3e} (bar {CTC_RTOL:g}); forward + backward on the "
          f"card: wall {ms:.6f} ms, device busy {busy:.6f} ms (the CPU's "
          f"wall {cpu_ms:.3f} ms); ctc_greedy_decoder ids equal {equal}",
          flush=True)
    if not (loss_rel <= CTC_RTOL and grad_err <= CTC_RTOL and equal):
        raise SystemExit("warpctc or ctc_greedy_decoder: the card departs "
                         "from the CPU")
    return {"ms": ms, "busy": busy, "loss_rel": loss_rel,
            "grad_err": grad_err}


def top_k_ties(torch, smi):
    """top_k on tie-heavy rows on the card and the CPU: the lower index
    first among equal values on both (the repaired op), where torch.topk
    promises no order."""
    from paddle_tpu_torch.ops import registry

    x = torch.from_numpy(np.random.RandomState(SEED + 36).randint(
        0, 4, TIES_SHAPE).astype(np.float32))
    card = registry.run_op("top_k", {"X": [x.cuda()]}, {"k": TIES_K})
    cpu = registry.run_op("top_k", {"X": [x]}, {"k": TIES_K})
    idx_equal = torch.equal(card["Indices"][0].cpu(), cpu["Indices"][0])
    val_equal = torch.equal(card["Out"][0].cpu(), cpu["Out"][0])
    raw = torch.topk(x.cuda(), TIES_K, dim=-1)[1].cpu()
    ascending = bool((cpu["Indices"][0].diff(dim=-1) > 0).all())
    print(f"[{smi}] top_k {TIES_SHAPE} k {TIES_K} (four values a row): "
          f"card and CPU indices equal {idx_equal}, values equal "
          f"{val_equal}, indices ascending among the ties {ascending}; "
          f"rows where torch.topk on the card orders them otherwise: "
          f"{int((raw != cpu['Indices'][0]).any(dim=-1).sum())}",
          flush=True)
    if not (idx_equal and val_equal and ascending):
        raise SystemExit("top_k: the card's tie order departs from the "
                         "CPU's")


def sequence_labelling_phase(torch, smi):
    """The sequence-labelling slice on the card: K8's activation arms
    (k8_arm_checks), the semantic-role labeller (srl_path), the
    recommender (recommender_path), CTC (ctc_path) and top_k's tie order
    (top_k_ties), with the phase's seconds and peak memory."""
    phase("sequence labelling: K8's activation arms, the book's "
          "semantic-role labeller and recommender at their published "
          "sizes, warpctc and ctc_greedy_decoder, top_k's tie order")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    arms = k8_arm_checks(torch, smi)
    srl = srl_path(torch, smi)
    rec = recommender_path(torch, smi)
    ctc = ctc_path(torch, smi)
    top_k_ties(torch, smi)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{smi}] sequence labelling phase "
          f"{time.perf_counter() - t_phase:.3f} s, peak memory "
          f"{peak / 2**20:.3f} MiB", flush=True)
    torch.cuda.empty_cache()
    return {"arms": arms, "srl": srl, "rec": rec, "ctc": ctc, "peak": peak}


# ---------------------------------------------------------------------------
# The front end's ops: BERT-base under global-norm clipping, ResNet-50
# under LARS, and every op the front end builds, card against CPU
# ---------------------------------------------------------------------------

# the clipped BERT-base step: the program's global norm against
# torch.linalg.vector_norm over its unclipped grads, and each clipped
# grad against the unclipped one times 1 / max(norm, 1), both relative
CLIP_NORM_RTOL = 1e-5
CLIP_GRAD_RTOL = 1e-6
# steps of each captured path: one op by op, one captured, two replays
FRONT_END_STEPS = 4
# the op sweep's bars: the worst |card − CPU| of a floating output or
# generic grad over the CPU's largest magnitude, "ew" for elementwise
# and gather ops, "red" where a reduction, a convolution or a contraction
# sums in another order on each device; integer, bool and index outputs,
# and a random op's draws, equal
SWEEP_TOL = {"ew": 1e-6, "red": 1e-4}
# the sweep's op types: the 77 the front end emitted without a kernel
# before this slice, and the 8 optimizer ops
SWEEP_OPS = 85


def _sweep_f32(rng, *shape, scale=1.0, shift=0.0):
    """A float32 normal draw of `shape` from a torch generator seeded by
    `rng` (numpy's normal draws run at a tenth of torch's)."""
    import torch

    g = torch.Generator().manual_seed(int(rng.randint(2**31)))
    return (torch.randn(shape, generator=g) * scale + shift).numpy()


def _random_tree_edges(rng, b, n):
    """[b, n - 1, 2] 1-based edges of a random tree over n nodes a row
    (each node's parent drawn among the nodes before it)."""
    edges = np.zeros((b, n - 1, 2), np.int32)
    for i in range(b):
        for v in range(2, n + 1):
            edges[i, v - 2] = (rng.randint(1, v), v)
    return edges


def sweep_cases():
    """The op sweep: (op type, inputs maker(rng), attrs, tolerance) of
    every op type this slice ported, at a shape a model gives it: the
    elementwise ops at 2^20 elements, the losses at a batch's rows, the
    vision ops at ResNet-50's and C3D's planes, hsigmoid over 10^4
    classes at D 512."""
    f, M = _sweep_f32, (1024, 1024)

    def pos(r, *s):
        return np.abs(f(r, *s)) + 0.1

    def labels01(r, n):
        return r.randint(0, 2, (n, 1)).astype(np.float32)

    def unary(op, scale=1.0, attrs=None, maker=None, tol="ew"):
        return (op, lambda r: {"X": [maker(r) if maker else
                                     f(r, *M, scale=scale)]},
                attrs or {}, tol)

    def tags(r):
        return r.randint(0, 19, (64, 128)).astype(np.int64)

    b4 = 4096
    return [
        # math_ops (24)
        unary("sqrt", maker=lambda r: pos(r, *M)),
        unary("rsqrt", maker=lambda r: pos(r, *M)),
        unary("abs"), unary("round", 3.0),
        unary("reciprocal", maker=lambda r: pos(r, *M)),
        unary("softsign"), unary("softplus", 5.0), unary("sin", 3.0),
        unary("erf"), unary("logsigmoid", 4.0),
        unary("leaky_relu", attrs={"alpha": 0.1}),
        unary("elu", 2.0, {"alpha": 1.0}),
        unary("relu6", 4.0, {"threshold": 6.0}),
        unary("hard_sigmoid", 3.0), unary("swish", 3.0, {"beta": 1.0}),
        unary("clip", attrs={"min": -0.5, "max": 0.5}),
        unary("clip_by_norm", attrs={"max_norm": 1.0}, tol="red"),
        unary("reduce_max", attrs={"dim": [1]}),
        unary("reduce_min", attrs={"dim": [0], "keep_dim": True}),
        unary("reduce_prod", attrs={"dim": [1]}, tol="red",
              maker=lambda r: f(r, *M, scale=0.01, shift=1.0)),
        unary("squared_l2_norm", tol="red"),
        unary("isfinite"),
        ("elementwise_mod", lambda r: {"X": [f(r, *M, scale=8.0)],
                                       "Y": [pos(r, *M) * 2.0]}, {}, "ew"),
        ("elementwise_floordiv", lambda r: {"X": [f(r, *M, scale=8.0)],
                                            "Y": [pos(r, *M) * 2.0]},
         {}, "ew"),
        # tensor_ops (14)
        unary("fill_zeros_like"),
        ("squeeze", lambda r: {"X": [f(r, 1024, 1, 1024)]},
         {"axes": [1]}, "ew"),
        ("unsqueeze", lambda r: {"X": [f(r, *M)]}, {"axes": [0, 2]}, "ew"),
        ("flatten", lambda r: {"X": [f(r, 32, 128, 768)]}, {"axis": 2},
         "ew"),
        ("scatter", lambda r: {"X": [f(r, 8192, 768)],
                               "Ids": [r.permutation(8192)[:4096]
                                       .astype(np.int64)],
                               "Updates": [f(r, 4096, 768)]},
         {"overwrite": True}, "ew"),
        ("range", lambda r: {"Start": [np.array([0.0], np.float32)],
                             "End": [np.array([2.0**20], np.float32)],
                             "Step": [np.array([1.0], np.float32)]},
         {}, "ew"),
        ("shape", lambda r: {"Input": [f(r, 32, 128, 768)]}, {}, "ew"),
        ("reverse", lambda r: {"X": [f(r, 32, 128, 768)]}, {"axis": [1]},
         "ew"),
        ("argsort", lambda r: {"X": [f(r, b4, 1000)]}, {"axis": -1}, "ew"),
        ("sampling_id", lambda r: {"X": [pos(r, b4, 1000)]}, {"seed": 7},
         "ew"),
        ("multiplex", lambda r: {"X": [f(r, b4, 768) for _ in range(4)],
                                 "Ids": [r.randint(0, 4, (b4, 1))
                                         .astype(np.int32)]}, {}, "ew"),
        unary("selu", 2.0), unary("is_empty"),
        ("row_conv", lambda r: {"X": [f(r, 32, 128, 768)],
                                "Filter": [f(r, 3, 768)]}, {}, "ew"),
        # nn_ops (3)
        ("l2_normalize", lambda r: {"X": [f(r, b4, 768)]}, {"axis": 1},
         "red"),
        ("smooth_l1_loss", lambda r: {"X": [f(r, b4, 1024)],
                                      "Y": [f(r, b4, 1024)]},
         {"sigma": 3.0}, "red"),
        ("hierarchical_sigmoid", lambda r: {
            "X": [f(r, 256, 512)], "W": [f(r, 9999, 512, scale=0.05)],
            "Label": [r.randint(0, 10000, (256, 1)).astype(np.int64)],
            "Bias": [f(r, 9999)]}, {"num_classes": 10000}, "red"),
        # loss_ops (13)
        unary("sign"),
        ("log_loss", lambda r: {"Predicted": [(r.rand(65536, 1) * 0.98
                                               + 0.01).astype(np.float32)],
                                "Labels": [labels01(r, 65536)]},
         {"epsilon": 1e-4}, "ew"),
        ("hinge_loss", lambda r: {"Logits": [f(r, 65536, 1)],
                                  "Labels": [labels01(r, 65536)]}, {}, "ew"),
        ("rank_loss", lambda r: {"Label": [labels01(r, 65536)],
                                 "Left": [f(r, 65536, 1)],
                                 "Right": [f(r, 65536, 1)]}, {}, "ew"),
        ("margin_rank_loss", lambda r: {
            "Label": [labels01(r, 65536) * 2 - 1], "X1": [f(r, 65536, 1)],
            "X2": [f(r, 65536, 1)]}, {"margin": 0.1}, "ew"),
        ("modified_huber_loss", lambda r: {"X": [f(r, 65536, 1, scale=2.0)],
                                           "Y": [labels01(r, 65536)]},
         {}, "ew"),
        ("huber_loss", lambda r: {"X": [f(r, 65536, 1, scale=2.0)],
                                  "Y": [f(r, 65536, 1)]}, {"delta": 1.0},
         "ew"),
        ("kldiv_loss", lambda r: {"X": [np.log(pos(r, b4, 1000))],
                                  "Target": [pos(r, b4, 1000)]},
         {"reduction": "mean"}, "red"),
        ("squared_l2_distance", lambda r: {"X": [f(r, b4, 768)],
                                           "Y": [f(r, b4, 768)]}, {}, "red"),
        ("bpr_loss", lambda r: {"X": [f(r, b4, 1000)],
                                "Label": [r.randint(0, 1000, (b4, 1))
                                          .astype(np.int64)]}, {}, "red"),
        ("bilinear_tensor_product", lambda r: {
            "X": [f(r, b4, 256)], "Y": [f(r, b4, 256)],
            "Weight": [f(r, 64, 256, 256, scale=0.05)],
            "Bias": [f(r, 1, 64)]}, {}, "red"),
        ("teacher_student_sigmoid_loss", lambda r: {
            "X": [f(r, 65536, 1, scale=8.0)],
            "Label": [(r.rand(65536, 1)).astype(np.float32)]}, {}, "ew"),
        ("nce", lambda r: {"Input": [f(r, 1024, 256)],
                           "Label": [r.randint(0, 100000, (1024, 1))
                                     .astype(np.int64)],
                           "Weight": [f(r, 100000, 256, scale=0.05)],
                           "Bias": [f(r, 100000)]},
         {"num_neg_samples": 64, "num_total_classes": 100000, "seed": 3},
         "red"),
        # vision_ops (15)
        ("affine_channel", lambda r: {"X": [f(r, 16, 256, 56, 56)],
                                      "Scale": [f(r, 256)],
                                      "Bias": [f(r, 256)]}, {}, "ew"),
        ("group_norm", lambda r: {"X": [f(r, 32, 256, 56, 56)],
                                  "Scale": [f(r, 256)], "Bias": [f(r, 256)]},
         {"groups": 32, "epsilon": 1e-5}, "red"),
        ("lrn", lambda r: {"X": [f(r, 32, 96, 55, 55)]},
         {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75}, "red"),
        ("maxout", lambda r: {"X": [f(r, 32, 256, 28, 28)]}, {"groups": 2},
         "ew"),
        ("bilinear_interp", lambda r: {"X": [f(r, 4, 256, 64, 64)]},
         {"out_h": 128, "out_w": 128, "align_corners": False}, "ew"),
        ("nearest_interp", lambda r: {"X": [f(r, 4, 256, 64, 64)]},
         {"out_h": 128, "out_w": 128, "align_corners": True}, "ew"),
        ("crop", lambda r: {"X": [f(r, 16, 256, 56, 56)]},
         {"offsets": [0, 0, 4, 4], "shape": [16, 256, 48, 48]}, "ew"),
        ("pad_constant_like", lambda r: {"X": [f(r, 16, 256, 56, 56)],
                                         "Y": [f(r, 16, 256, 52, 52)]},
         {"pad_value": 0.0}, "ew"),
        ("space_to_depth", lambda r: {"X": [f(r, 16, 64, 112, 112)]},
         {"blocksize": 2}, "ew"),
        ("shuffle_channel", lambda r: {"X": [f(r, 32, 232, 28, 28)]},
         {"group": 2}, "ew"),
        ("conv3d", lambda r: {"Input": [f(r, 8, 64, 16, 56, 56)],
                              "Filter": [f(r, 16, 64, 3, 3, 3,
                                           scale=0.05)]},
         {"strides": [1, 1, 1], "paddings": [1, 1, 1]}, "red"),
        ("pool3d", lambda r: {"X": [f(r, 8, 64, 16, 56, 56)]},
         {"pooling_type": "max", "ksize": [2, 2, 2],
          "strides": [2, 2, 2]}, "ew"),
        ("affine_grid", lambda r: {"Theta": [f(r, 32, 2, 3, scale=0.5)]},
         {"output_shape": [32, 3, 224, 224]}, "red"),
        ("grid_sampler", lambda r: {"X": [f(r, 32, 3, 224, 224)],
                                    "Grid": [np.clip(f(r, 32, 224, 224, 2,
                                                       scale=0.6),
                                                     -1.0, 1.0)]},
         {}, "red"),
        ("random_crop", lambda r: {"X": [f(r, 32, 3, 256, 256)]},
         {"shape": [224, 224], "seed": 5}, "ew"),
        # tail_ops (7) and metric_ops (1)
        ("im2sequence", lambda r: {"X": [f(r, 32, 128, 8, 100)]},
         {"kernels": [8, 1], "strides": [1, 1]}, "ew"),
        ("tensor_array_to_tensor", lambda r: {
            "X": [(f(r, 64, 32, 512), np.array(48, np.int64))]},
         {"axis": 1, "use_stack": False}, "ew"),
        ("sample_logits", lambda r: {
            "Logits": [f(r, 128, 100000)],
            "Labels": [r.randint(0, 100000, (128, 1)).astype(np.int64)]},
         {"num_samples": 64, "seed": 9}, "ew"),
        ("chunk_eval", lambda r: {"Inference": [tags(r)],
                                  "Label": [tags(r)],
                                  "SeqLen": [r.randint(1, 129, 64)
                                             .astype(np.int32)]},
         {"chunk_scheme": "IOB", "num_chunk_types": 9}, "ew"),
        ("tree_conv", lambda r: {"NodesVector": [f(r, 32, 64, 128)],
                                 "EdgeSet": [_random_tree_edges(r, 32, 64)],
                                 "Filter": [f(r, 128, 3, 64, 4,
                                              scale=0.05)]},
         {"max_depth": 3}, "red"),
        ("hash", lambda r: {"X": [r.randint(0, 10**9, (65536, 2))
                                  .astype(np.int64)]},
         {"mod_by": 10**6, "num_hash": 4}, "ew"),
        ("similarity_focus", lambda r: {"X": [f(r, 16, 4, 48, 48)]},
         {"axis": 1, "indexes": [0, 2]}, "ew"),
        ("edit_distance", lambda r: {
            "Hyps": [r.randint(0, 30, (256, 48)).astype(np.int64)],
            "Refs": [r.randint(0, 30, (256, 48)).astype(np.int64)],
            "HypsLen": [r.randint(0, 49, 256).astype(np.int32)],
            "RefsLen": [r.randint(0, 49, 256).astype(np.int32)]},
         {"normalized": True}, "ew"),
        # optimizer_ops (8), a 1024 x 1024 parameter
        ("lars_momentum", lambda r: {"Param": [f(r, *M)], "Grad": [f(r, *M)],
                                     "Velocity": [f(r, *M)],
                                     "LearningRate": [np.array(
                                         [0.1], np.float32)]},
         {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005},
         "red"),
        ("decayed_adagrad", lambda r: {"Param": [f(r, *M)],
                                       "Grad": [f(r, *M)],
                                       "Moment": [pos(r, *M)],
                                       "LearningRate": [np.array(
                                           [0.01], np.float32)]},
         {}, "ew"),
        ("adamax", lambda r: {"Param": [f(r, *M)], "Grad": [f(r, *M)],
                              "Moment": [f(r, *M)], "InfNorm": [pos(r, *M)],
                              "Beta1Pow": [np.array([0.9], np.float32)],
                              "LearningRate": [np.array([0.01],
                                                        np.float32)]},
         {}, "ew"),
        ("adadelta", lambda r: {"Param": [f(r, *M)], "Grad": [f(r, *M)],
                                "AvgSquaredGrad": [pos(r, *M)],
                                "AvgSquaredUpdate": [pos(r, *M)]},
         {}, "ew"),
        ("rmsprop", lambda r: {"Param": [f(r, *M)], "Grad": [f(r, *M)],
                               "MeanSquare": [pos(r, *M) + 1.0],
                               "Moment": [f(r, *M)],
                               "MeanGrad": [f(r, *M, scale=0.3)],
                               "LearningRate": [np.array([0.01],
                                                         np.float32)]},
         {"momentum": 0.9, "centered": True, "epsilon": 1e-6}, "ew"),
        ("ftrl", lambda r: {"Param": [f(r, *M)], "Grad": [f(r, *M)],
                            "SquaredAccumulator": [pos(r, *M)],
                            "LinearAccumulator": [f(r, *M)],
                            "LearningRate": [np.array([0.05], np.float32)]},
         {"l1": 0.01, "l2": 0.01}, "ew"),
        ("proximal_gd", lambda r: {"Param": [f(r, *M)], "Grad": [f(r, *M)],
                                   "LearningRate": [np.array(
                                       [0.1], np.float32)]},
         {"l1": 0.05, "l2": 0.01}, "ew"),
        ("proximal_adagrad", lambda r: {"Param": [f(r, *M)],
                                        "Grad": [f(r, *M)],
                                        "Moment": [pos(r, *M)],
                                        "LearningRate": [np.array(
                                            [0.1], np.float32)]},
         {"l1": 0.05, "l2": 0.01}, "ew"),
    ]


def _on(torch, v, dev):
    if isinstance(v, tuple):
        return tuple(torch.from_numpy(a).to(dev) for a in v)
    return torch.from_numpy(v).to(dev)


def _sweep_run(torch, registry, dev, op, ins, attrs):
    """One op run of the sweep on `dev`, in a run context of that device
    (a random op's seed is the same on both: program seed 0, step 0)."""
    with registry.exec_context(registry.ExecContext(device=dev)):
        return registry.run_op(op, {s: [_on(torch, v, dev) for v in vs]
                                    for s, vs in ins.items()}, dict(attrs))


def _sweep_grad(op, ins, attrs, outs, rng):
    """The generic grad op's ins (numpy) and attrs for `op` over `ins`:
    every float32 input differentiated, every floating output given a
    cotangent from `rng`."""
    needs = [(s, i) for s, vs in ins.items() for i, v in enumerate(vs)
             if isinstance(v, np.ndarray) and v.dtype == np.float32]
    cots = {s: [_sweep_f32(rng, *v.shape) for v in vs]
            for s, vs in outs.items() if vs[0].is_floating_point()}
    gattrs = {"fw_type": op, "fw_attrs": dict(attrs),
              "fw_in_slots": [(s, len(v)) for s, v in ins.items()],
              "fw_out_slots": [(s, len(v)) for s, v in outs.items()],
              "needs_input_grad": needs,
              "has_out_grad": [(s, i) for s, cs in cots.items()
                               for i in range(len(cs))]}
    gins = dict(ins)
    gins.update({f"{s}@GRAD_OUT": cs for s, cs in cots.items()})
    return gins, gattrs, bool(needs and cots)


def _sweep_gap(torch, got, want, exact):
    """(worst |got − want| over max |want| of the floating tensors, every
    other tensor (and, with `exact`, every tensor) equal), computed on
    the card's device."""
    worst, equal = 0.0, True
    for slot, ws in want.items():
        for w, g in zip(ws, got[slot]):
            w = w.to(g.device)
            if g.shape != w.shape:
                return float("inf"), False
            if w.is_floating_point() and not exact:
                scale = float(w.abs().max()) if w.numel() else 0.0
                err = float((g.double() - w.double()).abs().max()) \
                    if w.numel() else 0.0
                worst = max(worst, err / scale if scale else err)
            elif not torch.equal(g, w):
                equal = False
    return worst, equal


# random ops whose every output must match bit for bit (a copy of X at
# the drawn offsets); the others' draws are their integer outputs
SWEEP_EXACT = {"random_crop"}


def op_sweep(torch, smi):
    """Every op type this slice ported, on the card and on the CPU from
    the same seeded inputs at a model's shape (sweep_cases): outputs and,
    for a differentiable op, its generic grad under the same cotangents.
    Returns {op: (forward gap, grad gap or None)}; fails on any miss."""
    from paddle_tpu_torch.ops import registry

    cpu, card = torch.device("cpu"), torch.device("cuda")
    cases = sweep_cases()
    if len({c[0] for c in cases}) != SWEEP_OPS:
        raise SystemExit(f"op sweep: {len({c[0] for c in cases})} op "
                         f"types, expected {SWEEP_OPS}")
    t0 = time.perf_counter()
    rows, misses = {}, []
    for k, (op, make, attrs, tol) in enumerate(cases):
        rng = np.random.RandomState(SEED + 900 + k)
        ins = make(rng)
        want = _sweep_run(torch, registry, cpu, op, ins, attrs)
        got = _sweep_run(torch, registry, card, op, ins, attrs)
        fwd, equal = _sweep_gap(torch, got, want, op in SWEEP_EXACT)
        grad, gequal = None, True
        if registry.is_differentiable(op):
            gins, gattrs, has = _sweep_grad(op, ins, attrs, want, rng)
            if has:
                gw = _sweep_run(torch, registry, cpu, "generic_grad", gins,
                                gattrs)
                gg = _sweep_run(torch, registry, card, "generic_grad",
                                gins, gattrs)
                grad, gequal = _sweep_gap(torch, gg, gw, False)
        bar = SWEEP_TOL[tol]
        held = equal and gequal and fwd <= bar and (grad is None or
                                                    grad <= bar)
        rows[op] = (fwd, grad)
        shapes = {s: [tuple(v.shape) if hasattr(v, "shape") else
                      tuple(v[0].shape) for v in vs] for s, vs in ins.items()}
        print(f"  {op} {shapes}: out {fwd:.3e}"
              + ("" if grad is None else f", grad {grad:.3e}")
              + f" (bar {bar:g}), ints/bools equal {equal and gequal}"
              + ("" if held else "  MISS"), flush=True)
        if not held:
            misses.append(op)
        del ins, want, got
    torch.cuda.empty_cache()
    worst = max(rows, key=lambda o: max(rows[o][0], rows[o][1] or 0.0))
    grads = sum(g is not None for _, g in rows.values())
    print(f"[{smi}] op sweep: {len(rows) - len(misses)} of {len(rows)} op "
          f"types held card vs CPU, {grads} generic grads; worst {worst} "
          f"{rows[worst]}; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if misses:
        raise SystemExit(f"op sweep: the card departs from the CPU at "
                         f"{misses}")
    return rows


def clip_program_vars(main):
    """(global norm var, [(grad, clipped grad)]) of a program minimized
    under GradientClipByGlobalNorm: the `sqrt` over the `sum` of the
    grads' `squared_l2_norm`, and each `elementwise_mul` by the scale
    (clip.append_gradient_clip_ops' chain)."""
    ops = main.global_block().ops
    sq_out = {op.output("Out")[0]: op.input("X")[0] for op in ops
              if op.type == "squared_l2_norm"}
    total = next(op.output("Out")[0] for op in ops if op.type == "sum"
                 and op.input("X") and all(n in sq_out
                                           for n in op.input("X")))
    norm = next(op.output("Out")[0] for op in ops if op.type == "sqrt"
                and op.input("X") == [total])
    mx = next(op.output("Out")[0] for op in ops
              if op.type == "elementwise_max" and op.input("X") == [norm])
    scale = next(op.output("Out")[0] for op in ops
                 if op.type == "elementwise_div" and op.input("Y") == [mx])
    pairs = [(op.input("X")[0], op.output("Out")[0]) for op in ops
             if op.type == "elementwise_mul" and op.input("Y") == [scale]]
    if sorted(g for g, _ in pairs) != sorted(sq_out.values()):
        raise SystemExit("the clipped program scales other grads than it "
                         "measures")
    return norm, pairs


def global_norm_check(torch, fluid, main, startup, loss, feed):
    """One op-by-op step of the clipped program from its startup state,
    fetching the loss, the program's global norm and every grad before
    and after the clip: the norm against torch.linalg.vector_norm over
    the unclipped grads (float64, CLIP_NORM_RTOL) and each clipped grad
    against the unclipped one times 1 / max(norm, 1) (CLIP_GRAD_RTOL,
    relative to each grad's largest magnitude)."""
    norm_name, pairs = clip_program_vars(main)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe._captured = lambda program: False
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    names = [norm_name] + [g for g, _ in pairs] + [c for _, c in pairs]
    out = exe.run(main, feed=feed, fetch_list=[loss.name] + names,
                  scope=scope, return_numpy=False)
    norm = float(torch.as_tensor(out[1]).reshape(()))
    n = len(pairs)
    grads = [torch.as_tensor(t).double() for t in out[2:2 + n]]
    clipped = [torch.as_tensor(t).double() for t in out[2 + n:]]
    ref = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads])))
    norm_rel = abs(norm - ref) / ref
    factor = 1.0 / max(norm, 1.0)
    grad_rel = max(float((c - g * factor).abs().max())
                   / max(float((g * factor).abs().max()), 1e-30)
                   for g, c in zip(grads, clipped))
    print(f"global-norm clip (1.0) over {n} grads: the program's norm "
          f"{norm:.6f}, torch.linalg.vector_norm {ref:.6f}, relative "
          f"{norm_rel:.3e} (bar {CLIP_NORM_RTOL:g}); clipped = grad / "
          f"max(norm, 1) within {grad_rel:.3e} (bar {CLIP_GRAD_RTOL:g}); "
          f"the clip {'scales' if norm > 1.0 else 'leaves'} the grads",
          flush=True)
    exe.close()
    if not (norm_rel <= CLIP_NORM_RTOL and grad_rel <= CLIP_GRAD_RTOL):
        raise SystemExit(f"global-norm clip: norm {norm} vs {ref}, "
                         f"clipped grads off by {grad_rel}")
    return {"norm": norm, "norm_rel": norm_rel, "grad_rel": grad_rel,
            "grads": n}


def front_end_phase(torch, smi, compiled):
    """The slice's paths on the card: BERT-base pretraining under
    LARK/BERT's global-norm clip (1.0) captured against uncaptured from
    one state (compiled_path, the K1/K2a/K2b/K10 launches of
    training_phase) with its norm checked (global_norm_check); ResNet-50
    fp32 at batch 128 under LarsMomentum(0.1, 0.9) captured against
    uncaptured; then the op sweep.  Each step's numbers print beside
    compiled_step_phase's unclipped BERT-base and Momentum ResNet-50
    (`compiled`, its result; None prints them alone)."""
    import paddle_tpu_torch as fluid

    phase("front end: BERT-base under global-norm clipping, ResNet-50 "
          "under LARS, every op the front end builds card vs CPU")
    t0 = time.perf_counter()
    fluid.set_flags({"use_fused_dropout": True})
    clip = fluid.clip.GradientClipByGlobalNorm(clip_norm=1.0)
    bert = pretrain_program(fluid, 12, 0.1, clip=clip)
    feeds = [pretrain_feed(TRAIN_B, TRAIN_T, TRAIN_M, SEED + 41 + i % 2)
             for i in range(FRONT_END_STEPS)]
    norm = global_norm_check(torch, fluid, *bert, feeds[0])
    out = {"norm": norm}
    out["bert"] = compiled_path(torch, smi, fluid,
                                "BERT-base fp32, global-norm clip",
                                lambda: bert, feeds, 1, "bert")
    fluid.set_flags({"use_fused_dropout": False})
    del bert

    def resnet():
        main, startup, loss, _ = resnet50_program(
            fluid, optimizer=lambda f: f.optimizer.LarsMomentum(
                learning_rate=0.1, momentum=0.9))
        return main, startup, loss

    def images(main):
        slots = [v.name for v in main._py_readers[0].feed_vars]
        img_rng = np.random.RandomState(0)
        return [dict(zip(slots, image_batch(img_rng, R50_B)))
                for _ in range(FRONT_END_STEPS)]

    out["resnet50"] = compiled_path(torch, smi, fluid, "ResNet-50 fp32 LARS",
                                    resnet, images, 1)
    for key, label, base in (("bert", "BERT-base fp32 global-norm clip",
                              "unclipped"),
                             ("resnet50", "ResNet-50 fp32 LARS", "Momentum")):
        c = out[key]
        line = (f"[{smi}] {label}: step {c['step_ms']:.6f} ms, idle share "
                f"{1.0 - c['busy'] / c['wall']:.4f}, peak "
                f"{c['peak'] / 2**30:.3f} GiB")
        if compiled is not None:
            b = compiled[key]
            line += (f"; {base} (compiled step phase): step "
                     f"{b['step_ms']:.6f} ms, idle share "
                     f"{1.0 - b['busy'] / b['wall']:.4f}, peak "
                     f"{b['peak'] / 2**30:.3f} GiB")
        print(line, flush=True)
    out["sweep"] = op_sweep(torch, smi)
    out["seconds"] = time.perf_counter() - t0
    print(f"[{smi}] front end phase {out['seconds']:.3f} s", flush=True)
    return out


# the front end's remainder: the Predictor's zero-copy and AOT paths, the
# gradient merge and the model average on BERT-base, the Trainer
ZC_B = 32                   # the zero-copy batch
AOT_B = 8                   # the exported batch: serving_phase's max batch
AOT_RTOL = 1e-6             # exported against program mode (expected 0)
AOT_DEVICE = "cuda"         # the device kind an export on the card records
GM_K, GM_MICRO, GM_STEPS = 4, 8, 8
GM_SGD_LR = 0.1
# test_torch_gradient_merge.py's bars for k merged micro-batches against
# one SGD step on their whole batch: each parameter within 1e-6 relative
# and absolute (printed here: at BERT-base the whole batch's fp32 sums run
# over 4096 tokens, and two free runs of one step part by ~1e-6, the
# embedding grads' atomics), and each parameter's update within 1e-3 of
# the whole batch's (2-norms; the gate: fp32 sums of 4096 terms with
# cancellation part by 1e-5 to 1e-4, while a lost 1/k is a gap of 3, a
# lost micro-batch 0.25 or more)
GM_SGD_TOL = 1e-6
GM_UPDATE_GAP = 1e-3
MA_RATE, MA_MIN, MA_MAX, MA_STEPS = 0.15, 2, 6, 10
MA_RTOL = 1e-6
FAL_B, FAL_BATCHES, FAL_EPOCHS = 32, 12, 2


def rel_err(got, want):
    """max |got - want| over max |want| (float64)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def zero_copy_path(torch, smi, fluid, fp32):
    """BERT-base served through the zero-copy API at batch ZC_B: inputs
    staged on the card once, zero_copy_run's output read back equal to
    run()'s bit for bit, K1 12 times a batch; the walls of both."""
    from paddle_tpu_torch.ops import attention_kernels as ak

    pred = fluid.create_paddle_predictor(
        fluid.AnalysisConfig(fp32["model_dir"]))
    names = pred.get_input_names()
    batch = {n: np.concatenate([r[n] for r in fp32["reqs"][:ZC_B]])
             for n in names}
    out = pred.get_output_tensor(pred.get_output_names()[0])

    def stage():
        for n in names:
            pred.get_input_tensor(n).copy_from_cpu(batch[n])

    for _ in range(2):            # the signature's warm-up and capture
        pred.run(batch)
    stage()
    pred.zero_copy_run()
    torch.cuda.synchronize()
    if not (isinstance(out._buf, torch.Tensor) and out._buf.is_cuda):
        raise SystemExit("zero_copy_run's output left the card before "
                         "copy_to_cpu")
    ak.flash_attention.launches = 0
    pred.zero_copy_run()
    staged = out.copy_to_cpu()
    launches = ak.flash_attention.launches
    ran = pred.run(batch)[0]
    equal = bool(np.array_equal(staged, ran))
    stage_ms = wall_ms(torch, stage, reps=10)
    zc_ms = wall_ms(torch, lambda: (pred.zero_copy_run(), out.copy_to_cpu()),
                    reps=10)
    run_ms = wall_ms(torch, lambda: pred.run(batch), reps=10)
    print(f"[{smi}] zero-copy BERT-base batch {ZC_B}: zero_copy_run + "
          f"copy_to_cpu {zc_ms:.6f} ms (staging the inputs once "
          f"{stage_ms:.6f} ms), run() {run_ms:.6f} ms (medians of 10 after "
          f"5 warm-ups); "
          f"equal to run() bit for bit {equal}; flash_attention_fwd "
          f"launches a batch {launches}", flush=True)
    if not equal or launches != 12:
        raise SystemExit(f"zero-copy run: equal {equal}, K1 launches "
                         f"{launches} (expected 12)")
    return {"ms": zc_ms, "run_ms": run_ms, "launches": launches}


AOT_KINDS = ("fp32", "bf16", "quant")


def export_worker(kind, src, dst):
    """One precision's AOT path in a process of its own (the phase runs
    the three beside its training paths, since a trace is host work): a
    program-mode Predictor on the card over `src` with the precision
    `kind` answers dst/batch.npz, exports into `dst`, and a fresh
    Predictor over `dst` (no Program built) answers the batch again; the
    numbers go to dst/result.json, which aot_path checks."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference as inf
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import quant_kernels as qk

    device_phase(torch)         # TF32 off, as in the phase's process
    cfg = fluid.AnalysisConfig(src)
    if kind == "bf16":
        cfg.enable_bf16()
    if kind == "quant":
        cfg.enable_quantize()
    prog = fluid.create_paddle_predictor(cfg)
    batch = dict(np.load(os.path.join(dst, "batch.npz")))
    want = prog.run(batch)[0]
    t0 = time.perf_counter()
    prog.export_serialized(batch, dirname=dst)
    export_s = time.perf_counter() - t0
    del prog
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    aot = fluid.create_paddle_predictor(fluid.AnalysisConfig(dst))
    load_s = time.perf_counter() - t0
    nodes = [str(n.target) for n in aot._aot.ep.graph.nodes
             if n.op == "call_function"]
    counters = {"fwd": ak.flash_attention, "quant": qk.int8_matmul}
    for c in counters.values():
        c.launches = 0
    got = aot.run(batch)[0]
    with open(os.path.join(dst, "result.json"), "w") as f:
        json.dump({"export_s": export_s, "load_s": load_s,
                   "program_built": aot._program is not None,
                   "k1_nodes": nodes.count(inf.CUSTOM_OPS["K1"]),
                   "k6_nodes": nodes.count(inf.CUSTOM_OPS["K6"]),
                   "launches": {k: c.launches for k, c in counters.items()},
                   "rel_err": rel_err(got, want),
                   "bit_for_bit": bool(np.array_equal(got, want)),
                   "bytes": os.path.getsize(os.path.join(
                       dst, inf.SERIALIZED_PT2))}, f)


def start_exports(fp32):
    """One export_worker process a precision over serving_phase's model
    dir at batch AOT_B: {kind: (process, directory)}."""
    here = os.path.dirname(os.path.abspath(__file__))
    names = ("src_ids", "pos_ids", "sent_ids", "attn_bias")
    batch = {n: np.concatenate([r[n] for r in fp32["reqs"][:AOT_B]])
             for n in names}
    # a trace is one Python thread: no intra-op pool to oversubscribe the
    # host beside the phase's own process
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = {}
    for kind in AOT_KINDS:
        d = tempfile.mkdtemp(prefix=f"aot_{kind}_")
        shutil.copytree(fp32["model_dir"], d, dirs_exist_ok=True)
        np.savez(os.path.join(d, "batch.npz"), **batch)
        code = (f"import sys; sys.path.insert(0, {here!r}); "
                f"import chip_smoke; chip_smoke.export_worker({kind!r}, "
                f"{fp32['model_dir']!r}, {d!r})")
        out[kind] = (subprocess.Popen([sys.executable, "-c", code], cwd=here,
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     d)
    return out


def aot_path(torch, smi, fluid, fp32, exports):
    """Each precision's AOT path (export_worker, one process each): K1
    (and K6) as custom-op nodes and launches a batch of the artifact a
    fresh Predictor loaded, its answers against program mode's on the
    same batch, the meta; the fp32 artifact also loaded here and served
    (aot_serving) before the other precisions' processes are waited
    for."""
    from paddle_tpu_torch import inference as inf

    out = {}
    for kind in AOT_KINDS:
        proc, d = exports[kind]
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"AOT {kind}: the export process failed:\n{log}")
        row = json.load(open(os.path.join(d, "result.json")))
        meta = json.load(open(os.path.join(d, inf.SERIALIZED_META)))
        print(f"[{smi}] AOT {kind} (its own process): export "
              f"{row['export_s']:.3f} s ({row['bytes']} bytes), load "
              f"{row['load_s']:.3f} s, program built {row['program_built']}, "
              f"meta amp {meta['amp']} quant {meta['quant']} device "
              f"{meta['device']} custom ops {meta['custom_ops']}; graph "
              f"nodes K1 {row['k1_nodes']} K6 {row['k6_nodes']}, launches a "
              f"batch {row['launches']}; against program mode max relative "
              f"error {row['rel_err']:.3e} (bar {AOT_RTOL:g}), bit for bit "
              f"{row['bit_for_bit']}", flush=True)
        want_k6 = 74 if kind == "quant" else 0
        if row["program_built"] or row["k1_nodes"] != 12 or \
                row["launches"]["fwd"] != 12 or row["k6_nodes"] != want_k6 \
                or row["launches"]["quant"] != want_k6 or \
                row["rel_err"] > AOT_RTOL or \
                meta["amp"] != (kind == "bf16") or \
                meta["quant"] != (kind == "quant") or \
                meta["device"] != AOT_DEVICE:
            raise SystemExit(f"AOT {kind}: {row}, meta {meta}")
        out[kind] = row
        if kind == "fp32":
            # served here while the other exports finish
            out[kind].update(aot_serving(torch, smi, fluid, fp32, d))
    return out


def aot_serving(torch, smi, fluid, fp32, d):
    """The fp32 artifact in `d` loaded here and served through
    ServingEngine on serving_phase's requests, beside serving_phase's
    program-mode engine (max batch AOT_B) earlier in this run."""
    from paddle_tpu_torch.ops import attention_kernels as ak

    t0 = time.perf_counter()
    aot = fluid.create_paddle_predictor(fluid.AnalysisConfig(d))
    load_s = time.perf_counter() - t0
    served = serve(fluid, aot, fp32["reqs"], AOT_B,
                   {"fwd": ak.flash_attention})
    per_batch = served["launches"]["fwd"] / served["batches"]
    err = float(np.abs(served["served"] - fp32["served"]).max())
    print(f"[{smi}] AOT fp32 through ServingEngine (loaded here in "
          f"{load_s:.3f} s): {served['line']}; program mode (serving "
          f"phase): {fp32['line']}; K1 launches a batch {per_batch:g}; "
          f"answers against program mode's max_abs_err {err:.3e}",
          flush=True)
    del aot
    torch.cuda.empty_cache()
    if per_batch != 12 or err > SERVE_ATOL:
        raise SystemExit(f"AOT serving: K1 {per_batch} a batch, answers "
                         f"{err}")
    return {"p50": served["p50"], "p99": served["p99"],
            "program_p50": fp32["p50"], "program_p99": fp32["p99"],
            "serving_launches": per_batch}


def bert_base_program(fluid, dropout, batch_optimizer):
    """BERT-base pretraining (12 layers) under `batch_optimizer(fluid, loss)`
    (which calls minimize and returns whatever it builds besides), its
    names fixed by a unique_name guard so two builds share parameter
    names: (main, startup, loss, extra)."""
    from paddle_tpu_torch.models.bert import BertConfig, bert_pretrain

    cfg = BertConfig(num_layers=12, dropout=dropout, **BERT_BASE)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss, _ = bert_pretrain(cfg, TRAIN_T)
        extra = batch_optimizer(fluid, loss)
    return main, startup, loss, extra


def split_feed(feed, k):
    """A pretrain_feed batch cut into k equal micro-batches, each
    mask_pos re-based to its own rows."""
    b, t = feed["src_ids"].shape
    bm, m = b // k, feed["mask_pos"].shape[0] // b
    out = []
    for i in range(k):
        rows, masked = slice(i * bm, (i + 1) * bm), \
            slice(i * bm * m, (i + 1) * bm * m)
        micro = {n: feed[n][rows] for n in ("src_ids", "pos_ids",
                                            "sent_ids", "attn_bias",
                                            "nsp_label")}
        micro.update({n: feed[n][masked] for n in ("mlm_label",
                                                   "mlm_weight")})
        micro["mask_pos"] = feed["mask_pos"][masked] - i * bm * t
        out.append(micro)
    return out


def gradient_merge_path(torch, smi, fluid):
    """BERT-base under GradientMergeOptimizer(Adam, k_steps=GM_K) at
    micro-batch GM_MICRO, dropout 0.1 through K10, GM_STEPS steps: one
    captured signature, the capture refusing nothing; captured against
    uncaptured (compiled_arm: each uncaptured step from the captured
    state before it) with losses bit for bit; every parameter and Adam
    moment unchanged bit for bit off the boundary; K1/K2a/K2b/K10 launches
    a micro-step.  Then under SGD with dropout 0: the boundary update of
    k merged micro-batches against one step on their whole batch."""
    from paddle_tpu_torch.core.executor import capture_refusals
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import dropout_kernels as dk

    t0 = time.perf_counter()
    fluid.set_flags({"use_fused_dropout": True})

    def merged(inner):
        def build(f, loss):
            f.optimizer.GradientMergeOptimizer(inner(f), k_steps=GM_K,
                                               avg=True).minimize(loss)
        return build

    main, startup, loss, _ = bert_base_program(
        fluid, 0.1, merged(lambda f: f.optimizer.Adam(learning_rate=1e-4)))
    refused = capture_refusals(main)
    init = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=init)
    start = clone_state(init)
    del init
    feeds = [pretrain_feed(GM_MICRO, TRAIN_T, TRAIN_M, SEED + 61 + i)
             for i in range(GM_STEPS)]
    counters = {"fwd": ak.flash_attention, "dkv": ak.flash_attention_bwd_dkv,
                "dq": ak.flash_attention_bwd_dq, "dropout": dk.fused_dropout}
    held = []
    cap = compiled_arm(torch, fluid, main, loss, start, feeds, True, held,
                       counters)
    compiles = cap["exe"].compile_count
    cap["exe"].close()
    del cap["exe"], cap["scope"], cap["step"]
    block = main.global_block()
    state = sorted(n for n in held[0]
                   if held[0][n].is_floating_point()
                   and "@GRAD_MERGE" not in n and block.has_var(n)
                   and not n.startswith("learning_rate"))
    params = {p.name for p in main.all_parameters()}
    frozen, moved = [], []
    for i in range(GM_STEPS):
        changed = [n for n in state
                   if not torch.equal(held[i][n], held[i + 1][n])]
        if (i + 1) % GM_K:
            frozen.append(len(changed) == 0)
        else:
            moved.append(params <= set(changed))
    unc = compiled_arm(torch, fluid, main, loss, start, feeds, False, held,
                       counters)
    unc["exe"].close()
    del unc["exe"], unc["scope"], unc["step"], held, start
    torch.cuda.empty_cache()
    equal = cap["losses"] == unc["losses"]
    worst_gap = max(g[1] for g in unc["gaps"])
    want = COMPILED_LAUNCHES["bert"]
    step_ms = statistics.median(cap["walls"]) * 1e3
    print(f"[{smi}] GradientMerge(Adam, k {GM_K}) BERT-base micro-batch "
          f"{GM_MICRO}: capture refusals {refused}, captured signatures "
          f"{compiles}; captured losses {cap['losses']}, uncaptured "
          f"{unc['losses']} (each step from the captured state before it), "
          f"bit for bit {equal}; worst leaf gap of an update "
          f"{worst_gap:.3e} (bar {COMPILED_LEAF_GAP:g}); {len(state)} "
          f"parameters and optimizer states unchanged bit for bit off the "
          f"boundary {frozen}, every parameter moved on it {moved}; "
          f"launches a micro-step {cap['launches']} (uncaptured "
          f"{unc['launches']}); replayed micro-step {step_ms:.6f} ms, peak "
          f"{cap['peak']} bytes ({cap['peak'] / 2**30:.3f} GiB)",
          flush=True)
    if refused or compiles != 1 or not equal or not all(frozen) or \
            not all(moved) or cap["launches"] != want or \
            unc["launches"] != want or not worst_gap <= COMPILED_LEAF_GAP:
        raise SystemExit("GradientMerge on BERT-base failed its checks")
    fluid.set_flags({"use_fused_dropout": False})
    return {"launches": cap["launches"], "step_ms": step_ms,
            "peak": cap["peak"], "seconds": time.perf_counter() - t0}


def gradient_merge_sgd_check(torch, smi, fluid):
    """BERT-base, dropout 0 (no random draw tells the arms apart): GM_K
    micro-batches of GM_MICRO merged by GradientMergeOptimizer(SGD)
    against one SGD step on their whole batch from the same state, each
    parameter's update compared."""
    t0 = time.perf_counter()

    def sgd(f):
        return f.optimizer.SGD(learning_rate=GM_SGD_LR)

    def merged(f, loss):
        f.optimizer.GradientMergeOptimizer(sgd(f), k_steps=GM_K,
                                           avg=True).minimize(loss)

    gm = bert_base_program(fluid, 0.0, merged)
    big = bert_base_program(fluid, 0.0,
                            lambda f, loss: sgd(f).minimize(loss))
    init = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(gm[1], scope=init)
    start = clone_state(init)
    del init
    whole = pretrain_feed(GM_K * GM_MICRO, TRAIN_T, TRAIN_M, SEED + 71)
    names = [p.name for p in gm[0].all_parameters()]
    after = {}
    for label, (prog, _, lss, _), feeds in (
            ("merged", gm, split_feed(whole, GM_K)),
            ("whole", big, [whole])):
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), \
            scope_from(fluid, start)
        for feed in feeds:
            exe.run(prog, feed=feed, fetch_list=[lss], scope=scope)
        after[label] = {n: scope.find_var(n).clone() for n in names}
        exe.close()
    rows = []
    for n in names:
        w, m, p0 = (after["whole"][n].double(), after["merged"][n].double(),
                    start[n].double())
        update = torch.linalg.vector_norm(w - p0).item()
        gap = torch.linalg.vector_norm(m - w).item() / max(update, 1e-30)
        off = (m - w).abs().max().item()
        elementwise = off / (GM_SGD_TOL * (1.0 + w.abs().max().item()))
        rows.append((gap, n, elementwise, off, (w - p0).abs().max().item()))
    rows.sort(reverse=True)
    worst = rows[0][0]
    worst_elementwise = max(r[2] for r in rows)
    largest = max(r[4] for r in rows)
    print(f"[{smi}] GradientMerge(SGD {GM_SGD_LR}, k {GM_K}) BERT-base, "
          f"dropout 0: {GM_K} merged micro-batches of {GM_MICRO} against "
          f"one step on their batch of {GM_K * GM_MICRO}, over {len(names)} "
          f"parameters: worst update gap ||merged - whole|| / ||whole - "
          f"start|| {worst:.3e} (bar {GM_UPDATE_GAP:g}); elementwise, the "
          f"worst |merged - whole| over {GM_SGD_TOL:g} (1 + |whole|) "
          f"{worst_elementwise:.3f} (1 or less meets the CPU test's "
          f"elementwise bar); largest update {largest:.3e}; worst five "
          f"(parameter, update gap, |merged - whole|, largest update "
          f"element) {[(r[1], f'{r[0]:.3e}', f'{r[3]:.3e}', f'{r[4]:.3e}') for r in rows[:5]]}; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    del after, start, gm, big
    torch.cuda.empty_cache()
    if worst > GM_UPDATE_GAP or largest < 100 * GM_SGD_TOL:
        raise SystemExit(f"GradientMerge: merged update off the whole "
                         f"batch's: {rows[:5]}")
    return {"worst": worst, "elementwise": worst_elementwise}


def window_average(values, rate, min_w, max_w):
    """average_accumulates' window over the recorded values, on the host
    in float64: the average ModelAverage.apply must put in place."""
    s1 = s2 = s3 = 0.0
    n_acc = old = n_upd = 0
    for v in values:
        n_upd += 1
        n_acc += 1
        s1 = s1 + v
        if n_upd % 16384 == 0:
            s2, s1 = s2 + s1, 0.0
        limit = min(max_w, int(np.floor(np.float32(n_upd) *
                                        np.float32(rate))))
        if n_acc >= min_w and n_acc >= limit:
            s3, s1, s2, old, n_acc = s1 + s2, 0.0, 0.0, n_acc, 0
    return (s1 + s2 + s3) / (n_acc + old)


def model_average_path(torch, smi, fluid):
    """BERT-base with Adam and ModelAverage(MA_RATE, MA_MIN, MA_MAX),
    MA_STEPS captured steps at batch GM_MICRO with dropout 0.1: one
    signature, the launches of training_phase a step; apply() puts the
    window average of each parameter in place (three held against a
    host average of their recorded values), restore() the live values
    bit for bit."""
    from paddle_tpu_torch.core.executor import capture_refusals
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import dropout_kernels as dk

    t0 = time.perf_counter()
    fluid.set_flags({"use_fused_dropout": True})

    def build(f, loss):
        f.optimizer.Adam(learning_rate=1e-4).minimize(loss)
        return f.optimizer.ModelAverage(MA_RATE, min_average_window=MA_MIN,
                                        max_average_window=MA_MAX)

    main, startup, loss, ma = bert_base_program(fluid, 0.1, build)
    refused = capture_refusals(main)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in ma.params]
    watched = [names[0], names[len(names) // 2], names[-1]]
    recorded = {n: [] for n in watched}
    counters = {"fwd": ak.flash_attention, "dkv": ak.flash_attention_bwd_dkv,
                "dq": ak.flash_attention_bwd_dq, "dropout": dk.fused_dropout}
    feeds = [pretrain_feed(GM_MICRO, TRAIN_T, TRAIN_M, SEED + 81 + i % 2)
             for i in range(2)]
    walls = []
    for i in range(MA_STEPS):
        for c in counters.values():
            c.launches = 0
        t_step = time.perf_counter()
        exe.run(main, feed=feeds[i % 2], fetch_list=[loss], scope=scope)
        walls.append(time.perf_counter() - t_step)
        for n in watched:
            recorded[n].append(scope.find_var(n).double().cpu().numpy())
    launches = {k: c.launches for k, c in counters.items()}
    live = {n: scope.find_var(n).clone() for n in names}
    with fluid.scope_guard(scope):
        with ma.apply(exe):
            averaged = {n: scope.find_var(n).clone() for n in names}
    restored = all(torch.equal(scope.find_var(n), live[n]) for n in names)
    errs = {n: rel_err(averaged[n].double().cpu().numpy(),
                       window_average(recorded[n], MA_RATE, MA_MIN, MA_MAX))
            for n in watched}
    changed = sum(not torch.equal(averaged[n], live[n]) for n in names)
    compiles = exe.compile_count
    # steps 3 on replay the captured graph (each ended by its loss fetch)
    step_ms = statistics.median(walls[2:]) * 1e3
    exe.close()
    del live, averaged
    torch.cuda.empty_cache()
    print(f"[{smi}] ModelAverage({MA_RATE}, {MA_MIN}, {MA_MAX}) on BERT-base"
          f" with Adam, {MA_STEPS} steps: capture refusals {refused}, "
          f"captured signatures {compiles}, launches of the last step "
          f"{launches}, replayed step {step_ms:.6f} ms (median of "
          f"{MA_STEPS - 2}); apply(): {changed} of {len(names)} parameters "
          f"averaged, relative error against the host window average "
          f"{errs} (bar {MA_RTOL:g}); restore() bit for bit {restored}",
          flush=True)
    fluid.set_flags({"use_fused_dropout": False})
    if refused or compiles != 1 or launches != COMPILED_LAUNCHES["bert"] \
            or not restored or max(errs.values()) > MA_RTOL or \
            changed != len(names):
        raise SystemExit("ModelAverage on BERT-base failed its checks")
    return {"launches": launches, "step_ms": step_ms,
            "seconds": time.perf_counter() - t0}


def trainer_path(torch, smi, fluid):
    """The book's fit_a_line through Trainer on the card (the pipelined
    dataio loop, FAL_EPOCHS epochs with its events), then Inferencer on
    the saved parameters against a CPU Inferencer on them."""
    def net():
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        return fluid.layers.fc(input=x, size=1, act=None)

    def train_func():
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        return [fluid.layers.mean(fluid.layers.square_error_cost(
            input=net(), label=y))]

    def reader():
        rng = np.random.RandomState(SEED)
        w = np.linspace(-1.0, 1.0, 13).astype(np.float32)
        for _ in range(FAL_BATCHES):
            x = rng.randn(FAL_B, 13).astype(np.float32)
            y = x @ w + 0.5
            yield [(x[i], np.array([y[i]], np.float32))
                   for i in range(FAL_B)]

    t0 = time.perf_counter()
    trainer = fluid.Trainer(train_func,
                            lambda: fluid.optimizer.SGD(learning_rate=0.05),
                            place=fluid.CUDAPlace(0))
    events, losses = [], []

    def handler(e):
        events.append(type(e).__name__)
        if isinstance(e, fluid.EndStepEvent):
            losses.append(float(np.asarray(e.metrics[0]).reshape(())))

    trainer.train(FAL_EPOCHS, handler, reader=reader, feed_order=["x", "y"])
    path = tempfile.mkdtemp(prefix="fit_a_line_")
    trainer.save_params(path)
    xb = np.random.RandomState(SEED + 1).randn(8, 13).astype(np.float32)
    card = fluid.Inferencer(net, path, place=fluid.CUDAPlace(0)).infer(
        {"x": xb})[0]
    cpu = fluid.Inferencer(net, path, place=fluid.CPUPlace()).infer(
        {"x": xb})[0]
    shutil.rmtree(path, ignore_errors=True)
    err = float(np.abs(card - cpu).max())
    want = ["BeginEpochEvent"] + ["BeginStepEvent", "EndStepEvent"] * \
        FAL_BATCHES + ["EndEpochEvent"]
    print(f"[{smi}] Trainer fit_a_line: {FAL_EPOCHS} epochs of "
          f"{FAL_BATCHES} batches of {FAL_B}, losses {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}, events in order "
          f"{events == want * FAL_EPOCHS}; Inferencer card vs CPU "
          f"max_abs_err {err:.3e} (atol {SERVE_ATOL:g}); "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if events != want * FAL_EPOCHS or not np.isfinite(losses).all() or \
            not losses[-1] < 0.5 * losses[0] or err > SERVE_ATOL:
        raise SystemExit("Trainer fit_a_line on the card failed its checks")
    return {"losses": losses}


def front_end_remainder_phase(torch, smi, fp32):
    """The Predictor's zero-copy and AOT paths over serving_phase's
    BERT-base model dir (`fp32`, its result), GradientMerge and
    ModelAverage on BERT-base training, and the Trainer; the K1 wrapper's
    host time a call (a call of its custom op) at the serving shape.  The
    three exports run in processes of their own (start_exports) while
    this one runs the training paths; every process is waited for or
    killed before the phase returns."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import quant_kernels as qk

    phase("front end remainder: zero-copy and AOT serving, GradientMerge, "
          "ModelAverage, Trainer")
    t0 = time.perf_counter()
    # the wrappers' host times first, on a quiet host
    out = {}
    g = torch.Generator(device="cuda").manual_seed(SEED + 91)
    q, k, v = (torch.randn(AOT_B, 12, TRAIN_T, 64, generator=g,
                           device="cuda") for _ in range(3))
    bias = torch.zeros(AOT_B, 1, 1, TRAIN_T, device="cuda")
    scale = 1.0 / 8.0
    out["k1_host_ms"] = host_ms(
        torch, lambda: ak.flash_attention_fwd(q, k, v, bias), reps=500)
    out["k1_op_host_ms"] = host_ms(
        torch, lambda: torch.ops.paddle_tpu_torch.flash_attention_fwd(
            q, k, v, bias, False, scale, 0.0, 0, None, False), reps=500)
    xq = torch.randint(-127, 128, (1024, 768), generator=g,
                       device="cuda", dtype=torch.int8)
    wk = qk.k_major(torch.randint(-127, 128, (768, 768), generator=g,
                                  device="cuda", dtype=torch.int8))
    cs_ = torch.rand(768, generator=g, device="cuda") * 1e-4 + 1e-6
    out["k6_host_ms"] = host_ms(torch, lambda: qk.int8_matmul(xq, wk,
                                                              cs_),
                                reps=500)
    out["k6_op_host_ms"] = host_ms(
        torch, lambda: torch.ops.paddle_tpu_torch.int8_matmul(xq, wk, cs_),
        reps=500)
    print(f"[{smi}] host ms a call (median of 500): K1 "
          f"flash_attention_fwd at [{AOT_B}, 12, {TRAIN_T}, 64] with a "
          f"row bias, the eager wrapper {out['k1_host_ms']:.6f}, the "
          f"custom op paddle_tpu_torch::flash_attention_fwd through the "
          f"dispatcher (an exported graph's node) "
          f"{out['k1_op_host_ms']:.6f}; K6 int8_matmul at M 1024, K = N "
          f"= 768, the eager wrapper {out['k6_host_ms']:.6f}, the custom "
          f"op paddle_tpu_torch::int8_matmul {out['k6_op_host_ms']:.6f}",
          flush=True)
    del q, k, v, bias, xq, wk, cs_
    exports = start_exports(fp32)
    try:
        out["zero_copy"] = zero_copy_path(torch, smi, fluid, fp32)
        for key, path in (("gm", gradient_merge_path),
                          ("ma", model_average_path),
                          ("trainer", trainer_path),
                          ("gm_sgd", gradient_merge_sgd_check)):
            t_path = time.perf_counter()
            out[key] = path(torch, smi, fluid)
            print(f"{key}: {time.perf_counter() - t_path:.3f} s "
                  f"(at {time.perf_counter() - t0:.1f} s of the phase)",
                  flush=True)
        t_path = time.perf_counter()
        out["aot"] = aot_path(torch, smi, fluid, fp32, exports)
        print(f"aot: {time.perf_counter() - t_path:.3f} s (at "
              f"{time.perf_counter() - t0:.1f} s of the phase)", flush=True)
    finally:
        for proc, d in exports.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            shutil.rmtree(d, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"[{smi}] front end remainder phase {out['seconds']:.3f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# the mixed host/device runner: device segments captured between host ops
# ---------------------------------------------------------------------------

SEG_STEPS = 5              # a path's runs an arm: warm, capture, replays
SEG_BODY_SIGNATURES = 3    # the most a loop body's segment may capture


def segment_arm(torch, label, arm, run, steps, counter):
    """`steps` runs of run() (the last under device_record) with
    `counter`'s launches counted from 0; returns {"outs", "walls",
    "wall", "busy", "launches"}."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter.launches = 0
    outs, walls = [], []
    for i in range(steps - 1):
        t0 = time.perf_counter()
        outs.append(run(i))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    box = []
    wall, busy, _ = device_record(torch, lambda: box.append(run(steps - 1)))
    outs.append(box[0])
    walls.append(wall)
    return {"outs": outs, "walls": walls, "wall": wall, "busy": busy,
            "launches": counter.launches,
            "peak": torch.cuda.max_memory_allocated()}


def segment_stats(exe):
    """The captured arm's executor's segment_stats() with its
    compile_count (read before close() frees the graphs)."""
    return dict(exe.segment_stats(), compile_count=exe.compile_count)


def first_gaps(a, b, k=4):
    """The first `k` entries of two {name: array} maps that differ, with
    their largest absolute gap."""
    out = []
    for n in a:
        x, y = np.asarray(a[n]), np.asarray(b.get(n))
        if x.shape != y.shape or x.tobytes() != y.tobytes():
            out.append((n, float(np.max(np.abs(x.astype(np.float64)
                                               - y.astype(np.float64))))
                        if x.shape == y.shape else "shape"))
            if len(out) == k:
                break
    return out


def segment_report(smi, label, arms, stats, want, same, extra=""):
    """Print a path's two arms and gate them: equal launches a step, the
    expected count, at least one graph captured, and `same` (captured =
    op by op bit for bit).  Returns the path's numbers."""
    cap, plain = arms["captured"], arms["op by op"]
    steps = len(cap["walls"])
    wall = statistics.median(cap["walls"][2:-1])
    row = {"wall": wall,
           "plain_wall": statistics.median(plain["walls"][1:-1]),
           "busy": cap["busy"], "plain_busy": plain["busy"],
           "idle": 1.0 - cap["busy"] / cap["wall"],
           "plain_idle": 1.0 - plain["busy"] / plain["wall"],
           "busy_share": cap["busy"] / wall,
           "launches": cap["launches"] / steps,
           "plain_launches": plain["launches"] / steps,
           "captured": stats["compile_count"],
           "segments": stats["segments"],
           "replays": stats["replays"], "uncaptured": stats["uncaptured"],
           "bitwise": same}
    print(f"[{smi}] segments {label}: step wall {row['wall']:.6f} ms "
          f"(median of replays; op by op {row['plain_wall']:.6f}), device "
          f"busy {row['busy']:.6f} ms of {cap['wall']:.6f} profiled, idle "
          f"share {row['idle']:.4f} (busy over the median wall "
          f"{row['busy_share']:.4f}; op by op busy {row['plain_busy']:.6f}"
          f" of {plain['wall']:.6f}, idle {row['plain_idle']:.4f}); "
          f"segments {row['segments']}, captured signatures "
          f"{row['captured']}, replays {row['replays']}; launches a step "
          f"{row['launches']:g} (op by op {row['plain_launches']:g}, "
          f"expected {want:g}); peak {cap['peak'] / 2**20:.3f} MiB (op by "
          f"op {plain['peak'] / 2**20:.3f}); captured = op by op bit for "
          f"bit: {same}{extra}", flush=True)
    for u in row["uncaptured"]:
        print(f"  uncaptured: {u['segment']}: {u['reason']}")
    if not same:
        print(f"  losses or outputs: captured {cap['outs']}, op by op "
              f"{plain['outs']}; first differing state "
              f"{first_gaps(cap.get('state', {}), plain.get('state', {}))}")
        raise SystemExit(f"segments {label}: the captured run departs from "
                         "the op-by-op run")
    if row["launches"] != want or row["plain_launches"] != want:
        raise SystemExit(f"segments {label}: launches a step "
                         f"{row['launches']} / {row['plain_launches']}, "
                         f"expected {want}")
    if row["captured"] < 1:
        raise SystemExit(f"segments {label}: no graph was captured")
    return row


def states_equal(torch, a, b):
    return a.keys() == b.keys() and all(
        np.asarray(a[n]).tobytes() == np.asarray(b[n]).tobytes() for n in a)


def ctr_segments(torch, smi):
    """The CTR trainer (host lookups and pushes between two device
    segments) at ctr_training_phase's configuration, captured and op by
    op from one state: the dense state, one pair of tables loaded into
    fresh shard servers for each arm."""
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.sparse as sparse
    from paddle_tpu_torch.models.ctr import (CTR_DIM, CTR_VOCAB, DEEP_TABLE,
                                             WIDE_TABLE, ctr_batch)

    main, startup, loss = ctr_program(fluid)
    rng = np.random.RandomState(SEED + 30)
    tables = {DEEP_TABLE: (rng.standard_normal((CTR_VOCAB, CTR_DIM))
                           * 0.01).astype(np.float32),
              WIDE_TABLE: np.zeros((CTR_VOCAB, 1), np.float32)}
    feeds = [ctr_batch(rng, CTR_B, CTR_VOCAB) for _ in range(SEG_STEPS)]
    state, arms, stats = None, {}, None
    for arm in ("captured", "op by op"):
        servers = ctr_cluster(fluid, sparse, fluid.CUDAPlace(0), tables)
        try:
            tp, ts = sparse.shard_program(main, startup)
            if state is None:
                init = fluid.Scope()
                fluid.Executor(fluid.CUDAPlace(0)).run(ts, scope=init)
                state = host_state(init)
            scope = fluid.io.state_from_numpy(
                state, scope=fluid.Scope(), place=fluid.CUDAPlace(0),
                main_program=tp)
            exe = fluid.Executor(fluid.CUDAPlace(0))
            cache = arm == "captured"
            arms[arm] = segment_arm(
                torch, "CTR", arm, lambda i: exe.run(
                    tp, feed=feeds[i], fetch_list=[loss], scope=scope,
                    use_program_cache=cache)[0], SEG_STEPS,
                sparse.gather_rows)
            if cache:
                stats = segment_stats(exe)
            exe.close()                         # every push applied
            arms[arm]["mirrors"] = mirrors_equal(torch, servers)
            arms[arm]["state"] = host_state(scope)
            arms[arm]["tables"] = {n: np.concatenate(
                [s.values[n] for s in servers]) for n in tables}
        finally:
            for s in servers:
                s.shutdown()
    cap, plain = arms["captured"], arms["op by op"]
    same = states_equal(torch, dict(enumerate(cap["outs"])),
                        dict(enumerate(plain["outs"]))) and \
        states_equal(torch, cap["state"], plain["state"]) and \
        states_equal(torch, cap["tables"], plain["tables"]) and \
        cap["mirrors"] and plain["mirrors"]
    return segment_report(
        smi, f"CTR (vocab {CTR_VOCAB} x {CTR_DIM} and x 1, batch {CTR_B}, "
        f"{CTR_SHARDS} shards)", arms, stats, 2 * CTR_SHARDS, same,
        f"; mirrors equal {cap['mirrors']}/{plain['mirrors']}; losses "
        f"{[float(x) for x in cap['outs']]}")


def seq2seq_segments(torch, smi):
    """The seq2seq model (dynamic_rnn) at seq2seq_training_phase's width,
    captured whole and op by op from one state."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.lod import bucket_len
    from paddle_tpu_torch.models.rnn import seq2seq_batch, seq_to_seq_net
    from paddle_tpu_torch.ops import rnn_kernels as rk

    main, startup, loss = rnn_program(
        fluid, seq_to_seq_net, fluid.optimizer.Adam(learning_rate=1e-3),
        **S2S_FULL)
    init = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=init)
    state = host_state(init)
    feed = seq2seq_batch(np.random.RandomState(SEED + 8), S2S_B,
                         S2S_FULL["dict_size"], *S2S_LENS)
    t_src = bucket_len(max(len(s) for s in feed["source_sequence"]))
    arms, exes = {}, {}
    for arm in ("captured", "op by op"):
        scope = fluid.io.state_from_numpy(state, scope=fluid.Scope(),
                                          place=fluid.CUDAPlace(0),
                                          main_program=main)
        exe = exes[arm] = fluid.Executor(fluid.CUDAPlace(0))
        cache = arm == "captured"
        arms[arm] = segment_arm(
            torch, "seq2seq", arm, lambda i: exe.run(
                main, feed=feed, fetch_list=[loss], scope=scope,
                use_program_cache=cache)[0], SEG_STEPS, rk.fused_lstm_cell)
        arms[arm]["state"] = host_state(scope)
    cap, plain = arms["captured"], arms["op by op"]
    same = states_equal(torch, dict(enumerate(cap["outs"])),
                        dict(enumerate(plain["outs"]))) and \
        states_equal(torch, cap["state"], plain["state"])
    torch.cuda.empty_cache()
    return segment_report(
        smi, f"seq2seq (dictionary {S2S_FULL['dict_size']}, width "
        f"{S2S_FULL['hidden']}, batch {S2S_B}, padded source T {t_src}; "
        f"captured whole: {fluid.core.executor.capturable(main)})", arms,
        segment_stats(exes["captured"]), 4 * t_src, same,
        f"; losses {[float(x) for x in cap['outs']]}")


def mt_decode_segments(torch, smi):
    """The book machine translation's While decode (startup weights),
    its segments captured and op by op; a body segment may capture at
    most SEG_BODY_SIGNATURES signatures."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as ex
    from paddle_tpu_torch.core.lod import bucket_len
    from paddle_tpu_torch.models import machine_translation as mt
    from paddle_tpu_torch.ops import rnn_kernels as rk

    cfg = mt.BOOK
    _, startup, _, dec, outs = mt_programs(fluid)
    init = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=init)
    state = host_state(init)
    srcs = mt.train_batch(np.random.default_rng(SEED + 31), MT_B,
                          cfg["dict_size"])["src_word_id"]
    dfeed = mt.decode_feed(srcs, cfg["beam_size"])
    arms, exes, counts = {}, {}, {}
    for arm in ("captured", "op by op"):
        scope = fluid.io.state_from_numpy(state, scope=fluid.Scope(),
                                          place=fluid.CUDAPlace(0),
                                          main_program=dec)
        exe = exes[arm] = fluid.Executor(fluid.CUDAPlace(0))
        cache = arm == "captured"
        ex.loop_counts.update(loops=0, iterations=0, condition_reads=0)
        arms[arm] = segment_arm(
            torch, "MT decode", arm, lambda i: exe.run(
                dec, feed=dfeed, fetch_list=list(outs), scope=scope,
                use_program_cache=cache), SEG_STEPS, rk.fused_lstm_cell)
        counts[arm] = dict(ex.loop_counts)
        arms[arm]["state"] = host_state(scope)
    cap, plain = arms["captured"], arms["op by op"]
    same = all(states_equal(torch, dict(enumerate(a)), dict(enumerate(b)))
               for a, b in zip(cap["outs"], plain["outs"])) and \
        states_equal(torch, cap["state"], plain["state"]) and \
        counts["captured"] == counts["op by op"]
    (seg,) = [c for c in exes["captured"]._cache.values()
              if isinstance(c, ex._SegmentedProgram)]
    body = {r.label: r.compile_count for r in seg.runners
            if r.block.idx != 0}
    row = segment_report(
        smi, f"machine translation While decode ({MT_B} sentences, beam "
        f"{cfg['beam_size']}, max length {cfg['max_length']})", arms,
        segment_stats(exes["captured"]),
        bucket_len(max(len(x) for x in srcs)), same,
        f"; loop counts {counts['captured']}; body signatures {body}")
    if max(body.values()) > SEG_BODY_SIGNATURES:
        raise SystemExit(f"segments MT decode: a body segment captured "
                         f"{body}, more than {SEG_BODY_SIGNATURES}")
    return row


def mesh_segments(torch, smi):
    """The dry run's dp x tp x sp x pp step at BERT-base attention width
    over the 32-entry cuda:0 mesh through CompiledProgram, captured and
    op by op (the executor's _captured refusing) from one state."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import dryrun
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.parallel import make_mesh

    label, d_model, heads, micro, _ = SP_CONFIGS[0]
    dp, sp = SP_MESH["data"], SP_MESH["seq"]
    n_dev = int(np.prod(list(SP_MESH.values())))
    mesh = make_mesh(SP_MESH, devices=[torch.device("cuda", 0)] * n_dev)
    main, loss, state, feed = dryrun_state(fluid, dryrun, d_model, heads,
                                           micro)
    counters = (ak.flash_attention_bwd_dkv, ak.flash_attention_bwd_dq)
    arms, exes = {}, {}
    for arm in ("captured", "op by op"):
        scope = fluid.io.state_from_numpy(state, scope=fluid.Scope(),
                                          place=fluid.CUDAPlace(0),
                                          main_program=main)
        exe = exes[arm] = fluid.Executor(fluid.CUDAPlace(0))
        if arm == "op by op":
            exe._captured = lambda program: False
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        prog._mesh = mesh
        for c in counters:
            c.launches = 0
        arms[arm] = segment_arm(
            torch, "mesh", arm, lambda i: exe.run(
                prog, feed=feed, fetch_list=[loss], scope=scope)[0],
            SEG_STEPS, ak.flash_attention_with_lse)
        arms[arm]["bwd"] = [c.launches // SEG_STEPS for c in counters]
        arms[arm]["state"] = host_state(scope)
    cap, plain = arms["captured"], arms["op by op"]
    pairs = dp * sp * (sp + 1) // 2
    same = states_equal(torch, dict(enumerate(cap["outs"])),
                        dict(enumerate(plain["outs"]))) and \
        states_equal(torch, cap["state"], plain["state"])
    row = segment_report(
        smi, f"dp x tp x sp x pp step ({label}) over {SP_MESH} on cuda:0",
        arms, segment_stats(exes["captured"]), 2 * pairs, same,
        f"; K2a/K2b a step {cap['bwd']} (op by op {plain['bwd']}, expected "
        f"{pairs}); op by op: {exes['op by op'].segment_stats()['uncaptured']}")
    if cap["bwd"] != [pairs] * 2 or plain["bwd"] != [pairs] * 2:
        raise SystemExit(f"segments mesh: K2a/K2b launches a step "
                         f"{cap['bwd']} / {plain['bwd']}, expected {pairs}")
    torch.cuda.empty_cache()
    return row


def embedding_grad_timing(torch, smi):
    """The dense lookup_table grad (ops/nn_ops.py: a scatter-add into a
    zeroed table, `index_add`) at BERT-base's tables, fp32: the word
    table (30522 x 768) over the ids of a training batch (32 x 128) and
    of the AMP batch (128 x 128), uniform, and the sentence table (2 x
    768) over the AMP batch's ids, 8192 a row.  Timed alone as the port
    runs it by default (atomics) and under torch's deterministic
    algorithms (rows sorted, each summed in order), with whether each
    gave the same bits twice."""
    rows = {}
    n_word, d = BERT_BASE["vocab_size"], BERT_BASE["hidden_size"]
    for label, n, count in (
            ("word table, fp32 batch 32", n_word, TRAIN_B * TRAIN_T),
            ("word table, AMP batch 128", n_word, AMP_BERT_B * TRAIN_T),
            ("sentence table, AMP batch 128", 2, AMP_BERT_B * TRAIN_T)):
        g = torch.Generator(device="cuda").manual_seed(SEED + 40)
        ids = torch.randint(0, n, (count,), device="cuda", generator=g)
        vals = torch.randn(count, d, device="cuda", generator=g)

        def grad():
            return torch.zeros(n, d, device="cuda").index_add(0, ids, vals)

        row = rows[label] = {}
        for mode in (False, True):
            torch.use_deterministic_algorithms(mode)
            try:
                key = "deterministic" if mode else "default"
                row[key + "_ms"] = time_ms(torch, grad)
                row[key + "_repeatable"] = torch.equal(grad(), grad())
                out = grad()
            finally:
                torch.use_deterministic_algorithms(False)
            row.setdefault("outs", []).append(out)
        gap = (row["outs"][0] - row["outs"][1]).abs().max().item()
        del row["outs"]
        row["max_abs_gap"] = gap
        print(f"[{smi}] dense lookup_table grad, {count} ids into [{n}, "
              f"{d}] fp32 ({label}): index_add {row['default_ms']:.6f} ms "
              f"by default (the same bits twice: "
              f"{row['default_repeatable']}), "
              f"{row['deterministic_ms']:.6f} ms under deterministic "
              f"algorithms (the same bits twice: "
              f"{row['deterministic_repeatable']}); zeroed table included;"
              f" largest gap between the two {gap:.3e}", flush=True)
        if not row["deterministic_repeatable"] or gap > 1e-3:
            raise SystemExit("dense lookup_table grad: the deterministic "
                             "arm is not repeatable or departs")
    return rows


def segments_phase(torch, smi):
    """The mixed host/device runner on the card: the CTR trainer, seq2seq,
    the machine translation's While decode and the dry run's mesh step,
    each captured (device segments, or the step whole) and op by op from
    one state, held bit for bit, with launches a step, device busy and
    idle share of both arms."""
    phase("segments: CTR, seq2seq, MT While decode, mesh step, captured "
          "vs op by op")
    t0 = time.perf_counter()
    peak0 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # bit for bit needs the scatter-adds (the dense embedding grads) to
    # sum duplicate rows in order: torch's deterministic algorithms, on
    # in both arms; an op with no deterministic arm warns.  New tensors
    # are left unfilled, as outside this mode
    import torch.utils.deterministic as det

    fill = det.fill_uninitialized_memory
    det.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            rows = {"ctr": ctr_segments(torch, smi),
                    "seq2seq": seq2seq_segments(torch, smi),
                    "mt": mt_decode_segments(torch, smi),
                    "mesh": mesh_segments(torch, smi)}
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill
    notes = sorted({str(w.message).split(".")[0] for w in seen
                    if "determinis" in str(w.message)})
    print(f"under deterministic algorithms; ops that warned: {notes}")
    rows["embedding_grad"] = embedding_grad_timing(torch, smi)
    rows["seconds"] = time.perf_counter() - t0
    rows["peak"] = torch.cuda.max_memory_allocated()
    print(f"segments phase {rows['seconds']:.3f} s, peak memory "
          f"{rows['peak'] / 2**30:.3f} GiB (before it {peak0 / 2**30:.3f})")
    return rows



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
    alone = sys.argv[1:]
    if alone not in ([], ["segments"], ["compiled"]):
        print("usage: python3 chip_smoke.py [segments | compiled]  (the "
              "build and segments_phase, or serving_phase and "
              "compiled_step_phase, alone)", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    t_start = T_START[0] = time.perf_counter()
    smi = device_phase(torch)
    build_phase()
    if alone:
        if alone == ["segments"]:
            segments_phase(torch, smi)
        else:
            compiled_step_phase(torch, smi, serving_phase(torch, smi))
        print(f"total {time.perf_counter() - t_start:.3f} s")
        return 0
    kernel_phase(torch)
    train_rows = train_kernel_phase(torch)
    head_dim_phase(torch)
    quant_rows = quant_kernel_phase(torch)
    fp32 = serving_phase(torch, smi)
    quant = quant_serving_phase(torch, smi, fp32)
    rnn_rows = rnn_kernel_phase(torch)
    training_parity_phase(torch)
    narrow_heads_phase(torch)
    launches = training_phase(torch, smi)
    seq2seq_parity_phase(torch)
    launches["lstm"] = seq2seq_training_phase(torch, smi)
    launches.update(rnn_programs_phase(torch, smi))
    gather_rows = ctr_kernel_phase(torch)
    ctr_parity_phase(torch)
    launches["gather"] = ctr_training_phase(torch, smi)
    dropout_rows = nmt_kernel_phase(torch)
    nmt_parity_phase(torch)
    launches["dropout"], trained = nmt_training_phase(torch, smi)
    decode = nmt_decode_phase(torch, smi, trained)
    paged_rows = paged_kernel_phase(torch)
    disagg = disagg_phase(torch, smi, trained)
    launches["paged"] = disagg["paged"]
    launches["paged_quant"] = disagg["paged_quant"]
    control = control_flow_phase(torch, smi, trained)
    del trained
    k3_rows = k3_kernel_phase(torch)
    ring_phase(torch)
    seqpar = sequence_parallel_phase(torch, smi)
    launches["k3"] = seqpar["launches"]["k3"]
    lenet = lenet_phase(torch, smi)
    r50 = resnet50_phase(torch, smi)
    amp_attn_rows, amp_drop_rows = amp_kernel_phase(torch)
    amp_parity_phase(torch)
    amp = amp_training_phase(torch, smi)
    amp_serve = amp_serving_phase(torch, smi, fp32)
    compiled = compiled_step_phase(torch, smi, fp32)
    seq = sequence_labelling_phase(torch, smi)
    front = front_end_phase(torch, smi, compiled)
    rest = front_end_remainder_phase(torch, smi, fp32)
    segs = segments_phase(torch, smi)

    phase("report")
    print(f"flash_attention_fwd launches: serving {fp32['launches']['fwd']},"
          f" int8 serving {quant['launches']['fwd']}, training "
          f"{launches['fwd']}")
    per_batch = quant["launches"]["quant"] / quant["batches"]
    print(f"quant_matmul launches: int8 serving {quant['launches']['quant']}"
          f" over {quant['batches']} batches ({per_batch:g} per batch)")
    print(f"lstm_step launches: seq2seq training {launches['lstm']} over "
          f"{S2S_STEPS} steps; gru_step: GRU programs {launches['gru']}; "
          f"masked_softmax: sequence-softmax programs "
          f"{launches['softmax']}")
    print(f"gather_rows launches: CTR training {launches['gather']} over "
          f"{CTR_STEPS} steps")
    nmt_steps = len(NMT_BUCKETS) * NMT_BATCHES_PER_BUCKET
    print(f"fused_dropout launches: NMT training {launches['dropout']} over "
          f"{nmt_steps} steps ({launches['dropout'] // nmt_steps} a step), "
          f"BERT training {launches['dropout_bert']} in one step; "
          f"flash_attention_fwd in NMT decode {decode['fwd']}")
    # the main paths' shapes: BERT-base training, fp32, dropout 0.1; and
    # the int8 serving batch's q/k/v/out projection (4 of 6 per layer)
    amp_bert = "amp_bert_b128_row_bf16_drop"
    kernels = [dict(KERNELS[k], launches=launches[k],
                    **train_rows[k]["bert_row_f32_drop"],
                    **bf16_keys(amp_attn_rows[k][amp_bert],
                                amp["bert"]["launches"][k] * AMP_STEPS),
                    device_key_ms=compiled["key_ms"][k],
                    clip_bert_launches=front["bert"]["launches"][k],
                    gradient_merge_launches=rest["gm"]["launches"][k],
                    model_average_launches=rest["ma"]["launches"][k])
               for k in ("fwd", "dkv", "dq")]
    # K1 as the custom op: its host time a wrapper call, its launches a
    # batch on the zero-copy path and from the exported program (eager and
    # served), and its nodes in the exported graphs
    aot = rest["aot"]
    kernels[0].update(
        host_ms=rest["k1_host_ms"], custom_op_host_ms=rest["k1_op_host_ms"],
        zero_copy_launches_per_batch=rest["zero_copy"]["launches"],
        aot_launches_per_batch=aot["fp32"]["launches"]["fwd"],
        aot_serving_launches_per_batch=aot["fp32"]["serving_launches"],
        aot_bf16_launches_per_batch=aot["bf16"]["launches"]["fwd"],
        aot_custom_op_nodes=aot["fp32"]["k1_nodes"])
    # K1 on the beam decode's path (Path B) at its decoder self-attention
    beam = control["rows"]["beam_dec_self"]
    kernels[0].update({"beam_decode_launches": control["beam"]["launches"],
                       **{f"beam_decode_{key}": beam[key] for key in (
                           "ms", "plain_ms", "library_ms", "bound_ms",
                           "bound_by", "max_abs_err")}})
    kernels.append(dict(KERNELS["quant"],
                        launches=quant["launches"]["quant"],
                        launches_per_batch=per_batch,
                        aot_launches_per_batch=aot["quant"]["launches"][
                            "quant"],
                        aot_custom_op_nodes=aot["quant"]["k6_nodes"],
                        custom_op_host_ms=rest["k6_op_host_ms"],
                        **quant_rows["qkv_out_m1024"]))
    # the RNN slice's shapes: the seq2seq encoder step, the GRU program's
    # step, the sequence-softmax program at T = 128
    for k, case in (("lstm", "seq2seq_b16_d512"), ("gru", "gru_b16_d512"),
                    ("softmax", "b16_t128")):
        kernels.append(dict(KERNELS[k], launches=launches[k],
                            **rnn_rows[k][case]))
    # K8 on the machine-translation path (Path A): its encoder's step
    # with peepholes, launched in the training and the While decode runs
    mt_row = rnn_rows["lstm"]["mt_b16_d32_peep"]
    kernels[-3].update({"mt_launches": control["mt"]["launches"],
                        **{f"mt_{key}": mt_row[key] for key in (
                            "ms", "plain_ms", "library_ms", "bound_ms",
                            "bound_by", "max_abs_err")}})
    # K8 on the semantic-role labeller's path: its step in the SRL's arm
    # (sigmoid gates, sigmoid cell, relu candidate, peepholes), launched in
    # the 3 training steps; the slice's CTC loss (no hand kernel: the
    # warpctc op's torch ops) beside
    srl_row = seq["arms"][SRL_ARMS[0][0]]
    kernels[-3].update({"srl_launches": seq["srl"]["launches"],
                        **{f"srl_{key}": srl_row[key] for key in (
                            "ms", "plain_ms", "library_ms", "bound_ms",
                            "bound_by", "max_abs_err")},
                        "ctc_wall_ms": seq["ctc"]["ms"],
                        "ctc_busy_ms": seq["ctc"]["busy"],
                        "ctc_loss_rel": seq["ctc"]["loss_rel"],
                        "ctc_grad_err": seq["ctc"]["grad_err"]})
    # the CTR slice's deep-table lookup on one shard
    kernels.append(dict(KERNELS["gather"], launches=launches["gather"],
                        **gather_rows["deep_n65536_d16_f32"]))
    # the NMT slice's FFN-hidden dropout (T 32 bucket), fp32, p 0.1
    nmt_steps_amp = len(NMT_BUCKETS) * NMT_BATCHES_PER_BUCKET
    kernels.append(dict(KERNELS["dropout"], launches=launches["dropout"],
                        **dropout_rows["nmt_b128_t32_d2048"],
                        **bf16_keys(amp_drop_rows["amp_nmt_b128_t32_d2048"],
                                    amp["nmt"]["launches"]["dropout"]
                                    * nmt_steps_amp),
                        device_key_ms=compiled["key_ms"]["dropout"],
                        clip_bert_launches=front["bert"]["launches"][
                            "dropout"],
                        gradient_merge_launches=rest["gm"]["launches"][
                            "dropout"],
                        model_average_launches=rest["ma"]["launches"][
                            "dropout"]))
    # the decode shape of bench_kernels.py: K4 with float32 arenas (the
    # disaggregated path's float32 pool; its bf16 arm beside it), K5 int8
    bf16 = paged_rows[f"{PAGED_BENCH[0]}_bfloat16"]
    kernels.append(dict(KERNELS["paged"], launches=launches["paged"],
                        **paged_rows[f"{PAGED_BENCH[0]}_float32"],
                        bf16_ms=bf16["ms"], bf16_plain_ms=bf16["plain_ms"],
                        bf16_bound_ms=bf16["bound_ms"],
                        bf16_library_ms=bf16["library_ms"],
                        bf16_max_abs_err=bf16["max_abs_err"]))
    distinct = paged_rows[f"{PAGED_DISTINCT[0]}_int8"]
    long_ctx = paged_rows[f"{PAGED_LONG[0]}_int8"]
    kernels.append(dict(KERNELS["paged_quant"],
                        launches=launches["paged_quant"],
                        **paged_rows[f"{PAGED_BENCH[0]}_int8"],
                        distinct_ms=distinct["ms"],
                        distinct_cold_ms=distinct["cold_ms"],
                        distinct_bound_ms=distinct["bound_ms"],
                        long_ms=long_ctx["ms"],
                        long_cold_ms=long_ctx["cold_ms"],
                        long_bound_ms=long_ctx["bound_ms"]))
    print(f"paged_attention launches: disaggregated decode "
          f"{launches['paged']} (float32 pool), paged_attention_quant "
          f"{launches['paged_quant']} (the decode pools' int8 arenas); "
          f"flash_attention_fwd there {disagg['fwd']}")
    # K3 at the ring's diagonal shard (causal), as the BERT-base-width
    # step runs it; its backward's numbers beside
    kernels.append(dict(KERNELS["k3"], launches=launches["k3"],
                        **k3_rows[f"shard_b{SP_SHARD[0]}_h{SP_SHARD[1]}_t"
                                  f"{SP_SHARD[2]}_d{SP_SHARD[3]}_causal"]))
    print(f"flash_attention_with_lse launches: dp x tp x sp x pp step "
          f"{launches['k3']} over {SP_TIMED_STEPS} steps (K2a/K2b "
          f"{seqpar['launches']['dkv']}/{seqpar['launches']['dq']}); step "
          f"{seqpar['step_ms']:.6f} ms, idle share {seqpar['idle']:.4f}")
    print(f"[{smi}] LeNet-5 batch {LENET_B}: {lenet['examples_s']:.3f} "
          f"examples/s, step {lenet['step_ms']:.6f} ms; ResNet-50 fp32 "
          f"batch {R50_B}: {r50['images_s']:.3f} images/s, step "
          f"{r50['step_ms']:.6f} ms, peak {r50['peak'] / 2**30:.3f} GiB, "
          f"busy {r50['busy']:.6f} of {r50['wall']:.6f} ms profiled")
    b, n, r = amp["bert"], amp["nmt"], amp["resnet50"]
    print(f"[{smi}] AMP (bf16): BERT-base batch {AMP_BERT_B} step "
          f"{b['step_ms']:.6f} ms, {b['tokens_s']:.3f} tokens/s, launches a "
          f"step {b['launches']}; ResNet-50 batch {R50_B} step "
          f"{r['step_ms']:.6f} ms, {r['images_s']:.3f} images/s, "
          f"{r['share']:.4f} of the bf16 peak (fp32 {r50['step_ms']:.6f} ms)"
          f"; NMT {n['tokens_s']:.3f} target tokens/s, steps "
          f"{n['step_ms']} ms, launches a step {n['launches']}; serving "
          f"p50 {amp_serve['p50']:.6f} ms p99 {amp_serve['p99']:.6f} ms "
          f"{amp_serve['req_s']:.3f} req/s")
    for key, label in (("bert", "BERT-base fp32"), ("bert_amp",
                                                     "BERT-base AMP"),
                       ("nmt", "NMT fp32"), ("nmt_amp", "NMT AMP"),
                       ("resnet50", "ResNet-50 fp32")):
        c = compiled[key]
        u = c["uncaptured"]
        print(f"[{smi}] compiled {label}: step {c['step_ms']:.6f} ms "
              f"(uncaptured {u['step_ms']:.6f}), busy {c['busy']:.6f} ms "
              f"of {c['wall']:.6f} profiled (uncaptured {u['busy']:.6f} of "
              f"{u['wall']:.6f}), peak {c['peak'] / 2**30:.3f} GiB "
              f"(uncaptured {u['peak'] / 2**30:.3f}), capture ms "
              f"{c['capture_ms']}")
    for key in ("serving", "serving_bf16"):
        c = compiled[key]
        print(f"[{smi}] compiled {key}: p50 {c['p50']:.6f} ms p99 "
              f"{c['p99']:.6f} ms {c['req_s']:.3f} req/s (uncaptured p50 "
              f"{c['plain_p50']:.6f} p99 {c['plain_p99']:.6f})")
    m, bd = control["mt"], control["beam"]
    print(f"[{smi}] control flow: machine-translation While decode wall "
          f"{m['wall']:.6f} ms, {m['iterations']} iterations, {m['syncs']} "
          f"host synchronisations in the loop, lstm_step launches "
          f"{m['launches']} (3 training steps and the decode); "
          f"transformer-base beam decode step {bd['step_ms']:.6f} ms, "
          f"{bd['tokens_s']:.3f} generated tokens/s, flash_attention_fwd "
          f"launches {bd['launches']} over {bd['runs']} runs")
    sr, rc = seq["srl"], seq["rec"]
    print(f"[{smi}] sequence labelling: semantic-role labeller step "
          f"{sr['step_ms']:.6f} ms (idle share {sr['idle']:.4f}, captured "
          f"{sr['captured']}), lstm_step launches {sr['launches']} over "
          f"{SRL_STEPS} steps; recommender step {rc['step_ms']:.6f} ms "
          f"(idle share {rc['idle']:.4f}); warpctc forward + backward "
          f"wall {seq['ctc']['ms']:.6f} ms (busy {seq['ctc']['busy']:.6f}); "
          f"phase peak "
          f"{seq['peak'] / 2**20:.3f} MiB")
    fb, fr, fn = front["bert"], front["resnet50"], front["norm"]
    print(f"[{smi}] front end: BERT-base under global-norm clip step "
          f"{fb['step_ms']:.6f} ms (unclipped "
          f"{compiled['bert']['step_ms']:.6f}), launches a step {fb['launches']}, global norm {fn['norm']:.6f}"
          f" (relative to vector_norm {fn['norm_rel']:.3e}); ResNet-50 "
          f"LARS step {fr['step_ms']:.6f} ms (Momentum "
          f"{compiled['resnet50']['step_ms']:.6f}); {len(front['sweep'])} "
          f"op types held card vs CPU; phase {front['seconds']:.3f} s")
    zc, gm, ma = rest["zero_copy"], rest["gm"], rest["ma"]
    print(f"[{smi}] front end remainder: zero-copy batch {ZC_B} "
          f"{zc['ms']:.6f} ms (run() {zc['run_ms']:.6f}); AOT fp32 served "
          f"p50 {aot['fp32']['p50']:.6f} ms (program mode "
          f"{aot['fp32']['program_p50']:.6f}), K1 {aot['fp32']['k1_nodes']} "
          f"nodes, K6 {aot['quant']['k6_nodes']} nodes quantized; "
          f"GradientMerge micro-step {gm['step_ms']:.6f} ms, peak "
          f"{gm['peak'] / 2**30:.3f} GiB, launches {gm['launches']}; "
          f"ModelAverage launches {ma['launches']}; phase "
          f"{rest['seconds']:.3f} s")
    for key, label in (("ctr", "CTR trainer"), ("seq2seq", "seq2seq"),
                       ("mt", "MT While decode"), ("mesh", "mesh step")):
        r = segs[key]
        print(f"[{smi}] segmented {label}: step {r['wall']:.6f} ms (op by "
              f"op {r['plain_wall']:.6f}), idle share {r['idle']:.4f} (op "
              f"by op {r['plain_idle']:.4f}), {r['captured']} signatures "
              f"captured over {r['segments']} segments")
    print(f"total {time.perf_counter() - t_start:.3f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
