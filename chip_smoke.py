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
4. serving: build BERT-base (12 layers, hidden 768, 12 heads, seq 128,
   random weights from a seed) with the port's fluid API, save it as an
   inference model, serve 32 single-row requests through
   create_paddle_predictor -> ServingEngine on the card, check that the
   flash-attention kernel ran 12 times per executed batch, and hold the
   served probabilities against a CPU Predictor on the same model dir.
5. report: a "kernels" JSON line, then the result line
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
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# fp32: the kernel and the plain version sum exps in another order; bf16:
# the plain version rounds its output to bf16 from a different fp32 value
ATOL = {"float32": 2e-4, "bfloat16": 2e-2}
# served probabilities against the CPU Predictor: cuBLAS vs CPU matmul
# summation order through 12 fp32 layers
SERVE_ATOL = 1e-4
KERNELS = [{
    "name": "flash_attention_fwd",
    "route": "cuda",
    "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
    "replaces": "paddle_tpu/ops/pallas_kernels.py:74",
}]


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
    so each event pair brackets device time, not Python launch time."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
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
    engine = fluid.serving.ServingEngine(
        pred, fluid.serving.ServingConfig(max_batch_size=max_batch,
                                          max_wait_ms=5.0))
    try:
        engine.warmup()
        # one warm-up round through the engine (cuBLAS handles, allocator)
        for r in [engine.submit(f) for f in reqs[:max_batch]]:
            r.result(120)
        engine.reset_stats()
        ak.flash_attention.launches = 0
        done_ms = []
        t0 = time.perf_counter()
        futures = [engine.submit(f) for f in reqs]
        for f in futures:
            f.add_done_callback(lambda r: done_ms.append(
                (time.perf_counter() - r.enq_t) * 1e3))
        served = [f.result(120)[0] for f in futures]
        wall_s = time.perf_counter() - t0
        launches = ak.flash_attention.launches
        stats = engine.stats()
    finally:
        engine.stop()
    c = stats["counters"]
    batches = c["batches_executed"]
    print(f"answered {c['completed']}/{n_req} in {batches} batches, "
          f"flash_attention_fwd launches {launches}")
    if c["completed"] != n_req or len(served) != n_req:
        raise SystemExit(f"only {c['completed']} of {n_req} requests "
                         "were answered")
    if launches != cfg.num_layers * batches or launches == 0:
        raise SystemExit(f"flash_attention_fwd ran {launches} times for "
                         f"{batches} batches, expected "
                         f"{cfg.num_layers * batches}")
    served = np.concatenate(served)
    if served.shape != (n_req, 2) or not np.isfinite(served).all():
        raise SystemExit(f"served output has shape {served.shape} or is "
                         "not finite")

    cpu_cfg = fluid.AnalysisConfig(model_dir)
    cpu_cfg.disable_gpu()
    cpu_pred = fluid.create_paddle_predictor(cpu_cfg)
    cpu = np.concatenate([
        cpu_pred.run({n: np.concatenate([r[n] for r in reqs[i:i + 8]])
                      for n in feeds})[0]
        for i in range(0, n_req, 8)])
    err = float(np.abs(served - cpu).max())
    print(f"served vs CPU Predictor: max_abs_err {err:.3e} "
          f"(atol {SERVE_ATOL:g})")
    if err > SERVE_ATOL:
        raise SystemExit(f"card and CPU predictors disagree: {err}")
    lat = stats["latency_ms"]
    print(f"serving [{smi}]: latency p50 {lat['p50']} ms p99 {lat['p99']}"
          f" ms (engine histogram, bucket edges), client-side p50 "
          f"{np.percentile(done_ms, 50):.6f} ms p99 "
          f"{np.percentile(done_ms, 99):.6f} ms, {n_req / wall_s:.3f} req/s"
          f" over {wall_s:.6f} s, compute_ms avg "
          f"{stats['compute_ms']['avg']} per batch, batch occupancy "
          f"{stats['batch_occupancy']}")
    batch = {n: np.concatenate([r[n] for r in reqs[:max_batch]])
             for n in feeds}
    profile_batch(torch, pred, batch, smi)
    return launches


def profile_batch(torch, pred, feed, smi):
    """Where one batch's time goes: host wall time of Predictor.run
    (median of 5, unprofiled), then one run under torch.profiler for the
    device's busy time, its idle share and the kernels that fill it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    phase("profile one batch (Predictor.run)")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred.run(feed)
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.run(feed)
        prof_wall = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's row repeats its kernels' time
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[{smi}] batch of {len(next(iter(feed.values())))}: wall "
          f"{statistics.median(walls):.6f} ms unprofiled (median of 5), "
          f"{prof_wall:.6f} ms profiled; device busy {busy:.6f} ms, idle "
          f"share {1.0 - busy / prof_wall:.4f} of the profiled wall")
    for name, ms, count in rows[:10]:
        print(f"  {ms:10.6f} ms  x{count:<4d} {name[:90]}")


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
    rows = kernel_phase(torch)
    launches = serving_phase(torch, smi)

    phase("report")
    main_row = rows["bert_row_f32"]
    kernels = [dict(KERNELS[0], launches=launches,
                    max_abs_err=main_row["max_abs_err"],
                    ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                    bound_ms=main_row["bound_ms"],
                    bound_by=main_row["bound_by"],
                    library_ms=main_row["library_ms"])]
    print(f"total {time.perf_counter() - t_start:.3f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
