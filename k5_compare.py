#!/usr/bin/env python3
"""The paged decode attention kernels K5 (int8 arenas) and K4 (float32
and bf16 arenas) of several checkouts of this repo, in turns on one NVIDIA
GPU.

Each checkout runs its own package (its kernels built from its sources)
in a process of its own, in the order given and then in reverse (A, B, B,
A), and prints:

- the launch floor: a one-element Tensor.zero_ through chip_smoke.py's
  time_ms (median of 50 CUDA-event pairs);
- K5 (``paged_attention_quant``) warm and cold (L2 flushed before each
  launch, chip_smoke.py's l2_flush) at chip_smoke.py's cases: the decode
  shape of bench_kernels.py (S 64, H 8, D 128, blocks of 16, 16 a slot,
  lengths 192-256) over its 513-block arena (L2-resident) and over
  distinct blocks (N 1025, a permutation table), a long context (S 8, MB
  256, lengths 3072-4096, distinct blocks: a 67 MB arena), and the
  disaggregated path's own call (S 1, H 8, D 64, 48 tokens); each output
  held against the plain version within chip_smoke.py's PAGED_ATOL;
- K4 (``paged_attention``) with float32 and bf16 arenas at the decode
  shape, warm, likewise checked.

    python3 k5_compare.py DIR [DIR ...]
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def worker(root):
    """One checkout's numbers, as one JSON line on stdout."""
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "k5_cases", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import paged_kernels as pk
    from paddle_tpu_torch.ops import quant_kernels as qk

    if not fluid.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"k5_compare: imported {fluid.__file__}, not "
                         f"{root}")
    smi = cs.device_phase(torch)
    flush = cs.l2_flush(torch)
    rng = np.random.RandomState(cs.SEED + 17)
    res = {"floor_ms": cs.launch_floor_ms(torch)}
    cases = [(cs.PAGED_BENCH, "int8"), (cs.PAGED_DISTINCT, "int8"),
             (cs.PAGED_LONG, "int8"), (cs.PAGED_DISAGG, "int8"),
             (cs.PAGED_BENCH, "float32"), (cs.PAGED_BENCH, "bfloat16")]
    for case, kind in cases:
        args = cs.paged_operands(torch, case, kind, rng)
        q, k, v, ks, vs, table, lens = args
        scale = 1.0 / q.shape[-1] ** 0.5
        if kind == "int8":
            fn = lambda: qk.paged_attention_quant(*args)
            want = qk.paged_attention_quant_reference(*args, scale)
        else:
            fn = lambda: pk.paged_attention(q, k, v, table, lens)
            want = pk.paged_attention_reference(q, k, v, table, lens, scale)
        err = (fn().float() - want.float()).abs().max().item()
        if not err <= cs.PAGED_ATOL[kind]:
            raise SystemExit(f"k5_compare: {case[0]} {kind}: {err}")
        row = {"warm_ms": cs.time_ms(torch, fn), "max_abs_err": err,
               **cs.paged_bound(q, k, lens, kind == "int8")}
        if kind == "int8":
            row["cold_ms"] = cs.time_ms(torch, fn, before=flush)
        res[f"{case[0]} {kind}"] = row
        del args, q, k, v, ks, vs, table, lens, want
        torch.cuda.empty_cache()
    print(json.dumps({"smi": smi, **res}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+", help="checkouts to time")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.roots[0])
    runs = []
    for root in args.roots + args.roots[::-1]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"k5_compare: {root} failed:\n"
                             f"{proc.stdout}{proc.stderr}")
        runs.append((root, json.loads(proc.stdout.strip().splitlines()[-1])))
    print(f"[{runs[0][1]['smi']}] device ms: median of 50 CUDA-event pairs "
          f"(cold: L2 flushed before each launch)")
    for root, run in runs:
        print(f"{root}: launch floor {run['floor_ms']:.6f} ms")
        for label, r in run.items():
            if label in ("smi", "floor_ms"):
                continue
            cold = f" cold {r['cold_ms']:.6f}" if "cold_ms" in r else ""
            print(f"  {label}: warm {r['warm_ms']:.6f}{cold} bound "
                  f"{r['bound_ms']:.6f} ({r['bound_by']}) max_abs_err "
                  f"{r['max_abs_err']:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
