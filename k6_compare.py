#!/usr/bin/env python3
"""K6 (the int8 GEMM of the quantized serving path) of several checkouts of
this repo, timed in turns on one NVIDIA GPU at chip_smoke.py's QUANT_CASES,
on the operands chip_smoke.py draws.

Each checkout's K6 runs through its own wrapper,
paddle_tpu_torch.ops.quant_kernels.int8_matmul(xq, wq, colscale), built
from that checkout's sources, with the weight in the layout that checkout
serves: its quant_kernels.k_major where it has one, else [K, N] row-major.
Every output is held bit for bit against that checkout's plain version.
Each checkout runs in a process of its own, in the order given and then
in reverse (A, B, B, A), and prints per case its device time
(chip_smoke.time_ms: median of 50 CUDA-event pairs) and its host time a
wrapper call (chip_smoke.host_ms: median of 500 calls, each timed
alone).

    python3 k6_compare.py DIR [DIR ...]
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def worker(root):
    """One checkout's times, as one JSON line on stdout."""
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "k6_cases", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from paddle_tpu_torch.ops import quant_kernels as qk

    if not qk.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"k6_compare: imported {qk.__file__}, not {root}")
    layout = getattr(qk, "k_major", lambda w: w)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 2)
    res = {}
    for name, m, k, n in cs.QUANT_CASES:
        # chip_smoke.quant_kernel_phase's draws, in its order
        xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                           dtype=torch.int8)
        w = layout(wq)
        colscale = torch.rand(n, generator=g, device="cuda") * 1e-4 + 1e-6
        if not torch.equal(qk.int8_matmul(xq, w, colscale),
                           qk.int8_matmul_reference(xq, wq, colscale)):
            raise SystemExit(f"k6_compare: {root} disagrees with its plain "
                             f"version on {name}")
        fn = lambda: qk.int8_matmul(xq, w, colscale)  # noqa: E731
        res[name] = {"ms": cs.time_ms(torch, fn),
                     "host_ms": cs.host_ms(torch, fn, reps=500)}
    print(json.dumps({"smi": cs.device_phase(torch), "cases": res}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+", help="checkouts whose K6 to time")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.roots[0])
    runs = []
    for root in args.roots + args.roots[::-1]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"k6_compare: {root} failed:\n{proc.stdout}"
                             f"{proc.stderr}")
        runs.append((root, json.loads(proc.stdout.strip().splitlines()[-1])))
    print(f"[{runs[0][1]['smi']}] device ms (host ms a wrapper call), "
          f"bit for bit each checkout's plain version; order "
          f"{', '.join(r for r, _ in runs)}")
    for name in runs[0][1]["cases"]:
        print(f"{name}: " + ", ".join(
            f"{root} {r['cases'][name]['ms']:.6f} "
            f"({r['cases'][name]['host_ms']:.6f})" for root, r in runs),
            flush=True)


if __name__ == "__main__":
    main()
