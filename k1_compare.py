#!/usr/bin/env python3
"""K1 (the flash-attention forward) of several checkouts of this repo,
timed in turns on one NVIDIA GPU: the host time a wrapper call and the
device time, at BERT-base's serving shape (B 8, H 12, T 128, D 64, the
padding mask as a row bias) and its training shape (B 32, with the lse and
dropout 0.1, as the training step's forward asks for them).

Each checkout's K1 runs through its own wrapper,
paddle_tpu_torch.ops.attention_kernels.flash_attention_fwd, built from
that checkout's sources (a checkout where K1 is a torch.library custom op
pays the dispatcher on every call).  Every output is held against that
checkout's plain version within chip_smoke.py's float32 bar.  Each
checkout runs in a process of its own, in the order given and then in
reverse (A, B, B, A), and prints per case its device time
(chip_smoke.time_ms: median of 50 CUDA-event pairs) and its host time a
wrapper call (chip_smoke.host_ms: median of 500 calls, each timed
alone).

    python3 k1_compare.py DIR [DIR ...]
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# (name, batch, with lse, dropout)
CASES = (("serving_b8", 8, False, 0.0), ("training_b32_lse_drop", 32, True,
                                          0.1))
H, T, D = 12, 128, 64


def worker(root):
    """One checkout's times, as one JSON line on stdout."""
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "k1_cases", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from paddle_tpu_torch.ops import attention_kernels as ak

    if not ak.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"k1_compare: imported {ak.__file__}, not {root}")
    smi = cs.device_phase(torch)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 93)
    res = {}
    for name, b, lse, p in CASES:
        q, k, v = (torch.randn(b, H, T, D, generator=g, device="cuda")
                   for _ in range(3))
        bias = torch.zeros(b, 1, 1, T, device="cuda")
        bias[:, ..., T // 2:] = -10000.0
        scale = 1.0 / D ** 0.5
        args = (q, k, v, bias, False, scale, p, cs.SEED)
        got = ak.flash_attention_fwd(*args, with_lse=lse)
        want = ak.flash_attention_reference(*args, return_lse=lse)
        out, ref = (got[0], want[0]) if lse else (got, want)
        err = (out - ref).abs().max().item()
        if not err <= cs.ATOL["float32"]:
            raise SystemExit(f"k1_compare: {root} off its plain version by "
                             f"{err} on {name}")
        fn = lambda: ak.flash_attention_fwd(*args, with_lse=lse)  # noqa
        res[name] = {"ms": cs.time_ms(torch, fn),
                     "host_ms": cs.host_ms(torch, fn, reps=500),
                     "max_abs_err": err}
    print(json.dumps({"smi": smi, "cases": res}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+", help="checkouts whose K1 to time")
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
            raise SystemExit(f"k1_compare: {root} failed:\n{proc.stdout}"
                             f"{proc.stderr}")
        runs.append((root, json.loads(proc.stdout.strip().splitlines()[-1])))
    print(f"[{runs[0][1]['smi']}] device ms (host ms a wrapper call) "
          f"[max_abs_err against the plain version]; order "
          f"{', '.join(r for r, _ in runs)}")
    for name in runs[0][1]["cases"]:
        print(f"{name}: " + ", ".join(
            f"{root} {r['cases'][name]['ms']:.6f} "
            f"({r['cases'][name]['host_ms']:.6f}) "
            f"[{r['cases'][name]['max_abs_err']:.3e}]" for root, r in runs),
            flush=True)


if __name__ == "__main__":
    main()
