#!/usr/bin/env python3
"""The RNN slice's training steps of several checkouts of this repo, in
turns on one NVIDIA GPU: chip_smoke.py's seq2seq model at the width of
Paddle's machine-translation benchmark (dictionary 30000, width 512,
batch 16, Adam) and its GRU program (embedding -> fc -> dynamic_gru(512),
SGD), on chip_smoke.py's feeds.

Each checkout runs its own package (its kernels built from its sources)
in a process of its own, in the order given and then in reverse (A, B, B,
A), and prints per program the median wall time of 5 steps after 2
warm-up steps, then, for one more step under torch.profiler, the torch
operator calls it dispatched, the device's busy time and its idle share
of the profiled wall.

    python3 rnn_compare.py DIR [DIR ...]
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def measure(torch, cs, run, label, smi):
    for _ in range(2):
        run()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = cs.profile_run(torch, run, label, smi)
    return {"step_ms": statistics.median(walls),
            "torch_calls": prof["calls"], "busy_ms": prof["busy"],
            "idle": 1.0 - prof["busy"] / prof["wall"]}


def worker(root):
    """One checkout's numbers, as one JSON line on stdout."""
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "rnn_cases", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.rnn import (gru_net, seq2seq_batch,
                                             seq_to_seq_net)

    if not fluid.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"rnn_compare: imported {fluid.__file__}, not "
                         f"{root}")
    smi = cs.device_phase(torch)
    res = {}
    programs = (
        ("seq2seq", seq_to_seq_net, fluid.optimizer.Adam(learning_rate=1e-3),
         cs.S2S_FULL,
         seq2seq_batch(np.random.RandomState(cs.SEED + 8), cs.S2S_B,
                       cs.S2S_FULL["dict_size"], *cs.S2S_LENS)),
        ("gru", gru_net, fluid.optimizer.SGD(learning_rate=cs.GRU_LR),
         dict(dict_size=cs.S2S_FULL["dict_size"],
              hidden=cs.S2S_FULL["hidden"], origin_mode=False), None))
    for name, net, opt, sizes, feed in programs:
        if feed is None:       # rnn_programs_phase's batch of words
            rng = np.random.RandomState(cs.SEED + 5)
            feed = {"words": [rng.randint(0, sizes["dict_size"], (n,))
                              for n in rng.randint(10, 51, cs.S2S_B)]}
        main, startup, loss = cs.rnn_program(fluid, net, opt, **sizes)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        res[name] = measure(torch, cs, lambda: exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope),
            f"one {name} training step", smi)
    print(json.dumps({"smi": smi, "programs": res}))


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
            raise SystemExit(f"rnn_compare: {root} failed:\n{proc.stdout}"
                             f"{proc.stderr}")
        runs.append((root, json.loads(proc.stdout.strip().splitlines()[-1])))
    print(f"[{runs[0][1]['smi']}] a training step: median wall of 5 (ms), "
          f"then one profiled step: torch operator calls, device busy (ms), "
          f"idle share")
    for name in runs[0][1]["programs"]:
        for root, run in runs:
            p = run["programs"][name]
            print(f"  {name:8s} {root}: step {p['step_ms']:.6f} ms, "
                  f"{p['torch_calls']} torch calls, busy {p['busy_ms']:.6f} "
                  f"ms, idle {p['idle']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
