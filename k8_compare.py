#!/usr/bin/env python3
"""K8's time step (``rnn_kernels.lstm_step``) of several checkouts of this
repo, in turns on one NVIDIA GPU, under the lstm op's default activations:
at the seq2seq encoder's B 16, D 512 without peepholes (the shape of
chip_smoke.py's "seq2seq_b16_d512" row) and with them, and at the
semantic-role labeller's B 10, D 128 with them.

Each checkout runs its own package (K8 built from its own
``csrc/rnn_cells.cu``) in a process of its own, in the order given and
then in reverse (A, B, B, A), on the same inputs made from a seed with
numpy.  Each prints the kernel's median time (chip_smoke.time_ms, CUDA
events) per case and writes its outputs under chiprun_out/k8_compare/;
the outputs of every checkout must then equal the first's bit for bit.

    python3 k8_compare.py DIR [DIR ...]
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out", "k8_compare")
# (name, B, D, peepholes); the step at index 3 of an 8-step input
CASES = (("b16_d512", 16, 512, False), ("b16_d512_peep", 16, 512, True),
         ("b10_d128_peep", 10, 128, True))
STEP_T, STEP = 8, 3


def inputs(torch, b, d, peep, seed):
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).cuda()

    x = arr(b, STEP_T, 4 * d, scale=0.5)
    lens = rng.randint(0, STEP_T + 1, b).astype(np.int32)
    lens[0], lens[-1] = 0, STEP_T
    return (x[:, STEP], torch.tanh(arr(b, d)), arr(b, d, scale=0.5),
            arr(d, 4 * d, scale=0.5 / d ** 0.5),
            torch.from_numpy(lens).cuda(), STEP,
            arr(3 * d, scale=0.25) if peep else None)


def worker(root, label):
    """One checkout's times, as one JSON line on stdout."""
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "k8_cases", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from paddle_tpu_torch.ops import rnn_kernels as rk

    if not rk.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"k8_compare: imported {rk.__file__}, not {root}")
    smi = cs.device_phase(torch)
    os.makedirs(OUT, exist_ok=True)
    res, outs = {}, {}
    for i, (name, b, d, peep) in enumerate(CASES):
        args = inputs(torch, b, d, peep, cs.SEED + i)
        for j, t in enumerate(rk.lstm_step(*args)):
            outs[f"{name}_{j}"] = t.cpu().numpy()
        res[name] = cs.time_ms(torch, lambda: rk.lstm_step(*args), reps=200)
    np.savez(os.path.join(OUT, f"{label}.npz"), **outs)
    print(json.dumps({"smi": smi, "ms": res}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+", help="checkouts to time")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.roots[0], args.worker)
    order = list(enumerate(args.roots))
    runs = []
    for i, root in order + order[::-1]:
        label = f"{i}_{len(runs)}"
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", label,
             root], capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"k8_compare: {root} failed:\n{proc.stdout}"
                             f"{proc.stderr}")
        runs.append((root, label,
                     json.loads(proc.stdout.strip().splitlines()[-1])))
    print(f"[{runs[0][2]['smi']}] lstm_step under the default activations: "
          f"median kernel time (ms) of 200 CUDA-event timings, each "
          f"checkout in turn")
    for name, b, d, peep in CASES:
        print(f"  {name} (B {b}, D {d}, peepholes {peep}): " + ", ".join(
            f"{root} {run['ms'][name]:.6f}" for root, _, run in runs))
    first = np.load(os.path.join(OUT, f"{runs[0][1]}.npz"))
    same = {root: all(np.array_equal(first[k], other[k]) for k in first)
            for root, other in ((root, np.load(os.path.join(
                OUT, f"{label}.npz"))) for root, label, _ in runs)}
    print(f"  outputs equal to {runs[0][0]}'s bit for bit: {same}")
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
