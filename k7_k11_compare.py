#!/usr/bin/env python3
"""The masked softmax K7 and the row gather K11 of several checkouts of
this repo, in turns on one NVIDIA GPU, with the lookups and the CTR
training step around K11.

Each checkout runs its own package (its kernels built from its sources)
in a process of its own, in the order given and then in reverse (A, B, B,
A), and prints:

- the launch floor: a one-element Tensor.zero_ through chip_smoke.py's
  time_ms (median of 50 CUDA-event pairs);
- K7 (``masked_softmax``) at [16, 128], [16, 1000], [16, 1025] and
  [8, 4096], lengths from 1 to T with a full row, through time_ms;
- K11 (``gather_rows`` into device memory) at the CTR step's deep and
  wide lookups on one shard (N 65,536 ids of a 500,000-row block, D 16
  and D 1, fp32), warm and cold (L2 flushed before each launch);
- walls, median of 50 (chip_smoke.py's wall_ms): ``lookup_local`` on one
  shard at both lookups; the same rows through the copy design (ids
  copied from a pinned buffer to the card, K11 into device memory, one
  asynchronous copy into a pinned output, one synchronisation); and,
  where the checkout has it, ``gather_rows_to_host``, K11 reading the ids
  from and writing the rows into pinned host memory;
- the CTR training step (chip_smoke.py's configuration: vocabulary
  1,000,000, 26 slots, 400-400-400, batch 4096, 2 shard servers, shard 1
  over RPC on 127.0.0.1): median wall of 10 steps after 2, the sparse
  engine's mean ``lookup_ms`` and ``push_ms`` over those steps, the
  time spent in ``lookup_local`` a step (both shards), and for one more
  step under torch.profiler the device's busy time and idle share.

    python3 k7_k11_compare.py DIR [DIR ...]
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
SOFTMAX_SHAPES = ((16, 128), (16, 1000), (16, 1025), (8, 4096))
CTR_WARM, CTR_TIMED = 2, 10


def copy_lookup(torch, ga, table, ids):
    """The copy design of a host lookup: the ids staged in a pinned
    buffer and copied to the card, K11 into device memory, one
    asynchronous copy of the rows into a pinned output, one
    synchronisation of the stream."""
    staged = torch.empty(ids.shape, dtype=torch.int64, pin_memory=True)
    staged.numpy()[:] = ids
    out = torch.empty((len(ids), table.shape[1]), dtype=table.dtype,
                      pin_memory=True)
    rows = ga.gather_rows(table, staged.to(table.device, non_blocking=True))
    out.copy_(rows, non_blocking=True)
    torch.cuda.current_stream(table.device).synchronize()
    return out.numpy()


def softmax_times(torch, cs):
    from paddle_tpu_torch.ops import sequence_kernels as sk

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
    res = {}
    for b, t in SOFTMAX_SHAPES:
        x = torch.randn(b, t, generator=g, device="cuda") * 2.0
        n = torch.randint(1, t + 1, (b,), generator=g, device="cuda",
                          dtype=torch.int32)
        n[0] = t
        err = (sk.masked_softmax(x, n) - sk.masked_softmax_reference(
            x, sk.length_mask(n, t))).abs().max().item()
        if not err <= cs.RNN_ATOL:
            raise SystemExit(f"masked_softmax [{b}, {t}]: {err}")
        res[f"[{b}, {t}]"] = cs.time_ms(torch, lambda: sk.masked_softmax(x, n))
    return res


def gather_times(torch, cs):
    from paddle_tpu_torch.models.ctr import CTR_VOCAB
    from paddle_tpu_torch.sparse import gather as ga

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 9)
    ids = cs.path_ids(np.random.RandomState(cs.SEED + 9), CTR_VOCAB, 0)
    dev_ids = torch.from_numpy(ids).cuda()
    height = CTR_VOCAB // cs.CTR_SHARDS
    flush = cs.l2_flush(torch)
    res = {}
    for label, d in (("deep", 16), ("wide", 1)):
        table = torch.randn(height, d, generator=g, device="cuda")
        want = table.index_select(0, dev_ids).cpu().numpy()

        def kernel():
            return ga.gather_rows(table, dev_ids)

        arms = {"copy": lambda: copy_lookup(torch, ga, table, ids)}
        if hasattr(ga, "gather_rows_to_host"):
            arms["to_host"] = lambda: ga.gather_rows_to_host(table, ids)
        for arm, fn in arms.items():
            if not np.array_equal(fn(), want):
                raise SystemExit(f"{arm} lookup departs from index_select")
        res[label] = {"warm_ms": cs.time_ms(torch, kernel),
                      "cold_ms": cs.time_ms(torch, kernel, before=flush),
                      **{f"{arm}_wall_ms": cs.wall_ms(torch, fn)
                         for arm, fn in arms.items()}}
    del flush
    walls = cs.lookup_walls(torch, ids)
    for label in res:
        res[label]["lookup_local_ms"] = walls[label]
    return res


def ctr_step(torch, cs, smi):
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.sparse as sparse
    from paddle_tpu_torch.models.ctr import CTR_VOCAB, ctr_batch
    from paddle_tpu_torch.sparse.shard_server import SparseShardServer

    spent = []
    lookup_local = SparseShardServer.lookup_local

    def timed_lookup(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return lookup_local(self, *args, **kwargs)
        finally:
            spent.append((time.perf_counter() - t0) * 1e3)

    main, startup, loss = cs.ctr_program(fluid)
    servers = cs.ctr_cluster(fluid, sparse, fluid.CUDAPlace(0))
    SparseShardServer.lookup_local = timed_lookup
    try:
        tp, ts = sparse.shard_program(main, startup)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        exe.run(ts, scope=scope)
        rng = np.random.RandomState(cs.SEED + 11)
        feeds = [ctr_batch(rng, cs.CTR_B, CTR_VOCAB)
                 for _ in range(CTR_WARM + CTR_TIMED + 1)]

        def step(f):
            return exe.run(tp, feed=f, fetch_list=[loss], scope=scope)

        for f in feeds[:CTR_WARM]:
            step(f)
        exe.close()                   # every push applied
        sparse.METRICS.reset()
        spent.clear()
        walls = []
        for f in feeds[CTR_WARM:-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(f)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        snap = sparse.METRICS.snapshot()
        local_ms = sum(spent) / CTR_TIMED
        prof = cs.profile_run(torch, lambda: step(feeds[-1]),
                              "one CTR training step", smi)
        exe.close()
    finally:
        SparseShardServer.lookup_local = lookup_local
        for s in servers:
            s.shutdown()
    return {"step_ms": statistics.median(walls),
            "lookup_ms_avg": snap["lookup_ms"]["avg"],
            "push_ms_avg": snap["push_ms"]["avg"],
            "lookup_local_ms_a_step": local_ms,
            "busy_ms": prof["busy"], "idle": 1.0 - prof["busy"] / prof["wall"]}


def worker(root):
    """One checkout's numbers, as one JSON line on stdout."""
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "k7_k11_cases", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    import paddle_tpu_torch as fluid

    if not fluid.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"k7_k11_compare: imported {fluid.__file__}, not "
                         f"{root}")
    smi = cs.device_phase(torch)
    res = {"floor_ms": cs.launch_floor_ms(torch),
           "softmax": softmax_times(torch, cs),
           "gather": gather_times(torch, cs),
           "ctr": ctr_step(torch, cs, smi)}
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
            raise SystemExit(f"k7_k11_compare: {root} failed:\n"
                             f"{proc.stdout}{proc.stderr}")
        runs.append((root, json.loads(proc.stdout.strip().splitlines()[-1])))
    print(f"[{runs[0][1]['smi']}] device ms: median of 50 CUDA-event pairs; "
          f"walls: median of 50 host walls (ms)")
    for root, run in runs:
        print(f"{root}: launch floor {run['floor_ms']:.6f} ms")
        print("  masked_softmax " + ", ".join(
            f"{shape} {ms:.6f}" for shape, ms in run["softmax"].items()))
        for label, g in run["gather"].items():
            print(f"  gather_rows {label}: " + ", ".join(
                f"{k} {v:.6f}" for k, v in g.items()))
        c = run["ctr"]
        print(f"  CTR step {c['step_ms']:.6f} ms, lookup_ms avg "
              f"{c['lookup_ms_avg']}, push_ms avg {c['push_ms_avg']}, "
              f"lookup_local {c['lookup_local_ms_a_step']:.6f} ms a step, "
              f"busy {c['busy_ms']:.6f} ms, idle {c['idle']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
