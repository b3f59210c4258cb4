"""Host and device time of the two router ops on the card, for one checkout.

    python3 router_host_time.py [--src DIR] [--calls N]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), so the
same script times two commits: unpack the other one (``git archive``) into a
git-ignored directory and run the script on each in turns (A, B, B, A).  At
Mixtral-8x7B's router (D 4096, E 8, seeded float32 gates):

  * ``gating_topk`` over bf16 x at B = 1 and 4 (K 2), as the offload
    engine calls it, and ``stacked_gating`` over float32 x at B = 1, P = 2,
    as the predictor calls it;
  * host wall per call as the engine's ``gating_s`` reads it: the call,
    then its outputs copied to the host (``to_host``); the median and the
    10th and 90th percentiles of N calls after 100 untimed ones;
  * device ms per launch from CUDA-graph replays (20 launches back to back,
    the median of 20 replays), as ``chip_smoke.graph_ms`` takes them.

Needs one CUDA card and ``nvcc``; prints the card's name and power limit,
then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

D, E, K = 4096, 8, 2


def graph_ms(fn, launches: int = 20, replays: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def host_ms(fn, calls: int) -> dict:
    for _ in range(100):
        fn()
    t = np.empty(calls)
    for i in range(calls):
        t0 = time.perf_counter()
        fn()
        t[i] = time.perf_counter() - t0
    t *= 1e3
    return {"median": float(np.median(t)), "p10": float(np.percentile(t, 10)),
            "p90": float(np.percentile(t, 90))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "src"))
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("router_host_time.py: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.device import to_host
    from repro_torch.kernels import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    gates = torch.randn((2, D, E), generator=g, device=dev) / math.sqrt(D)
    out = {"src": os.path.abspath(args.src), "calls": args.calls}
    for b in (1, 4):
        x = torch.randn((b, D), generator=g, device=dev).to(torch.bfloat16)
        router = gates[:1]

        def engine_call():
            _, vals, idx = ops.gating_topk(x, router, top_k=K)
            return to_host(vals[0], idx[0])

        out[f"gating_topk B={b}"] = {
            "host_ms": host_ms(engine_call, args.calls),
            "device_ms": graph_ms(lambda: ops.gating_topk(x, router, top_k=K))}
    x1 = torch.randn((1, D), generator=g, device=dev)

    def predictor_call():
        return ops.stacked_gating(x1, gates).cpu()

    out["stacked_gating P=2"] = {"host_ms": host_ms(predictor_call, args.calls),
                                 "device_ms": graph_ms(lambda: ops.stacked_gating(x1, gates))}
    counts = ops.dispatch_counts()
    if any(k.endswith(".torch") for k in counts):
        print(f"router_host_time.py: plain versions ran on the card: {counts}",
              file=sys.stderr)
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
