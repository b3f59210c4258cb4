"""Device and host time of the grouped lo-expert pair, or of the hi experts'
grouped GEMV, on the card, for one checkout.

    python3 grouped_dequant_time.py [--src DIR] [--calls N] [--op OP]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), so the
same script times two commits: unpack the other one (``git archive``) into a
git-ignored directory and run the script on each in turns (A, B, B, A).  At
Mixtral-8x7B's expert shapes as the offload engine launches them (4-bit
codes, group 64, bf16 x; seeded random codes and scales):

  * ``grouped_dequant_matmul`` over wi (K 4096, N 28672) and
    ``grouped_dequant_combine`` over wo (K 14336, N 4096), at P = 1, 2, 3,
    4, 5 and 8 (token rows B = 1, 1, 2, 2, 3, 4; every pair on its own pool
    slot, the combine's rows non-decreasing), and P = 2 with both pairs on
    one slot;
  * device ms per launch from CUDA-graph replays (20 launches back to back,
    the median of 20 replays), cold in L2: the launches cycle through
    copies of the pool, over twice the card's 50 MB L2 in all, as a decode
    step finds each layer's experts;
  * the same with a one-element PyTorch kernel between the grouped launches
    ("spaced"), as the engine sequences them (each grouped launch follows
    an index_select or an activation kernel, never another grouped launch),
    and that kernel's own time in a graph of it alone ("spacer"): a
    programmatic dependent launch cannot start its blocks under the tail of
    the launch before it when that launch is an ordinary kernel;
  * host wall per call from Python (the op's return, then an untimed
    synchronisation): median, 10th and 90th percentiles of N calls after 20
    untimed ones.

``--op`` times one of the two ops.  ``--op grouped_matmul`` times the hi
experts' grouped GEMV instead, at Mixtral-8x7B's hi shapes in bf16 (wi: K
4096, N 28672; wo: K 14336, N 4096; seeded random weights) for the pair
cases of ``chip_smoke.py``'s GMM_CASES (P = 1, 2, 4, 8 on as many slots,
two pairs on one slot, 8 pairs of which 6 pads repeat a slot), cold in L2
as above, device, spaced and host time as above, beside P ``torch.matmul``
products on the pairs' pool views in one graph (``matmul_ms``).  The
wrapper's signature is the same in every commit that has it, so this
times two commits' kernels.  Needs one CUDA card and ``nvcc``; prints the
card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

D, F = 4096, 14336                       # Mixtral-8x7B d_model, expert d_ff
BITS, GROUP = 4, 64                      # EngineConfig's lo_bits, group_size
L2_CYCLE_BYTES = 100 * 2**20             # twice the H100's 50 MB L2
# (name, token rows B, each pair's row, each pair's pool slot)
CASES = [("P=1", 1, [0], [0]), ("P=2", 1, [0, 0], [0, 1]),
         ("P=3", 2, [0, 0, 1], [0, 1, 2]), ("P=4", 2, [0, 0, 1, 1], [0, 1, 2, 3]),
         ("P=5", 3, [0, 0, 1, 1, 2], [0, 1, 2, 3, 4]),
         ("P=8", 4, [0, 0, 1, 1, 2, 2, 3, 3], list(range(8))),
         ("P=2 one slot", 1, [0, 0], [0, 0])]
# the hi GEMV's cases: (name, each pair's pool slot); pads repeat the last
# real pair's slot, as the engine pads
GMM_CASES = [("P=1", [0]), ("P=2", [0, 1]), ("P=4", [0, 1, 2, 3]), ("P=8", list(range(8))),
             ("2 pairs on 1 slot", [0, 0]), ("8 pairs, 6 pads", [0, 1, 1, 1, 1, 1, 1, 1])]


def graph_ms(fn, launches: int = 20, replays: int = 20, between=None) -> float:
    """Device ms per launch of `fn` from graph replays, `between` (when
    given) captured after each launch."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
            if between is not None:
                between()
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
    del graph
    return float(np.median(times))


def host_ms(fn, calls: int) -> dict:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = np.empty(calls)
    for i in range(calls):
        t0 = time.perf_counter()
        fn()
        t[i] = time.perf_counter() - t0
        torch.cuda.synchronize()
    t *= 1e3
    return {"median": float(np.median(t)), "p10": float(np.percentile(t, 10)),
            "p90": float(np.percentile(t, 90))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "src"))
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--op", choices=("grouped_dequant_matmul", "grouped_dequant_combine",
                                     "grouped_matmul"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grouped_dequant_time.py: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"src": os.path.abspath(args.src), "calls": args.calls}
    one = torch.zeros(1, device=dev)
    spacer = one.add_                       # a one-element PyTorch kernel
    out["spacer_ms"] = graph_ms(lambda: spacer(1.0))
    if args.op == "grouped_matmul":
        return time_grouped_matmul(ops, dev, g, out, spacer, args.calls)
    pack = 8 // BITS
    for op in ("grouped_dequant_matmul", "grouped_dequant_combine"):
        if args.op and op != args.op:
            continue
        k, n = (D, 2 * F) if op == "grouped_dequant_matmul" else (F, D)
        fn = getattr(ops, op)
        for name, b, rows, slots in CASES:
            p, s = len(rows), max(slots) + 1
            per = s * (k // pack * n + k // GROUP * n * 4)
            pools = [(torch.randint(-128, 128, (s, k // pack, n), generator=g, device=dev,
                                    dtype=torch.int8),
                      torch.rand((s, k // GROUP, n), generator=g, device=dev) * 0.02)
                     for _ in range(max(2, -(-L2_CYCLE_BYTES // per)))]
            x = torch.randn((p, k), generator=g, device=dev).to(torch.bfloat16)
            slot = torch.tensor(slots, dtype=torch.int32, device=dev)
            kw = dict(bits=BITS, group_size=GROUP)
            if op == "grouped_dequant_combine":
                rws = torch.tensor(rows, dtype=torch.int32, device=dev)
                w = torch.rand((p,), generator=g, device=dev)
                kw["num_rows"] = b
                calls = [lambda d=d, sc=sc: fn(x, d, sc, slot, rws, w, **kw) for d, sc in pools]
            else:
                calls = [lambda d=d, sc=sc: fn(x, d, sc, slot, **kw) for d, sc in pools]
            cycle = itertools.cycle(calls)
            ops.reset_dispatch_counts()
            out[f"{op} {name}"] = {
                "b": b, "p": p, "slots": len(set(slots)), "pool_copies": len(pools),
                "device_ms": graph_ms(lambda: next(cycle)()),
                "spaced_ms": graph_ms(lambda: next(cycle)(), between=lambda: spacer(1.0)),
                "host_ms": host_ms(calls[0], args.calls)}
            launched = getattr(ops, "grouped_launches", dict)()
            if launched:
                out[f"{op} {name}"]["kernels"] = launched
            counts = ops.dispatch_counts()
            if any(key.endswith(".torch") for key in counts):
                print(f"grouped_dequant_time.py: plain versions ran on the card: {counts}",
                      file=sys.stderr)
                return 1
            del pools, calls, cycle
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def time_grouped_matmul(ops, dev, g, out: dict, spacer, calls_n: int) -> int:
    """``--op grouped_matmul``: the hi GEMV at Mixtral's wi and wo shapes for
    every GMM_CASES entry; prints the JSON line."""
    for wname, (k, n) in (("wi", (D, 2 * F)), ("wo", (F, D))):
        for name, slots in GMM_CASES:
            p, s = len(slots), max(slots) + 1
            per = s * k * n * 2
            pools = [(torch.randn((s, k, n), generator=g, device=dev) * 0.02).to(torch.bfloat16)
                     for _ in range(max(2, -(-L2_CYCLE_BYTES // per)))]
            x = torch.randn((p, k), generator=g, device=dev).to(torch.bfloat16)
            slot = torch.tensor(slots, dtype=torch.int32, device=dev)
            calls = [lambda w=w: ops.grouped_matmul(x, w, slot) for w in pools]
            views = [lambda w=w: [torch.matmul(x[i:i + 1], w[slots[i]]) for i in range(p)]
                     for w in pools]
            cycle = itertools.cycle(calls)
            vcycle = itertools.cycle(views)
            ops.reset_dispatch_counts()
            out[f"grouped_matmul {wname} {name}"] = {
                "k": k, "n": n, "p": p, "slots": len(set(slots)), "pool_copies": len(pools),
                "device_ms": graph_ms(lambda: next(cycle)()),
                "spaced_ms": graph_ms(lambda: next(cycle)(), between=lambda: spacer(1.0)),
                "host_ms": host_ms(calls[0], calls_n),
                "matmul_ms": graph_ms(lambda: next(vcycle)())}
            counts = ops.dispatch_counts()
            if any(key.endswith(".torch") for key in counts):
                print(f"grouped_dequant_time.py: plain versions ran on the card: {counts}",
                      file=sys.stderr)
                return 1
            del pools, calls, views, cycle, vcycle, x
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
