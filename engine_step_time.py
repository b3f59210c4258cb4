"""Decode step wall of the offload engine on the card with every expert
resident, for one checkout.

    python3 engine_step_time.py [--src DIR] [--steps N] [--batch B]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), so the
same script times two commits: unpack the other one (``git archive``) into a
git-ignored directory and run the script on each in turns (A, B, B, A).

Mixtral-8x7B at its published width, depth cut to 4 layers, seeded random
bf16 weights, as ``chip_smoke.py``'s serve.  The engine's pools hold every
expert of every layer in both precisions (hi_slots = lo_slots = layers x
experts), so after the warm-up steps no decode step waits on the link and
the step wall is the host's work and the card's: what capturing the grouped
FFN changes.  Otherwise ``EngineConfig``'s defaults (thresholds 0.6 / 0.9:
hi, lo and skipped pairs in every layer; prefetch and asynchronous staging
on).  Teacher-forced steps at batch B after 32-token prompts.

Reports, beside the card's name and power limit, one JSON line:

  * median, 10th and 90th percentile host wall of ``HobbitBackend.step``
    (logits on the host: the step is done) over N steps after 8 warm-up
    steps, and the decode tok/s they give; the expert loads and load stall
    of the timed steps (expected 0);
  * per MoE layer step, the launches of each grouped op and the captured
    steps' routes (``ops.dispatch_counts()``);
  * a ``torch.profiler`` window of 3 steps: kernels per step, device busy
    share, and the host's launch calls per step by name (kernel launches,
    graph launches, async copies) — what the host issues for the card;
    and the device time per step of the 10 kernels that take the most,
    by name, with their launches per step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

LAYERS = 4
SEED = 0
PROMPT = 32
WARMUP = 8
WINDOW = 3
# host runtime calls that hand the card work
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync")
TOP_KERNELS = 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "src"))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: engine_step_time.py needs a CUDA card", flush=True)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.core import EngineConfig, OffloadEngine
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving.api import HobbitBackend

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=LAYERS).validate()
    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    n = cfg.num_layers * cfg.moe.num_experts
    t0 = time.perf_counter()
    eng = OffloadEngine(model, params, EngineConfig(hi_slots=n, lo_slots=n))
    up_s = time.perf_counter() - t0
    be = HobbitBackend(eng)
    b, steps = args.batch, args.steps
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (WARMUP + steps + WINDOW, b))
    try:
        be.start_batch(b, PROMPT + WARMUP + steps + WINDOW + 4)
        be.prefill(rng.integers(0, cfg.vocab_size, (b, PROMPT)))
        for t in range(WARMUP):
            be.step(tokens[t])
        torch.cuda.synchronize()
        st0 = eng.stats()
        ops.reset_dispatch_counts()
        walls = []
        for t in range(WARMUP, WARMUP + steps):
            t1 = time.perf_counter()
            be.step(tokens[t])
            walls.append(time.perf_counter() - t1)
        counts = ops.dispatch_counts()
        st1 = eng.stats()
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for t in range(WARMUP + steps, WARMUP + steps + WINDOW):
                be.step(tokens[t])
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t1
    finally:
        be.close()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    calls = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.key in LAUNCH_CALLS:
            calls[e.key] = calls.get(e.key, 0) + e.count / WINDOW
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP_KERNELS]
    layer_steps = steps * eng.num_moe_layers
    per_layer = {k: v / layer_steps for k, v in sorted(counts.items())
                 if not k.startswith(("engine_embed.", "engine_logits.", "serve_step."))
                 and not k.startswith("engine_layer")}
    ms = sorted(w * 1e3 for w in walls)
    out = {
        "card": card, "src": os.path.abspath(args.src), "batch": b, "steps": steps,
        "layers": LAYERS, "engine_up_s": up_s,
        "median_step_ms": statistics.median(ms), "p10_step_ms": ms[len(ms) // 10],
        "p90_step_ms": ms[(9 * len(ms)) // 10], "decode_tok_s": b * steps / sum(walls),
        "timed_loads": (st1["loads_hi"] - st0["loads_hi"]) + (st1["loads_lo"] - st0["loads_lo"]),
        "timed_load_stall_s": st1["load_stall_s"] - st0["load_stall_s"],
        "launches_per_layer_step": per_layer,
        "window_step_ms": window_s / WINDOW * 1e3,
        "window_kernels_per_step": (sum(e.count for e in kernels) / WINDOW
                                    if busy_us > 0 else "not measured"),
        "window_device_busy_share": (busy_us / 1e6 / window_s if busy_us > 0
                                     else "not measured"),
        "window_host_launch_calls_per_step": calls,
        "window_kernel_ms_per_step": (busy_us / 1e3 / WINDOW if busy_us > 0
                                      else "not measured"),
        "window_top_kernels": [{"name": e.key[:160],
                                "ms_per_step": e.self_device_time_total / 1e3 / WINDOW,
                                "launches_per_step": e.count / WINDOW} for e in top],
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
