"""What recording the program's spans (``repro_torch.spans``) costs the host,
for this checkout.

    python3 span_cost.py [--steps N] [--block B] [--smoke]

Spans are recorded exactly while a ``torch.profiler`` session is active, so
the cost falls only on profiled windows (the benchmark's ``--trace 1``
sub-window); this script times it three ways.

  * ``span()`` alone: one ``with span("engine.segment", layer): pass`` with
    recording off, and inside a profiler session (CUDA activity only, as the
    benchmark's traced sub-window; CPU activity with ``--smoke``), the best
    of 5 repeats.
  * ``engine.ffn``'s ``weight_bytes``: the index rows read from a pair table
    and ``kops.grouped_ffn_weight_bytes`` on them, as the grouped step does
    once per MoE layer while recording, on Mixtral-8x7B's batch-4 tables
    (top-2, 32 hi and 16 lo slots, random pairs).
  * The decode step: Mixtral-8x7B at its published width, depth cut to 4
    layers, every expert resident (as ``engine_step_time.py``: no step waits
    on the link), teacher-forced at batch 4.  N steps in each of three arms,
    in blocks of B steps taken in turn: ``plain`` (no profiler session),
    ``session`` (a session open, the spans held off by replacing
    ``spans.recording`` for the block) and ``spans`` (a session open, spans
    recorded).  Reports each arm's median step wall, the median and
    quartiles over cycles of the block-median differences (spans - session:
    what the spans cost a step; session - plain: what the profiler costs
    it), and the spans per recorded step.

``--smoke`` runs a CPU-sized model on the CPU, only to rehearse the script:
its times are the CPU's, not the card's.  Prints the card's name and power
limit, then one JSON line.
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
import timeit

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import smoke_variant  # noqa: E402
from repro_torch.core import EngineConfig, OffloadEngine  # noqa: E402
from repro_torch.core.engine import pack_pair_table, pair_table_words  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.api import HobbitBackend  # noqa: E402

LAYERS = 4
BATCH = 4
SEED = 0
PROMPT = 32
WARMUP = 8
CALLS = 200_000
TABLES = 64


def profiling(smoke: bool):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU if smoke else ProfilerActivity.CUDA])


def span_us(smoke: bool) -> dict:
    """Host us of one span with recording off and on."""
    f = spans.span
    stmt = 'with f("engine.segment", 3): pass'
    off = min(timeit.repeat(stmt, globals={"f": f}, number=CALLS, repeat=5)) / CALLS
    n_on = CALLS // 10          # the ring keeps the last 65,536 of them
    with profiling(smoke):
        on = min(timeit.repeat(stmt, globals={"f": f}, number=n_on, repeat=5)) / n_on
    spans.clear()
    return {"span_off_us": off * 1e6, "span_on_us": on * 1e6}


def weight_bytes_us() -> dict:
    """Host us of one ``engine.ffn`` span's ``weight_bytes`` at Mixtral's
    batch-4 tables."""
    k = get_config("mixtral-8x7b").moe.top_k
    nb = dict(hi_bytes=3, lo_wi_bytes=2, lo_wo_bytes=1)    # the time does not depend on them
    rng = np.random.default_rng(SEED)
    tables = []
    for _ in range(TABLES):
        table = np.zeros(pair_table_words(BATCH, k), np.int32)
        pairs = [(r, j, int(rng.integers(0, 32))) for r in range(BATCH) for j in range(k)]
        hi = [q for q in pairs if rng.random() < 0.6]
        lo = [(r, j, s % 16) for r, j, s in pairs if (r, j, s) not in hi]
        w = np.zeros((BATCH, k), np.float32)
        pack_pair_table(table, hi, lo, w, w)
        tables.append(table)
    p = BATCH * k

    def one(table):
        idx = table[:6 * p].reshape(6, p)
        return kops.grouped_ffn_weight_bytes(idx[2], idx[5], idx[3] < BATCH, **nb)

    n = 20_000
    best = min(timeit.repeat(lambda: [one(t) for t in tables], number=n // TABLES, repeat=5))
    return {"weight_bytes_us": best / n * 1e6}


def engine_steps(steps: int, block: int, smoke: bool) -> dict:
    """The three arms' step walls (see the module docstring)."""
    if smoke:
        cfg = smoke_variant(get_config("mixtral-8x7b"), layers=LAYERS, d_model=64, vocab=256)
        dev = torch.device("cpu")
    else:
        cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=LAYERS).validate()
        dev = torch.device("cuda", 0)
    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    n = cfg.num_layers * cfg.moe.num_experts
    eng = OffloadEngine(model, params, EngineConfig(hi_slots=n, lo_slots=n))
    be = HobbitBackend(eng)
    rng = np.random.default_rng(SEED)
    total = WARMUP + 3 * steps
    tokens = rng.integers(0, cfg.vocab_size, (total, BATCH))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    walls = {"plain": [], "session": [], "spans": []}
    cycles = []
    recorded = []
    live = spans.recording

    def run_block(arm: str, rows) -> float:
        ws = []
        for row in rows:
            t1 = time.perf_counter()
            be.step(row)
            ws.append(time.perf_counter() - t1)
        walls[arm].extend(ws)
        return statistics.median(ws)

    try:
        be.start_batch(BATCH, PROMPT + total + 4)
        be.prefill(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)))
        for t in range(WARMUP):
            be.step(tokens[t])
        t = WARMUP
        for c in range(steps // block):
            med = {}
            sync()
            med["plain"] = run_block("plain", tokens[t:t + block])
            t += block
            sync()
            with profiling(smoke):
                order = ("session", "spans") if c % 2 == 0 else ("spans", "session")
                for arm in order:
                    spans.clear()
                    if arm == "session":
                        spans.recording = lambda: False
                    try:
                        med[arm] = run_block(arm, tokens[t:t + block])
                    finally:
                        spans.recording = live
                    if arm == "spans":
                        recorded.append(len(spans.snapshot()) / block)
                    else:
                        assert not spans.snapshot(), "spans recorded while held off"
                    t += block
                sync()
            cycles.append(med)
    finally:
        spans.recording = live
        spans.clear()
        be.close()

    def quartiles(xs):
        q = statistics.quantiles(xs, n=4)
        return {"q1": q[0] * 1e3, "median": statistics.median(xs) * 1e3, "q3": q[2] * 1e3}

    return {
        "steps_per_arm": {k: len(v) for k, v in walls.items()},
        "median_step_ms": {k: statistics.median(v) * 1e3 for k, v in walls.items()},
        "spans_minus_session_ms": quartiles([m["spans"] - m["session"] for m in cycles]),
        "session_minus_plain_ms": quartiles([m["session"] - m["plain"] for m in cycles]),
        "spans_per_step": statistics.mean(recorded),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=900, help="steps per arm")
    ap.add_argument("--block", type=int, default=10, help="steps per block")
    ap.add_argument("--smoke", action="store_true", help="CPU-sized rehearsal on the CPU")
    args = ap.parse_args()
    if not args.smoke and not torch.cuda.is_available():
        print("FAIL: span_cost.py needs a CUDA card (or --smoke)", flush=True)
        return 2
    card = "cpu (smoke)"
    if not args.smoke:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"card": card, "batch": BATCH, "layers": LAYERS, "block": args.block}
    out.update(span_us(args.smoke))
    out.update(weight_bytes_us())
    out.update(engine_steps(args.steps, args.block, args.smoke))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
