"""Time to first token of the dense-KV backends and the offload engine's
per-expert decode on the card, for one checkout.

    python3 prefill_time.py [--src DIR] [--part serve|expert|all]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), so the
same script times two commits: unpack the other one (``git archive``) into a
git-ignored directory and run the script on each in turns (A, B, B, A).
Seeded random bf16 weights at published widths, as ``chip_smoke.py``.

``serve``: Granite-3.0-2B as published (40 layers) through
``DenseBackend`` on dense KV (the default ``jit=True``) under
``BatchingServer(max_batch=4)``: 24 greedy requests of 8 new tokens, prompt
lengths drawn uniformly from [16, 64) (as ``serving/workload.py``), so most
prompt shapes come once.  The same 24 requests run twice on one backend:
in the second pass every shape has come before.  Per pass: the wall, the
mean, median and 99th percentile of each request's prefill latency (its
join: the time to first token once admitted) and of its admission wait,
decode tok/s, the prefill step's counters, and the device memory that the
prefill's graphs hold (the reserved and allocated bytes of their pool's
segments in the allocator's snapshot; null for a checkout without such a
pool).  Then ``api.score_nll`` over 8 sequences of 32 tokens (each enters
through a one-token join): the wall of each sequence.

``expert``: Mixtral-8x7B at published width cut to 4 layers through the
offload engine's per-expert path (``grouped=False``, synchronous loads,
the default constrained cache) on dense KV and on paged KV: 3 sequences,
each a ``start_batch``, a 2 x 32 prefill and 16 teacher-forced decode
steps, with the decode tok/s of each sequence, the median step wall and
the expert loads of the last; then ``api.score_nll`` over 4 sequences of
16 tokens: the wall of each.  The first sequence pays what is captured
once; the later ones show the steady state.

Prints the card's name and power limit, then one JSON line.
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

SEED = 0
SERVE_REQUESTS, SERVE_NEW, SERVE_BATCH = 24, 8, 4
NLL_SEQS, NLL_LEN = 8, 32
EXPERT_LAYERS, EXPERT_SEQS, EXPERT_STEPS = 4, 3, 16
EXPERT_NLL_SEQS, EXPERT_NLL_LEN = 4, 16


def _pool_bytes(backend):
    """(reserved, allocated) bytes of the prefill graphs' memory pool, or
    None when the backend has no such pool or the snapshot names none."""
    prefill = getattr(backend, "_prefill", None)
    step = getattr(prefill, "step", None)
    pool = getattr(step, "pool", None)
    if pool is None:
        return None
    if pool.handle is None:
        return {"reserved_bytes": 0, "allocated_bytes": 0, "graphs": 0}
    segs = torch.cuda.memory._snapshot()["segments"]
    if segs and "segment_pool_id" not in segs[0]:
        return None
    mine = [g for g in segs if tuple(g["segment_pool_id"]) == tuple(pool.handle)]
    return {"reserved_bytes": sum(g["total_size"] for g in mine),
            "allocated_bytes": sum(g["allocated_size"] for g in mine),
            "graphs": step.graphs}


def _ms(xs) -> dict:
    ms = sorted(x * 1e3 for x in xs)
    return {"mean": statistics.fmean(ms), "median": statistics.median(ms),
            "p99": float(np.percentile(ms, 99))}


def _counts(ops, prefix) -> dict:
    return {k: v for k, v in ops.dispatch_counts().items() if k.startswith(prefix)}


def _score_walls(api, backend, vocab, seqs, length, seed) -> list:
    rng = np.random.default_rng(seed)
    walls = []
    for _ in range(seqs):
        tokens = rng.integers(0, vocab, length)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nll = api.score_nll(backend, tokens)
        walls.append((time.perf_counter() - t0) * 1e3)
        assert np.isfinite(nll), nll
    return walls


def part_serve(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import api
    from repro_torch.serving.batching import BatchingServer, Request

    cfg = get_config("granite-3-2b")
    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    backend = api.DenseBackend(model, params)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in rng.integers(16, 64, SERVE_REQUESTS)]
    out = {"model": cfg.name, "layers": cfg.num_layers,
           "prompt_lens": [len(p) for p in prompts], "passes": []}
    for _ in range(2):
        srv = BatchingServer(backend, max_batch=SERVE_BATCH, max_len=64 + SERVE_NEW + 8)
        for i, p in enumerate(prompts):
            srv.submit(Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW))
        ops.reset_dispatch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        done = srv.completed
        assert len(done) == SERVE_REQUESTS, len(done)
        st = srv.stats()
        out["passes"].append({
            "wall_s": wall, "decode_tok_s": st["decode_tok_s"],
            "prefill_ms": _ms([r.prefill_latency_s for r in done]),
            "admission_wait_ms": _ms([r.admission_wait_s for r in done]),
            "prefill_counts": _counts(ops, "prefill"), "prefill_pool": _pool_bytes(backend)})
    ops.reset_dispatch_counts()
    out["score_nll_ms"] = _score_walls(api, backend, cfg.vocab_size, NLL_SEQS, NLL_LEN,
                                       SEED + 2)
    out["score_nll_counts"] = _counts(ops, "prefill")
    out["score_nll_pool"] = _pool_bytes(backend)
    backend.close()
    return out


def part_expert(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import EngineConfig, OffloadEngine
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import api

    cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                              num_layers=EXPERT_LAYERS).validate()
    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    rng = np.random.default_rng(SEED + 3)
    b, s = 2, 32
    out = {"model": cfg.name, "layers": EXPERT_LAYERS}
    for paged in (False, True):
        hob = api.HobbitBackend(OffloadEngine(model, params, EngineConfig(
            async_prefetch=False, grouped=False, paged_kv=paged)))
        eng = hob.engine
        runs = []
        try:
            for _ in range(EXPERT_SEQS):
                prompts = rng.integers(0, cfg.vocab_size, (b, s))
                teacher = rng.integers(0, cfg.vocab_size, (EXPERT_STEPS, b))
                hob.start_batch(b, s + EXPERT_STEPS + 4)
                hob.prefill(prompts)
                ops.reset_dispatch_counts()
                st0 = eng.stats()
                walls = []
                for t in range(EXPERT_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    hob.step(teacher[t])
                    walls.append(time.perf_counter() - t0)
                st1 = eng.stats()
                runs.append({
                    "decode_tok_s": b * EXPERT_STEPS / sum(walls),
                    "median_step_ms": statistics.median(walls) * 1e3,
                    "loads": (st1["loads_hi"] - st0["loads_hi"])
                    + (st1["loads_lo"] - st0["loads_lo"]),
                    "counts": _counts(ops, "engine_")})
            nll = _score_walls(api, hob, cfg.vocab_size, EXPERT_NLL_SEQS, EXPERT_NLL_LEN,
                               SEED + 4)
        finally:
            hob.close()
        del hob, eng
        torch.cuda.empty_cache()
        out["paged" if paged else "dense"] = {"sequences": runs, "score_nll_ms": nll}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "src"))
    ap.add_argument("--part", choices=("serve", "expert", "all"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: prefill_time.py needs a CUDA card", flush=True)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    out = {"card": card, "src": os.path.abspath(args.src)}
    if args.part in ("serve", "all"):
        out["serve"] = part_serve(dev)
        torch.cuda.empty_cache()
    if args.part in ("expert", "all"):
        out["expert"] = part_expert(dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
