"""The metric arithmetic on hand-made records: window rate, gap and
first-token percentiles, counter deltas and shares, FLOP counts, interval
unions; and the prefill entries the loop records when the prefix cache
holds part of a prompt."""

import math
import time

import numpy as np
import pytest

from benchlib import arith, flops, paths, peaks, traffic
from benchlib.cell import load_block, read_metrics, run_cell
from benchlib.devtrace import TraceData, breakdown
from benchlib.loop import Record, counters
from smoke import smoke_config, smoke_mix

SPEC = {"d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4, "num_layers": 2,
        "num_experts": 4, "top_k": 2, "d_ff_expert": 16, "vocab_size": 32}


def _stats(hits, misses, nbytes, stall, hi, lo, skips):
    return {"hits": hits, "misses": misses, "loaded_bytes": nbytes, "load_stall_s": stall,
            "hi_pairs": hi, "lo_pairs": lo, "skips": skips, "served_lo": 0, "downgrades": 0}


def record():
    rec = Record(spec=SPEC, t_start=0.0, w0=10.0, w1=20.0, block=load_block({}))
    # request 1: tokens every 0.5 s from 9.0; request 2 from 12.2, with one 2 s gap
    rec.stamps = {1: [9.0 + 0.5 * i for i in range(30)], 2: [12.2, 12.4, 14.4, 14.6],
                  -1: [5.0]}
    rec.submits = {1: 8.0, 2: 11.2, -1: 0.0}
    rec.prompt_len = {1: 10, 2: 20, -1: 64}
    rec.warm = {-1}
    rec.steps = [(t - 0.4, t, [(1, 11 + i)]) for i, t in enumerate(rec.stamps[1][1:])]
    rec.joins = [(11.0, 11.5, [(2, 0, 16)]), (11.9, 12.2, [(2, 16, 4)])]
    rec.stats = [(9.5, _stats(10, 10, 0, 0.0, 0, 0, 0)),
                 (19.9, _stats(40, 20, 5e6, 1.5, 60, 30, 10))]
    return rec


def test_percentile_and_union():
    assert arith.percentile([], 95) is None
    assert arith.percentile([1, 2, 3, 4], 50) == 2.5
    assert arith.percentile(list(range(101)), 95) == pytest.approx(95.0)
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert arith.union_length(iv, 0, 10) == pytest.approx(4.0)
    assert arith.union_length(iv, 1.5, 5.5) == pytest.approx(2.0)
    assert arith.gaps(iv, 0, 10) == [(3, 5), (6, 10)]


def test_window_rate_gaps_and_ttft():
    rec = record()
    m = {x["name"]: x for x in [{"name": n, "unit": "u"} for n in (
        "decode_tok_s", "itl_p95_ms.offload", "ttft_p95_ms", "setup_s")]}
    out = read_metrics(rec, m.values())
    inside = sum(1 for ts in rec.stamps.values() for t in ts if 10 <= t <= 20)
    assert out["decode_tok_s"]["value"] == pytest.approx(inside / 10.0)
    g = [500.0] * 19 + [200.0, 2000.0, 200.0]     # request 1's gaps in window, then 2's
    assert out["itl_p95_ms.offload"]["value"] == pytest.approx(arith.percentile(g, 95))
    # only request 2's first token lies in the window; the warm-up wave never counts
    assert out["ttft_p95_ms"]["value"] == pytest.approx(1000.0)
    assert out["setup_s"]["value"] == 10.0


def test_counter_deltas_and_shares():
    rec = record()
    names = ("lo_served_share", "expert_hit_ratio", "load_stall_ms_per_step",
             "loaded_mb_per_token", "step_ms_p50", "chunk_ms_p50", "sched_ms_per_step")
    out = {k: v["value"] for k, v in read_metrics(rec, [{"name": n, "unit": "u"}
                                                        for n in names]).items()}
    assert out["lo_served_share"] == pytest.approx(40 / 100)
    assert out["expert_hit_ratio"] == pytest.approx(30 / 40)
    n_steps = sum(1 for s in rec.steps if 9.5 < s[1] <= 19.9)
    assert out["load_stall_ms_per_step"] == pytest.approx(1.5 / n_steps * 1e3)
    assert out["loaded_mb_per_token"] == pytest.approx(5.0 / rec.tokens_between(9.5, 19.9))
    assert out["step_ms_p50"] == pytest.approx(400.0)
    assert out["chunk_ms_p50"] == pytest.approx(400.0)
    # 0.1 s between the window's 21 steps, less the 0.1 s of each join there
    assert out["sched_ms_per_step"] == pytest.approx((0.1 * 20 - 0.2) / 20 * 1e3)


def test_counters_from_engine_stats():
    s = {"cache": {"hits": 3, "misses": 1}, "loaded_bytes": 7, "load_stall_s": 0.5,
         "hi_pairs_per_launch": {"hist": {2: 3, 1: 1}}, "lo_pairs_per_launch": {"hist": {}},
         "skips": 4}
    c = counters(s)
    assert (c["hits"], c["hi_pairs"], c["lo_pairs"], c["skips"]) == (3, 7, 0, 4)


def test_flop_counts():
    per_layer = (2 * 8 * (2 + 2) * 4 + 2 * 2 * 4 * 8 + 2 * 8 * 4 + 2 * 6 * 8 * 16)
    assert flops.token_flops(SPEC, 5) == 2 * (per_layer + 4 * 2 * 4 * 5) + 2 * 8 * 32
    chunk = flops.chunk_flops(SPEC, 3, 4)
    assert chunk == pytest.approx(sum(flops.token_flops(SPEC, p + 1) - 2 * 8 * 32
                                      for p in range(3, 7)))
    assert flops.chunk_flops(SPEC, 3, 4, head=True) == pytest.approx(chunk + 2 * 8 * 32)
    assert flops.chunk_flops(SPEC, 3, 0) == 0.0
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12


def test_trace_metrics_and_breakdown():
    rec = record()
    rec.trace = TraceData(12.0, 16.0, [("grouped_mm_kernel", "kernel", 12.0, 12.5),
                                       ("Memcpy HtoD", "copy", 12.2, 13.0),
                                       ("gemv", "kernel", 14.0, 15.0)])
    rec.spans = [("step", 13.5, 14.5), ("stats", 15.2, 15.9)]
    out = {k: v["value"] for k, v in read_metrics(rec, [{"name": n, "unit": "u"} for n in (
        "device_idle_share.decode", "ffn_kernel_ms_per_step", "decode_mfu",
        "host_ms_per_step")]).items()}
    assert rec.trace.busy_s() == pytest.approx(2.0)
    assert out["device_idle_share.decode"] == pytest.approx(50.0)
    n = sum(1 for s in rec.steps if 12.0 <= s[1] <= 16.0)
    assert out["ffn_kernel_ms_per_step"] == pytest.approx(500.0 / n)
    f = sum(flops.token_flops(SPEC, k) for _, b, e in rec.steps if 12 <= b <= 16 for _, k in e)
    assert out["decode_mfu"] == pytest.approx(100 * f / (4.0 * 989e12))
    assert math.isfinite(out["host_ms_per_step"])
    bd = breakdown(rec)
    assert bd["device_ops"][0][0] == "gemv"
    idle = dict(bd["idle_gaps"])
    assert idle["step"] == pytest.approx(1.0) and idle["stats"] == pytest.approx(1.0)
    assert sum(idle.values()) == pytest.approx(2.0)


def test_readers_find_nothing_without_a_trace():
    rec = record()
    out = read_metrics(rec, [{"name": n, "unit": "u"} for n in (
        "device_idle_share.prefill", "prefill_mfu", "ffn_kernel_ms_per_step",
        "host_ms_per_step", "decode_mfu")])
    assert out == {}


def test_prefill_entries_start_where_the_prefix_cache_left_off(monkeypatch):
    """Prompts that share a two-page prefix: while a request that holds it
    is live, the page pool's radix cache hands it to the next admission,
    whose chunked prefill then feeds only the rest.  The loop records just
    what was fed (each entry one chunk at most, every prompt fed to its end
    from its matched length), so ``prefill_mfu`` counts no FLOP of the
    shared tokens, and the run stays correct against the reference over
    the whole prompts."""
    man = paths.Manifest.load()
    cfg = smoke_config()
    chunk, page = cfg["engine"]["prefill_chunk"], cfg["engine"]["kv_page_size"]
    shared = 2 * page
    # 24 decode steps of warm-up: admissions while another request holds the
    # prefix come before the window opens, however slow the CPU
    mix = dict(smoke_mix(man, "mixtral-decode-c4"), prompt_len=[shared + 8, 72],
               warmup_decode_steps=24)

    def jobs(mix, vocab, rng):
        prefix = rng.integers(0, vocab, shared)
        plens = traffic.strata(*mix["prompt_len"], mix["strata"])
        olens = traffic.strata(*mix["output_len"], mix["strata"])
        rid = 0
        while True:         # outputs of different lengths: one request is live at each admission
            for i in rng.permutation(mix["strata"]):
                tail = rng.integers(0, vocab, plens[i] - shared)
                yield traffic.Job(rid=rid, prompt=np.concatenate([prefix, tail]).astype(
                    np.int32), max_new_tokens=int(olens[(i + rid) % mix["strata"]]))
                rid += 1

    monkeypatch.setattr(traffic, "jobs", jobs)
    seen = []
    t_start = time.perf_counter()
    res = run_cell(man, "mixtral-decode-c4", 2**31 + 5, 1.0, False, t_start=t_start,
                   device="cpu", config=cfg, mix=mix,
                   wrap_backend=lambda b: seen.append(b) or b)
    assert res["correct"], res["check"]
    rec = res["rec"]
    first, fed = {}, {}
    for _, _, entries in rec.joins:
        for rid, start, n in entries:
            assert 0 < n <= chunk
            assert start == fed.setdefault(rid, first.setdefault(rid, start))
            fed[rid] = start + n
    assert all(fed[rid] == rec.prompt_len[rid] for rid in fed if rec.stamps[rid])
    assert first[0] == 0 and set(first.values()) == {0, shared}
    assert sum(first.values()) == seen[0].kv.prefix_hit_tokens

    rec.trace = TraceData(t_start, time.perf_counter(), [])
    got = read_metrics(rec, [{"name": "prefill_mfu", "unit": "%"}])["prefill_mfu"]["value"]
    f = sum(flops.chunk_flops(rec.spec, start, n, head=start + n >= rec.prompt_len[rid])
            for _, _, entries in rec.joins for rid, start, n in entries)
    assert got == pytest.approx(100.0 * f / (rec.trace.window_s * peaks.BF16_FLOPS))
