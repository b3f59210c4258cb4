"""The span recorder (``repro_torch.spans``) and the spans the offload
decode step, the staging loader, chunked prefill and ``BatchingServer``
record with it, on the CPU: recording only under an active
``torch.profiler`` session, ``time.perf_counter`` stamps, per-thread
parents, the bounded ring, the engine phases tiling each step, one
``engine.reload`` per union-overflow reload, the FFN spans' pair and slot
counts against the engine's launch histograms, and the scheduler's request
ids."""

import collections
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.configs.base import smoke_variant
from repro_torch.core import EngineConfig, OffloadEngine
from repro_torch.core import engine as engine_mod
from repro_torch.core.cache_guard import InstrumentedCache
from repro_torch.core.engine import pack_pair_table, pair_table_words
from repro_torch.kernels import ops as kops
from repro_torch.models.model import Model
from repro_torch.serving.api import HobbitBackend
from repro_torch.serving.batching import BatchingServer, Request

PHASES = ("engine.prologue", "engine.segment", "engine.route", "engine.predict",
          "engine.load", "engine.pairs", "engine.ffn", "engine.retire", "engine.logits")


@pytest.fixture(autouse=True)
def thread_confined_cache(monkeypatch):
    """Every engine's cache raises if a staging thread mutates it."""
    monkeypatch.setattr(engine_mod, "MultidimensionalCache", InstrumentedCache)
    yield


@pytest.fixture
def recorder():
    spans.clear()
    yield spans
    spans.clear()


def _profiling():
    return profile(activities=[ProfilerActivity.CPU])


def test_recording_reads_torchs_profiler_flag():
    # the flag the recorder reads; a torch that drops it leaves the spans on
    # the C++ fallback, which this test then asks to be looked at
    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)
    assert spans.recording is not torch._C._autograd._profiler_enabled
    assert spans.recording() is False
    with _profiling():
        assert spans.recording() is True
        assert torch._C._autograd._profiler_enabled()
    assert spans.recording() is False


def test_nothing_recorded_without_a_profiler(recorder):
    assert not spans.recording()
    with spans.span("engine.step", 0, 1) as sp:
        with spans.span("engine.segment", 0) as child:
            pass
    assert sp is spans.OFF and child is spans.OFF and not sp.on
    assert spans.snapshot() == [] and spans.dropped() == 0


def _stage_span():
    with spans.span("loader.stage", 3, 1, 0, "prefetch", 64):
        pass


def test_spans_under_a_profiler_carry_perf_counter_stamps_and_parents(recorder):
    assert spans.clock is time.perf_counter
    outer = spans.span("sched.iter")        # opened while off: never recorded
    with outer:
        t0 = time.perf_counter()
        with _profiling():
            assert spans.recording()
            with spans.span("engine.step", 7, 2) as step:
                with spans.span("engine.segment", 3) as seg:
                    pass
                with spans.span("engine.logits"):
                    pass
                th = threading.Thread(target=_stage_span)
                th.start()
                th.join(timeout=10)
                assert not th.is_alive()
            t1 = time.perf_counter()
    assert not spans.recording()
    got = {s.name: s for s in spans.snapshot()}
    assert sorted(got) == ["engine.logits", "engine.segment", "engine.step", "loader.stage"]
    assert got["engine.step"] is step and step.parent is None
    assert outer is spans.OFF
    assert seg.parent == step.id and got["engine.logits"].parent == step.id
    # another thread's stack is its own
    assert got["loader.stage"].parent is None
    assert t0 <= step.start <= seg.start <= seg.end <= step.end <= t1
    assert step.attrs == {"step": 7, "rows": 2} and seg.attrs == {"layer": 3}
    assert got["loader.stage"].attrs == {"layer": 3, "expert": 1, "precision": 0,
                                         "reason": "prefetch", "bytes": 64}


def test_ring_drops_its_oldest_spans_and_counts_them():
    rec = spans.Recorder(capacity=4)
    with _profiling():
        for i in range(6):
            with rec.span("engine.segment", i):
                pass
    assert [s.attrs["layer"] for s in rec.snapshot()] == [2, 3, 4, 5]
    assert rec.dropped() == 2
    rec.clear()
    assert rec.snapshot() == [] and rec.dropped() == 0


def ffn_weight_bytes(table, b, k, **nb):
    idx = table[:6 * b * k].reshape(6, b * k)
    return kops.grouped_ffn_weight_bytes(idx[2], idx[5], idx[3] < b, **nb)


def test_ffn_weight_bytes_follows_the_kernels_reads():
    b, k = 4, 2
    table = np.zeros(pair_table_words(b, k), np.int32)
    w = np.zeros((b, k), np.float32)
    nb = dict(hi_bytes=100, lo_wi_bytes=10, lo_wo_bytes=1)
    # hi: slots 3, 3, 5 and 5 pads on 5 (two distinct); lo: slots 2, 1 and 6
    # pads on 1 (wi reads both, the combine only the two real pairs)
    pack_pair_table(table, [(0, 0, 3), (1, 0, 3), (2, 1, 5)], [(0, 1, 2), (3, 0, 1)], w, w)
    assert ffn_weight_bytes(table, b, k, **nb) == 2 * 100 + 2 * 10 + 2 * 1
    # a launch of pads only still streams one hi expert and one lo wi matrix
    pack_pair_table(table, [], [], w, w)
    assert ffn_weight_bytes(table, b, k, **nb) == 100 + 10
    # past GROUPED_PAIRS / GMM_GROUP pairs a slot is streamed again
    b = 8
    table = np.zeros(pair_table_words(b, k), np.int32)
    w = np.zeros((b, k), np.float32)
    pairs = [(r, j, 4) for r in range(b) for j in range(k)]
    pack_pair_table(table, pairs, pairs[:9], w, w)
    assert ffn_weight_bytes(table, b, k, **nb) == 2 * 100 + 2 * 10 + 2 * 1


def _smoke_model():
    cfg = smoke_variant(get_config("mixtral-8x7b"), layers=4, d_model=64, vocab=256)
    model = Model(cfg)
    return model, model.init(0, device="cpu")


def _hist_delta(after, before, key):
    a, b = after[key]["hist"], before[key]["hist"]
    return collections.Counter({n: c - b.get(n, 0) for n, c in a.items() if c - b.get(n, 0)})


def test_engine_phases_tile_each_step_and_count_reloads_and_pairs(recorder):
    model, params = _smoke_model()
    # two hi slots and one lo slot for 4 experts at batch 2: union overflow
    eng = OffloadEngine(model, params, EngineConfig(hi_slots=2, lo_slots=1))
    try:
        eng.start_batch(2, 64)
        rng = np.random.default_rng(0)
        eng.prefill_batch(rng.integers(0, 256, (2, 8)))
        for _ in range(2):
            eng.decode_step_batch(rng.integers(0, 256, (2,)))
        before = eng.stats()
        with _profiling():
            for _ in range(6):
                eng.decode_step_batch(rng.integers(0, 256, (2,)))
        after = eng.stats()
    finally:
        eng.close()
    got = spans.snapshot()
    by_id = {s.id: s for s in got}
    steps = [s for s in got if s.name == "engine.step"]
    assert len(steps) == 6 and all(s.attrs["rows"] == 2 for s in steps)
    for st in steps:
        kids = [s for s in got if s.parent == st.id]
        assert {s.name for s in kids} == set(PHASES)
        assert sum(s.name == "engine.segment" for s in kids) == eng.num_moe_layers
        covered = sum(s.end - s.start for s in kids)
        assert covered >= 0.95 * (st.end - st.start), (covered, st.end - st.start)
    reloads = [s for s in got if s.name == "engine.reload"]
    assert len(reloads) == after["union_reloads"] - before["union_reloads"] > 0
    assert all(by_id[s.parent].name == "engine.pairs" for s in reloads)
    # the grouped path predicts from its segments' readbacks: no host call,
    # one segment prediction per row on every MoE layer but the last
    assert not any(s.name == "predictor.gating" for s in got)
    assert before["predictor_host_calls"] == after["predictor_host_calls"] == 0
    assert (after["segment_predictions"] - before["segment_predictions"]
            == 6 * 2 * (eng.num_moe_layers - 1))
    assert any(s.name == "loader.stage" for s in got)
    ffn = [s for s in got if s.name == "engine.ffn"]
    for attr, key in (("hi_pairs", "hi_pairs_per_launch"), ("lo_pairs", "lo_pairs_per_launch"),
                      ("hi_slots", "hi_slots_per_launch"), ("lo_slots", "lo_slots_per_launch")):
        assert collections.Counter(s.attrs[attr] for s in ffn) == _hist_delta(after, before,
                                                                               key), attr
    assert all(s.attrs["weight_bytes"] > 0 for s in ffn)


def test_per_expert_path_predicts_through_host_calls_under_engine_predict(recorder):
    model, params = _smoke_model()
    eng = OffloadEngine(model, params, EngineConfig(hi_slots=2, lo_slots=1, grouped=False))
    try:
        eng.start_batch(2, 64)
        rng = np.random.default_rng(0)
        eng.prefill_batch(rng.integers(0, 256, (2, 8)))
        before = eng.stats()
        with _profiling():
            for _ in range(4):
                eng.decode_step_batch(rng.integers(0, 256, (2,)))
        after = eng.stats()
    finally:
        eng.close()
    got = spans.snapshot()
    by_id = {s.id: s for s in got}
    gating = [s for s in got if s.name == "predictor.gating"]
    assert gating and all(by_id[s.parent].name == "engine.predict" for s in gating)
    predict = [s for s in got if s.name == "engine.predict"]
    assert len(predict) == 4 * eng.num_moe_layers
    assert all(by_id[s.parent].name == "engine.step" for s in predict)
    # at least one call per row on every MoE layer but the last
    calls = after["predictor_host_calls"] - before["predictor_host_calls"]
    assert calls == len(gating) >= 4 * 2 * (eng.num_moe_layers - 1)
    assert after["segment_predictions"] == 0


def test_batching_server_spans_carry_the_request_ids(recorder):
    model, params = _smoke_model()
    eng = OffloadEngine(model, params, EngineConfig(hi_slots=8, lo_slots=4, paged_kv=True,
                                                    kv_page_size=16, prefill_chunk=16))
    srv = BatchingServer(HobbitBackend(eng), max_batch=2, max_len=96, policy="fifo")
    rng = np.random.default_rng(1)
    for rid, n in ((11, 20), (12, 9), (13, 30)):
        srv.submit(Request(rid=rid, prompt=rng.integers(0, 256, n), max_new_tokens=4))
    try:
        with _profiling():
            srv.run()
    finally:
        srv.close()
    got = spans.snapshot()
    by_id = {s.id: s for s in got}
    admits = [s for s in got if s.name == "sched.admit"]
    assert sorted(r for s in admits for r in s.attrs["rids"]) == [11, 12, 13]
    steps = [s for s in got if s.name == "sched.step"]
    served = collections.Counter(r for s in steps for r in s.attrs["rids"])
    # each request's first token comes from its prefill, the other three
    # from the steps it rides
    assert served == {11: 3, 12: 3, 13: 3}
    assert all(1 <= len(s.attrs["rids"]) <= 2 for s in steps)
    joins = [s for s in got if s.name == "sched.join"]
    assert {r for s in joins for r in s.attrs["rids"]} == {11, 12, 13}
    for s in got:
        if s.name.startswith("sched.") and s.name != "sched.iter":
            assert by_id[s.parent].name == "sched.iter", s
        if s.name == "engine.step":
            assert by_id[s.parent].name == "sched.step"
        if s.name == "prefill.chunk":
            assert by_id[s.parent].name == "sched.join"
            kids = {c.name for c in got if c.parent == s.id}
            assert kids == {"prefill.plan", "prefill.replay", "prefill.readback"}
    assert sum(s.name == "engine.step" for s in got) == len(steps)
    assert any(s.name == "prefill.chunk" for s in got)


def test_every_span_is_documented():
    doc = (Path(__file__).resolve().parents[1] / "docs" / "TORCH_METRICS.md").read_text()
    section = doc[doc.index("## Spans"):]
    assert [n for n in spans.KEYS if f"| `{n}` |" not in section] == []
