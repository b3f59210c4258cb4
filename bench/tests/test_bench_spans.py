"""The readers of the program's spans (``segment_ms_per_step``,
``decide_ms_per_step``, ``predict_ms_per_step``, ``reload_ms_per_step``,
``ffn_weight_mb_per_step``) on a hand-made record and a hand-filled
``repro_torch.spans.Recorder``: the steps wholly inside the traced
sub-window, the spans that start inside them, self time less child spans,
and nothing to read without a trace, without spans or without the spans
module."""

import sys

import pytest
from torch.profiler import ProfilerActivity, profile

from benchlib import loop
from benchlib.cell import read_metrics
from benchlib.devtrace import TraceData
from benchlib.loop import Record
from repro_torch import spans

NAMES = ("segment_ms_per_step", "decide_ms_per_step", "predict_ms_per_step",
         "reload_ms_per_step", "ffn_weight_mb_per_step")
STEPS = [(10.0, 11.0), (11.0, 12.0), (12.0, 13.0)]


def _record():
    rec = Record(spec={}, t_start=0.0, w0=0.0, w1=100.0)
    rec.steps = [(a, b, []) for a, b in STEPS]
    # the first step starts before the sub-window: left out
    rec.trace = TraceData(10.5, 13.5, [])
    return rec


def _fill(monkeypatch):
    """One recorder, three steps of the same phases at fixed times."""
    now = [0.0]
    monkeypatch.setattr(spans, "clock", lambda: now[0])
    rec = spans.Recorder()

    def at(t):
        now[0] = t

    with profile(activities=[ProfilerActivity.CPU]):
        for i, (a, b) in enumerate(STEPS):
            at(a + 0.001)
            with rec.span("engine.step", i, 4):
                for name, t0, t1 in (("engine.segment", 0.01, 0.11),
                                     ("engine.route", 0.11, 0.16)):
                    at(a + t0)
                    with rec.span(name, 0):
                        at(a + t1)
                at(a + 0.16)
                with rec.span("engine.predict", 0):
                    at(a + 0.2)
                    with rec.span("predictor.gating", 0, 2):
                        at(a + 0.3)
                    at(a + 0.36)
                with rec.span("engine.pairs", 0):
                    at(a + 0.4)
                    with rec.span("engine.reload", 0, 3, 1, 100):
                        at(a + 0.5)
                    at(a + 0.66)
                with rec.span("engine.ffn", 0) as sp:
                    at(a + 0.7)
                sp.attrs["weight_bytes"] = 5e6
                with rec.span("engine.retire", 0):
                    at(a + 0.71)
                at(a + 0.9)
    return rec


def _read(rec):
    return {k: v["value"] for k, v in read_metrics(
        rec, [{"name": n, "unit": "u"} for n in NAMES]).items()}


def test_the_program_spans_and_the_harness_share_one_clock():
    assert loop.now is spans.clock


def test_readers_sum_the_spans_of_the_steps_inside_the_sub_window(monkeypatch):
    filled = _fill(monkeypatch)
    monkeypatch.setattr(spans, "snapshot", filled.snapshot)
    out = _read(_record())
    # two steps inside [10.5, 13.5]; each: segment 100 ms, route 50, predict
    # 200 (its gating child included), pairs 300 less its reload's 100, ffn
    # 40, retire 10; 5 MB of weights
    assert out["segment_ms_per_step"] == pytest.approx(100.0)
    assert out["decide_ms_per_step"] == pytest.approx(50.0 + 200.0 + 40.0 + 10.0)
    assert out["predict_ms_per_step"] == pytest.approx(200.0)
    assert out["reload_ms_per_step"] == pytest.approx(100.0)
    assert out["ffn_weight_mb_per_step"] == pytest.approx(5.0)


def test_readers_find_nothing_without_a_trace_spans_or_the_module(monkeypatch):
    filled = _fill(monkeypatch)
    monkeypatch.setattr(spans, "snapshot", filled.snapshot)
    rec = _record()
    rec.trace = None
    assert _read(rec) == {}
    monkeypatch.setattr(spans, "snapshot", spans.Recorder().snapshot)
    assert _read(_record()) == {}
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)    # a program without it
    assert _read(_record()) == {}
