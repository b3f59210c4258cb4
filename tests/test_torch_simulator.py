"""The port's simulator host model (``core.simulator.H100_HOST``) and the
simulator set up as the engine it models (``core.host_model``), against the
JAX reference on the CPU.

* ``HARDWARE`` holds the paper's two edge devices and ``h100_host``, the
  card's own model, with positive constants and no TPU preset;
* on the trained Mixtral smoke checkpoint (``_load`` of
  test_torch_engine.py: the reference's weights carried over by
  ``weights.from_jax_params``) the port's engine, loading synchronously,
  records the reference engine's routing trace (experts and predictions
  equal, gates within 1e-5), and ``simulate_systems`` under ``h100_host``
  on it equals the reference simulator's on the reference's own trace;
* ``launch.serve --backend hobbit --device cpu`` reports
  ``simulated_decode_tok_s`` under ``h100_host`` by default, equal to
  ``simulate_systems`` on its own engine's trace;
* ``host_model``: ``sim_config`` carries every engine field the simulator
  reads, ``timed_generate`` times each step of ``engine.generate`` and
  gives the engine its own step back, ``sequence_counters`` is the difference of the engine's
  counters over one sequence, ``simulate_sequences`` on one trace is one
  ``OffloadSimulator.run`` and keeps the cache's residents across
  sequences as the engine does, ``measure_hardware`` takes the per-layer
  constant as the slope over depth, and ``resident_step`` and
  ``measure_hardware`` refuse the CPU (no CPU fallback).

The measurement itself runs on the card: tests/test_torch_simulator_card.py
at a small size, chip_smoke.py's "simulator" phase at Mixtral's width.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import repro.core.simulator as rsim
from repro.core import EngineConfig as RefEngineConfig
from repro.core import OffloadEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.core import PREC_HI, PREC_LO, EngineConfig, OffloadEngine, Thresholds
from repro_torch.core import engine as engine_mod
from repro_torch.core import host_model as hm
from repro_torch.core import simulator as tsim
from repro_torch.core.cache_guard import InstrumentedCache
from repro_torch.core.policies import LFU
from repro_torch.launch import serve as launch_serve
from repro_torch.quant.quantize import expert_nbytes
from test_torch_copies import _same
from test_torch_engine import _load

torch.set_num_threads(2)

# the slots and sequence of the CPU run that first compared the two on the
# smoke model: tight enough that both precisions load and evict
SMOKE_ENGINE = dict(hi_slots=6, lo_slots=4, async_prefetch=False)
PROMPT, NEW = 6, 16


@pytest.fixture(autouse=True)
def thread_confined_cache(monkeypatch):
    """Build every port engine's cache as an `InstrumentedCache`."""
    monkeypatch.setattr(engine_mod, "MultidimensionalCache", InstrumentedCache)
    yield


@pytest.fixture(scope="module")
def mixtral():
    return _load("mixtral-smoke")


@pytest.fixture(scope="module")
def engines(mixtral):
    """The reference's and the port's engine after one greedy sequence
    on the same prompt, and the port's tokens."""
    cfg, ref, params, port, tparams = mixtral
    prompt = [int(t) for t in np.random.default_rng(3).integers(0, cfg.vocab_size, PROMPT)]
    r_eng = RefEngine(ref, params, RefEngineConfig(**SMOKE_ENGINE))
    t_eng = OffloadEngine(port, tparams, EngineConfig(**SMOKE_ENGINE))
    try:
        want = r_eng.generate(prompt, NEW)
        got = t_eng.generate(prompt, NEW)
    finally:
        r_eng.close()
        t_eng.close()
    assert got == want
    return r_eng, t_eng, prompt


# --------------------------------------------------------------------------
# the presets
# --------------------------------------------------------------------------
def test_hardware_presets_are_the_paper_devices_and_the_card():
    assert sorted(tsim.HARDWARE) == ["h100_host", "jetson_orin", "rtx4090"]
    assert tsim.HARDWARE["h100_host"] is tsim.H100_HOST
    for name, hw in tsim.HARDWARE.items():
        assert hw.name == name and "tpu" not in name.lower()
        assert math.isfinite(hw.link_gbps) and hw.link_gbps > 0
        assert math.isfinite(hw.compute_s_per_layer) and hw.compute_s_per_layer > 0
    # the paper's published figures for its two edge devices
    for name in ("rtx4090", "jetson_orin"):
        assert dataclasses.asdict(tsim.HARDWARE[name]) == \
            dataclasses.asdict(rsim.HARDWARE[name])
    assert not hasattr(tsim, "TPU_V5E_HOST")


# --------------------------------------------------------------------------
# the engine's trace and the simulator on it, against the reference
# --------------------------------------------------------------------------
def test_engine_trace_matches_reference(engines):
    r_eng, t_eng, _ = engines
    assert len(t_eng.trace) == len(r_eng.trace) == PROMPT + NEW
    for t_tok, r_tok in zip(t_eng.trace, r_eng.trace):
        assert len(t_tok) == len(r_tok) == t_eng.num_moe_layers
        for t, r in zip(t_tok, r_tok):
            assert list(map(int, t.experts)) == list(map(int, r.experts))
            np.testing.assert_allclose(t.gate_vals, np.asarray(r.gate_vals), atol=1e-5)
            assert (t.pred_experts is None) == (r.pred_experts is None)
            if r.pred_experts is not None:
                assert list(map(int, t.pred_experts)) == list(map(int, r.pred_experts))
                np.testing.assert_allclose(t.pred_gate_vals, np.asarray(r.pred_gate_vals),
                                           atol=1e-5)


def test_simulate_systems_on_the_engine_trace_matches_reference(engines):
    r_eng, t_eng, _ = engines
    cfg = hm.sim_config(EngineConfig(**SMOKE_ENGINE), t_eng.expert_bytes)
    r_cfg = rsim.HobbitSimConfig(**{f.name: getattr(cfg, f.name)
                                    for f in dataclasses.fields(cfg)})
    r_hw = rsim.HardwareModel(**dataclasses.asdict(tsim.H100_HOST))
    got = tsim.simulate_systems(t_eng.trace, t_eng.num_moe_layers, tsim.H100_HOST, cfg)
    want = rsim.simulate_systems(r_eng.trace, r_eng.num_moe_layers, r_hw, r_cfg)
    assert sorted(got) == ["dense_layerwise", "hobbit", "on_demand", "prefetch_lru"]
    _same(got, want)
    for res in got.values():
        assert len(res["per_token_s"]) == PROMPT + NEW and res["tok_per_s"] > 0


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_launcher_simulates_h100_host_by_default(monkeypatch, capsys):
    made, real = [], launch_serve.make_backend

    def recording(config, model, params):
        made.append(real(config, model, params))
        return made[-1]

    monkeypatch.setattr(launch_serve, "make_backend", recording)
    launch_serve.main(["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu",
                       "--backend", "hobbit", "--prompt-len", "6", "--new-tokens", "5"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["hw_profile"] == "h100_host"
    eng = made[0].engine
    base = get_config("mixtral-8x7b")
    cfg = tsim.HobbitSimConfig(
        thresholds=Thresholds(0.6, 0.9), hi_slots=16, lo_slots=8,
        hi_bytes=expert_nbytes(base.d_model, base.moe.d_ff_expert, 16),
        lo_bytes=expert_nbytes(base.d_model, base.moe.d_ff_expert, 4))
    # the prompt is prefilled and the first new token read from its logits:
    # 4 decode steps, each a token of the trace over every MoE layer
    assert len(eng.trace) == 4 and all(len(t) == eng.num_moe_layers for t in eng.trace)
    want = tsim.simulate_systems(eng.trace, eng.num_moe_layers, tsim.H100_HOST, cfg)
    assert report["simulated_decode_tok_s"] == {k: round(v["tok_per_s"], 2)
                                                for k, v in want.items()}


def test_launcher_hw_choices_are_the_presets():
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu",
                           "--backend", "hobbit", "--hw", "tpu_v5e_host"])


# --------------------------------------------------------------------------
# host_model
# --------------------------------------------------------------------------
def test_sim_config_carries_the_engine_config():
    ecfg = EngineConfig(hi_slots=5, lo_slots=3, thresholds=Thresholds(0.4, 0.8),
                        policy=LFU, dynamic_loading=False, prefetch=False, streams=3,
                        ordered=True, upgrade=False)
    cfg = hm.sim_config(ecfg, {PREC_HI: 1000, PREC_LO: 250})
    assert cfg == tsim.HobbitSimConfig(
        thresholds=Thresholds(0.4, 0.8), dynamic_loading=False, prefetch=False,
        policy=LFU, hi_slots=5, lo_slots=3, hi_bytes=1000, lo_bytes=250, streams=3,
        ordered=True, upgrade=False)
    default = hm.sim_config(EngineConfig(), {PREC_HI: 1000, PREC_LO: 250})
    assert (default.streams, default.ordered, default.upgrade, default.prefetch) == \
        (2, False, True, True)


def test_resident_config_holds_every_expert_at_full_precision(mixtral):
    cfg = mixtral[0]
    ecfg = hm.resident_config(cfg)
    assert ecfg.hi_slots == cfg.num_layers * cfg.moe.num_experts
    assert ecfg.thresholds == Thresholds(1.0, 1.0) and not ecfg.prefetch


def test_timed_generate_and_sequence_counters_on_the_engine(mixtral, engines):
    cfg, _, _, port, tparams = mixtral
    _, _, prompt = engines
    eng = OffloadEngine(port, tparams, EngineConfig(**SMOKE_ENGINE))
    try:
        want = eng.generate(prompt, NEW)
        first = eng.stats()
        tokens, steps = hm.timed_generate(eng, prompt, NEW)
        after_stats = eng.stats()
        assert "decode_token" not in vars(eng)       # the engine's own step again
    finally:
        eng.close()
    assert tokens == want
    assert len(steps) == PROMPT + NEW
    walls = [st["s"] for st in steps]
    assert all(w > 0 for w in walls)
    # on the CPU the captured steps run eagerly
    assert not any(st["captures"] for st in steps)
    seq = hm.sequence_counters(first, after_stats, walls)
    assert seq["tokens"] == PROMPT + NEW
    assert seq["tok_s"] == pytest.approx(len(walls) / sum(walls))
    for key in ("loads_hi", "loads_lo", "skips"):
        assert seq[key] == after_stats[key] - first[key], key
    c0, c1 = first["cache"], after_stats["cache"]
    hits, misses = c1["hits"] - c0["hits"], c1["misses"] - c0["misses"]
    assert seq["hit_ratio"] == pytest.approx(hits / (hits + misses))
    # each step's loads and stall add up to the sequence's
    assert sum(st["loads"] for st in steps) == seq["loads_hi"] + seq["loads_lo"]
    assert sum(st["stall_s"] for st in steps) == pytest.approx(seq["load_stall_s"])


def test_simulate_sequences_is_one_run_per_sequence(engines):
    _, t_eng, _ = engines
    cfg = hm.sim_config(EngineConfig(**SMOKE_ENGINE), t_eng.expert_bytes)
    layers = t_eng.num_moe_layers
    trace = t_eng.trace
    once = tsim.OffloadSimulator("hobbit", layers, tsim.H100_HOST, cfg).run(trace)
    del once["stats"]           # the cache's live counters ("cache" is their snapshot)
    (got,) = hm.simulate_sequences([trace], layers, tsim.H100_HOST, cfg)
    _same(got["result"], once)
    assert got["tokens"] == len(trace)
    assert got["tok_s"] == once["tok_per_s"]
    assert got["hit_ratio"] == once["cache"]["hit_ratio"]
    assert got["loads_hi"] * cfg.hi_bytes == once["per_stream_bytes"][0]
    assert got["loads_lo"] * cfg.lo_bytes == once["per_stream_bytes"][1]
    # the second sequence runs on the same simulator, from the first one's
    # residents: its counters are that run's own, the cache's differenced
    first, second = hm.simulate_sequences([trace, trace], layers, tsim.H100_HOST, cfg)
    sim = tsim.OffloadSimulator("hobbit", layers, tsim.H100_HOST, cfg)
    sim.run(trace)
    again = sim.run(trace)
    del again["stats"]
    _same(first["result"], once)
    _same(second["result"], again)
    assert second["hits"] == again["cache"]["hits"] - once["cache"]["hits"]
    assert second["hits"] + second["misses"] == first["hits"] + first["misses"]
    assert second["misses"] < first["misses"]
    with pytest.raises(ValueError, match="streams"):
        hm.simulate_sequences([trace], layers, tsim.H100_HOST,
                              dataclasses.replace(cfg, streams=1))


def test_measure_hardware_refuses_the_cpu(mixtral):
    cfg, _, _, port, tparams = mixtral
    eng = OffloadEngine(port, tparams, hm.resident_config(cfg))
    try:
        with pytest.raises(ValueError, match="CUDA card"):
            hm.resident_step(eng, [1, 2, 3], 2)
        assert eng.trace == [] and sum(eng.loader.n_loads.values()) == 0
    finally:
        eng.close()
    step = {"moe_layers": 2, "median_step_s": 3e-3}
    with pytest.raises(ValueError, match="CUDA card"):
        hm.measure_hardware([step, {**step, "moe_layers": 4}], 1000, "cpu")
    with pytest.raises(ValueError, match="two depths"):
        hm.measure_hardware([step, step], 1000, "cuda")


def test_measure_hardware_takes_the_slope_over_depth(monkeypatch):
    # the link is the card's; here a stand-in rate, to check the arithmetic
    copies = []
    monkeypatch.setattr(hm, "measure_link_bps",
                        lambda nbytes, device: copies.append((nbytes, device)) or 50e9)
    steps = [{"moe_layers": 2, "median_step_s": 3e-3},
             {"moe_layers": 4, "median_step_s": 5e-3}]
    hw, meas = hm.measure_hardware(steps, 1000, "cuda", name="card")
    assert copies == [(1000, "cuda")]
    assert hw.name == "card" and hw.link_gbps == pytest.approx(50.0)
    assert hw.compute_s_per_layer == pytest.approx(1e-3)
    assert meas["step_fixed_s"] == pytest.approx(1e-3)
    assert meas["moe_layers"] == [2, 4] and meas["median_step_s"] == [3e-3, 5e-3]
    # three depths: the least-squares line
    hw, meas = hm.measure_hardware(steps + [{"moe_layers": 8, "median_step_s": 9e-3}],
                                   1000, "cuda")
    assert hw.compute_s_per_layer == pytest.approx(1e-3)
    assert meas["step_fixed_s"] == pytest.approx(1e-3)
