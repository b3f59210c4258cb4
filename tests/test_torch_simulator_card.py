"""The simulator's host model measured on a CUDA card at a small size
(marked ``cuda``; each test skips without a card).  This file imports
neither JAX nor the reference, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_simulator_card.py

* ``host_model.resident_step`` on a bf16 Mixtral smoke model cut to 1 and
  2 layers, every expert resident, and ``measure_hardware`` over the two:
  finite positive constants, the per-layer constant the slope between the
  depths, the timed steps load nothing once the warm-up decode loaded the
  sequence's experts (the first captures again), the resident steps launch
  the router and the bf16 grouped GEMV on the card and no plain version;
* one sequence on a constrained engine after a warm-up: its counters
  (``sequence_counters``) against the simulator's on the same traces
  (``simulate_sequences`` under the measured model), every trace token
  covered over every MoE layer (the gap itself is measured by
  chip_smoke.py's "simulator" phase at Mixtral's width, not gated).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import PREC_HI, EngineConfig, OffloadEngine
from repro_torch.core import host_model as hm
from repro_torch.core.simulator import H100_HOST
from repro_torch.kernels import ops
from repro_torch.models import build_model


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: chip_smoke.py runs these paths on the H100")
    return torch.device("cuda", 0)


def _mixtral(layers: int = 2):
    cfg = smoke_variant(get_config("mixtral-8x7b"), layers=layers, d_model=256, vocab=512)
    return build_model(dataclasses.replace(cfg, dtype="bfloat16"))


@pytest.mark.cuda
def test_measure_hardware_on_card(card):
    port = _mixtral()
    params = port.init(0, device=card)
    prompt = np.random.default_rng(0).integers(0, port.cfg.vocab_size, 8)
    steps = []
    ops.reset_dispatch_counts()
    for layers in (1, 2):
        cut = _mixtral(layers)
        eng = OffloadEngine(cut, {**params, "layers": params["layers"][:layers]},
                            hm.resident_config(cut.cfg))
        try:
            steps.append(hm.resident_step(eng, prompt, 8))
            hi_bytes = eng.expert_bytes[PREC_HI]
        finally:
            eng.close()
    counts = ops.dispatch_counts()
    hw, meas = hm.measure_hardware(steps, hi_bytes, card, name="card")
    assert hw.name == "card"
    for x in (hw.link_gbps, hw.compute_s_per_layer):
        assert math.isfinite(x) and x > 0
    for layers, s in zip((1, 2), steps):
        assert s["moe_layers"] == layers and len(s["step_s"]) == 16
        assert s["load_steps"] == 0 and s["capture_steps"] >= 1
    assert meas["moe_layers"] == [1, 2]
    assert hw.compute_s_per_layer == pytest.approx(
        steps[1]["median_step_s"] - steps[0]["median_step_s"])
    assert meas["step_fixed_s"] == pytest.approx(
        steps[0]["median_step_s"] - hw.compute_s_per_layer)
    assert counts.get("gating_topk.cuda", 0) > 0 and counts.get("grouped_matmul.cuda", 0) > 0
    assert not [k for k in counts if k.endswith(".torch")]


@pytest.mark.cuda
def test_engine_against_simulator_on_card(card):
    port = _mixtral()
    params = port.init(0, device=card)
    rng = np.random.default_rng(1)
    ecfg = EngineConfig(hi_slots=4, lo_slots=4)
    eng = OffloadEngine(port, params, ecfg)
    try:
        eng.generate([int(t) for t in rng.integers(0, port.cfg.vocab_size, 6)], 6)
        warm = list(eng.trace)
        before = eng.stats()
        _, steps = hm.timed_generate(eng, rng.integers(0, port.cfg.vocab_size, 8), 8)
        measured = hm.sequence_counters(before, eng.stats(), [st["s"] for st in steps])
        trace = list(eng.trace)
        cfg = hm.sim_config(ecfg, eng.expert_bytes)
        layers = eng.num_moe_layers
    finally:
        eng.close()
    first, second = hm.simulate_sequences([warm, trace], layers, H100_HOST, cfg)
    assert first["tokens"] == len(warm) == 12 and second["tokens"] == len(trace) == 16
    assert all(len(t) == layers for t in trace)
    assert measured["tokens"] == 16 and measured["tok_s"] > 0
    assert second["hits"] + second["misses"] == measured["hits"] + measured["misses"]
    for c in (measured, second):
        assert 0.0 <= c["hit_ratio"] <= 1.0 and 0.0 <= c["overlap_fraction"] <= 1.0
