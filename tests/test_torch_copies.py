"""The port's copies of framework-free reference modules against their
twins: the same seeded cases through each pair, results compared exactly
(both sides run the same numpy and Python arithmetic).

* ``core/simulator.py``: ``simulate_systems``, ``OffloadSimulator`` and
  ``ServingTimeline`` on one trace, and ``cache_policy_penalty`` under
  every named policy;
* ``core/scoring.py``: every scoring function;
* ``core/fleet_heat.py``: ``FleetHeat`` over one stream of observations
  and retirements;
* ``configs/base.py``: every reference architecture, carried field by
  field into the port's dataclasses, through the derived properties, the
  parameter counts and ``smoke_variant``;
* ``serving/workload.py``: ``generate_workload`` and the scheduling
  helpers.
"""

import dataclasses

import numpy as np
import pytest

import repro.configs as rcfg
import repro.configs.base as rbase
import repro.core.fleet_heat as rheat
import repro.core.policies as rpol
import repro.core.scoring as rscore
import repro.core.simulator as rsim
import repro.serving.workload as rwork
import repro_torch.configs.base as tbase
import repro_torch.core.fleet_heat as theat
import repro_torch.core.policies as tpol
import repro_torch.core.scoring as tscore
import repro_torch.core.simulator as tsim
import repro_torch.serving.workload as twork


def _same(a, b, path="result"):
    """Deep equality of results: dicts, sequences, arrays, floats (NaN and
    infinity equal to themselves) and objects with ``to_dict``."""
    if hasattr(a, "to_dict"):
        a, b = a.to_dict(), b.to_dict()
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == b or (np.isnan(a) and np.isnan(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


# --------------------------------------------------------------------------
# the simulator
# --------------------------------------------------------------------------
LAYERS, EXPERTS, TOP_K, TOKENS = 4, 8, 2, 24


def _trace(sim, seed: int, predicted: bool = True):
    """One seeded decode trace of `sim`'s TraceLayer records: skewed
    routing, normalised gates, a predictor right for about two thirds of
    the tokens."""
    rng = np.random.default_rng(seed)
    pop = rng.dirichlet(np.full(EXPERTS, 0.4), LAYERS)
    out = []
    for _ in range(TOKENS):
        token = []
        for li in range(LAYERS):
            experts = rng.choice(EXPERTS, TOP_K, replace=False, p=pop[li])
            gates = np.sort(rng.dirichlet(np.ones(TOP_K)))[::-1].astype(np.float32)
            pred = pred_g = None
            if predicted:
                pred = [int(e) for e in (experts if rng.random() < 0.67
                                         else rng.permutation(EXPERTS)[:TOP_K])]
                pred_g = np.sort(rng.dirichlet(np.ones(TOP_K)))[::-1].astype(np.float32)
            token.append(sim.TraceLayer(experts=[int(e) for e in experts],
                                        gate_vals=gates, pred_experts=pred,
                                        pred_gate_vals=pred_g))
        out.append(token)
    return out


def _sim_cfg(sim, score, pol, streams, ordered, upgrade, prefetch_conf):
    return sim.HobbitSimConfig(
        thresholds=score.Thresholds(0.6, 0.9), policy=pol.MULTIDIM, hi_slots=16,
        lo_slots=12, hi_bytes=10_000_000, lo_bytes=2_500_000, streams=streams,
        ordered=ordered, upgrade=upgrade, prefetch_conf=prefetch_conf)


# the reference's presets and the port's card, each model built on both
# sides from one set of fields (the reference's TPU preset lives only there)
HW_FIELDS = {**{n: dataclasses.asdict(h) for n, h in rsim.HARDWARE.items()},
             "h100_host": dataclasses.asdict(tsim.H100_HOST)}


@pytest.mark.parametrize("hw", sorted(HW_FIELDS))
@pytest.mark.parametrize("streams,ordered,upgrade,conf", [
    (1, True, True, 0.0), (2, False, True, 0.0), (2, False, False, 0.5)],
    ids=["paper", "budgeted", "no-upgrade"])
def test_simulate_systems_matches_reference(hw, streams, ordered, upgrade, conf):
    want = rsim.simulate_systems(_trace(rsim, 7), LAYERS, rsim.HardwareModel(**HW_FIELDS[hw]),
                                 _sim_cfg(rsim, rscore, rpol, streams, ordered, upgrade, conf))
    got = tsim.simulate_systems(_trace(tsim, 7), LAYERS, tsim.HardwareModel(**HW_FIELDS[hw]),
                                _sim_cfg(tsim, tscore, tpol, streams, ordered, upgrade, conf))
    assert sorted(got) == ["dense_layerwise", "hobbit", "on_demand", "prefetch_lru"]
    _same(got, want)


@pytest.mark.parametrize("reset", [True, False])
def test_offload_simulator_matches_reference(reset):
    hw = dict(name="probe", link_gbps=12.0, compute_s_per_layer=2e-3)
    runs = []
    for sim, score, pol in ((rsim, rscore, rpol), (tsim, tscore, tpol)):
        cfg = _sim_cfg(sim, score, pol, 2, False, True, 0.0)
        runs.append(sim.OffloadSimulator("hobbit", LAYERS, sim.HardwareModel(**hw), cfg)
                    .run(_trace(sim, 11, predicted=False), reset_per_sequence=reset))
    _same(runs[1], runs[0])


def _workload(work, seed=5):
    classes = (
        work.RequestClass("chat", weight=3.0, prompt_tokens=(8, 48), new_tokens=(4, 24),
                          shared_prefix=True),
        work.RequestClass("urgent", weight=1.0, priority=2, ttft_slo_s=1.5,
                          tpot_slo_s=0.2, prompt_tokens=(4, 16), new_tokens=(2, 8)),
        work.RequestClass("batch", weight=1.0, prompt_tokens=(64, 128),
                          new_tokens=(16, 48)),
    )
    return work.generate_workload(work.WorkloadConfig(
        classes=classes, num_requests=40, arrival_rate=6.0, vocab=512, seed=seed))


@pytest.mark.parametrize("policy", ["fifo", "slo"])
def test_serving_timeline_matches_reference(policy):
    kw = dict(slots=3, kv_tokens=400, prefill_tok_s=2048.0, decode_step_s=0.04,
              policy=policy, aging_s=5.0, preempt_margin=0.5)
    want = rsim.ServingTimeline(rsim.TimelineConfig(**kw)).run(_workload(rwork))
    got = tsim.ServingTimeline(tsim.TimelineConfig(**kw)).run(_workload(twork))
    assert got["completed"] == 40
    _same(got, want)


@pytest.mark.parametrize("policy", sorted(rpol.NAMED_POLICIES))
@pytest.mark.parametrize("sequence_level", [True, False])
def test_cache_policy_penalty_matches_reference(policy, sequence_level):
    args = dict(hi_slots=6, lo_slots=4, lo_cost_ratio=0.25,
                sequence_level=sequence_level, sequence_breaks=[8, 16])
    want = rsim.cache_policy_penalty(_trace(rsim, 3), LAYERS, rpol.NAMED_POLICIES[policy],
                                     th=rscore.Thresholds(0.5, 0.85), **args)
    got = tsim.cache_policy_penalty(_trace(tsim, 3), LAYERS, tpol.NAMED_POLICIES[policy],
                                    th=tscore.Thresholds(0.5, 0.85), **args)
    assert got == want and got > 0


# --------------------------------------------------------------------------
# scoring
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2,), (8,), (5, 2), (3, 6)])
def test_scoring_functions_match_reference(shape):
    rng = np.random.default_rng(sum(shape))
    g = rng.dirichlet(np.ones(shape[-1]), shape[:-1] or None).astype(np.float32)
    for fn in ("normalize_gates", "unimportance_scores"):
        _same(getattr(tscore, fn)(g), getattr(rscore, fn)(g), fn)
    for t1, t2 in ((0.6, 0.9), (0.0, 0.0), (1.0, 1.0), (0.3, 0.5)):
        _same(tscore.precision_decisions(g, tscore.Thresholds(t1, t2)),
              rscore.precision_decisions(g, rscore.Thresholds(t1, t2)), (t1, t2))
    scores = rng.random(64)
    for frac in ((0.67, 0.30), (0.5, 0.1), (1.0, 0.0)):
        _same(tscore.calibrate_thresholds(scores, frac_hi=frac[0], frac_lo=frac[1]),
              rscore.calibrate_thresholds(scores, frac_hi=frac[0], frac_lo=frac[1]), frac)
    _same(tscore.calibrate_thresholds(np.zeros(0)), rscore.calibrate_thresholds(np.zeros(0)))
    a = rng.random(32)
    b = 2 * a + 0.1 * rng.standard_normal(32)
    assert tscore.gate_output_correlation(a, b) == rscore.gate_output_correlation(a, b)


# --------------------------------------------------------------------------
# FleetHeat
# --------------------------------------------------------------------------
@pytest.mark.parametrize("decay,floor", [(0.9, 1e-3), (0.5, 0.05)])
def test_fleet_heat_matches_reference(decay, floor):
    rng = np.random.default_rng(int(decay * 10))
    heats = [rheat.FleetHeat(decay, floor), theat.FleetHeat(decay, floor)]
    for step in range(200):
        if rng.random() < 0.1:
            for h in heats:
                h.retire_request()
            continue
        key = (int(rng.integers(LAYERS)), int(rng.integers(EXPERTS)))
        w = float(rng.random())
        for h in heats:
            h.observe(key, w)
        if step % 10 == 0:
            r, t = heats
            probe = (int(rng.integers(LAYERS)), int(rng.integers(EXPERTS)))
            assert t.score(probe) == r.score(probe)
            assert t.is_warm(probe) == r.is_warm(probe)
            for li in range(LAYERS):
                np.testing.assert_array_equal(t.layer_prior(li, EXPERTS),
                                              r.layer_prior(li, EXPERTS))
    r, t = heats
    assert (len(t), t.requests_retired, t.observations) == \
        (len(r), r.requests_retired, r.observations)
    assert t._heat == r._heat


# --------------------------------------------------------------------------
# configs/base.py
# --------------------------------------------------------------------------
def _to_port(obj):
    """A reference config dataclass rebuilt, field by field, as the port's
    class of the same name."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(tbase, type(obj).__name__)
        return cls(**{f.name: _to_port(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_to_port(x) for x in obj)
    return obj


_DERIVED = ("resolved_head_dim", "body_layers", "period", "num_blocks", "tail_pattern",
            "tail_moe", "layer_kinds", "layer_is_moe", "is_sub_quadratic", "param_count",
            "active_param_count")


def _derived(cfg):
    out = {}
    for name in _DERIVED:
        v = getattr(cfg, name)
        out[name] = v() if callable(v) else v
    return out


@pytest.mark.parametrize("arch", sorted(rcfg.ARCHS))
def test_config_base_matches_reference(arch):
    ref = rcfg.get_config(arch)
    port = _to_port(ref).validate()
    _same(_derived(port), _derived(ref))
    for kw in ({}, dict(layers=4, d_model=128, vocab=256)):
        rs, ts = rbase.smoke_variant(ref, **kw), tbase.smoke_variant(port, **kw)
        _same(ts, rs)
        _same(_derived(ts), _derived(rs))
    _same({k: dataclasses.asdict(v) for k, v in tbase.INPUT_SHAPES.items()},
          {k: dataclasses.asdict(v) for k, v in rbase.INPUT_SHAPES.items()})


# --------------------------------------------------------------------------
# serving/workload.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 5])
def test_generate_workload_matches_reference(seed):
    want, got = _workload(rwork, seed), _workload(twork, seed)
    assert len(got) == 40
    _same(got, want)
    for a, b in zip(twork.to_requests(got, t0=3.0), rwork.to_requests(want, t0=3.0)):
        _same(vars(a), vars(b))
    for prio, wait in ((0, 0.0), (0, 12.5), (2, 3.0), (1, 40.0)):
        for ttft in (None, 1.5):
            assert twork.effective_priority(prio, 100.0 - wait, 100.0, 10.0) == \
                rwork.effective_priority(prio, 100.0 - wait, 100.0, 10.0)
            assert twork.slo_urgency(prio, 100.0 - wait, ttft, 100.0, 10.0) == \
                rwork.slo_urgency(prio, 100.0 - wait, ttft, 100.0, 10.0)
