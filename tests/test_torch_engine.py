"""The port's OffloadEngine against the JAX reference engine on the trained
smoke checkpoints.

With ``async_prefetch=False`` the loader drains synchronously, so cache
state does not depend on timing and the two engines must agree on every
decision: per-step logits (atol 1e-4, float32 sums in another order), the
routed experts and their precision decisions, hi/lo load counts, cache
hit/miss counts and union-overflow reloads.  The default asynchronous
configuration is held to the dense model in the unconstrained setting
(every expert resident at full precision), atol 1e-3 as tests/test_api.py.
Every engine runs under the port's thread-confinement guard
(``core.cache_guard.InstrumentedCache``).  The per-expert path, host compute
mode and the single-sequence API are in test_torch_engine_modes.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from benchmarks.common import CACHE_DIR, bench_config
from repro.core import EngineConfig as RefEngineConfig
from repro.core import OffloadEngine as RefEngine
from repro.models import build_model as build_ref
from repro.serving.api import DenseBackend as RefDense
from repro.serving.api import HobbitBackend as RefHobbit
from repro.training import checkpoint as ckpt
from repro_torch.core import EngineConfig, OffloadEngine, Thresholds
from repro_torch.core import engine as engine_mod
from repro_torch.core.cache_guard import InstrumentedCache
from repro_torch.core.scoring import precision_decisions
from repro_torch.models import build_model
from repro_torch.serving.api import DenseBackend, HobbitBackend
from repro_torch.weights import from_jax_params, load_checkpoint

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def thread_confined_cache(monkeypatch):
    """Build every port engine's cache as an `InstrumentedCache`, which
    raises the moment a cache-metadata mutator runs off the serving thread
    (the staging engine's copy threads may only copy bytes)."""
    monkeypatch.setattr(engine_mod, "MultidimensionalCache", InstrumentedCache)
    yield


def _load(kind, capacity_factor=None):
    cfg = bench_config(kind)
    if capacity_factor is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    ref = build_ref(cfg)
    params, _ = ckpt.restore(f"{CACHE_DIR}/{kind}", ref.init(jax.random.PRNGKey(0)))
    port = build_model(cfg)
    tparams = from_jax_params(cfg, load_checkpoint(f"{CACHE_DIR}/{kind}"), device="cpu")
    return cfg, ref, params, port, tparams


@pytest.fixture(scope="module", params=["mixtral-smoke", "phi-smoke"])
def models(request):
    return _load(request.param)


def _decisions(trace, th):
    return [[precision_decisions(np.asarray(t.gate_vals), th).tolist() for t in row]
            for row in trace]


@pytest.mark.parametrize("slots", [(16, 8), (3, 2)], ids=["roomy", "overflow"])
def test_sync_engine_matches_reference(models, slots):
    cfg, ref, params, port, tparams = models
    hi, lo = slots
    kw = dict(hi_slots=hi, lo_slots=lo, async_prefetch=False)
    r_eng = RefEngine(ref, params, RefEngineConfig(**kw))
    t_eng = OffloadEngine(port, tparams, EngineConfig(**kw))
    rb, tb = RefHobbit(r_eng), HobbitBackend(t_eng)
    rng = np.random.default_rng(7)
    b, s, steps = 2, 8, 6
    prompts = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    teacher = rng.integers(0, cfg.vocab_size, (steps, b)).astype(np.int32)
    try:
        for be in (rb, tb):
            be.start_batch(b, 32)
        np.testing.assert_allclose(tb.prefill(prompts), rb.prefill(prompts), atol=1e-4)
        for t in range(steps):
            np.testing.assert_allclose(tb.step(teacher[t]), rb.step(teacher[t]),
                                       atol=1e-4)
        th = Thresholds(0.6, 0.9)
        assert [[e.experts for e in row] for row in t_eng.trace] == \
            [[e.experts for e in row] for row in r_eng.trace]
        assert _decisions(t_eng.trace, th) == _decisions(r_eng.trace, th)
        rs, ts = r_eng.stats(), t_eng.stats()
        for key in ("loads_hi", "loads_lo", "skips", "loaded_bytes", "union_reloads",
                    "expert_dispatches"):
            assert ts[key] == rs[key], key
        for key in ("hits_hi", "hits_lo", "misses_hi", "misses_lo", "evictions"):
            assert ts["cache"][key] == rs["cache"][key], key
        assert ts["loads_hi"] > 0 and ts["loads_lo"] > 0
        if slots == (3, 2):
            assert ts["union_reloads"] > 0
        counts = ts["kernel_dispatch"]
        for op in ("gating_topk", "stacked_gating", "grouped_dequant_matmul",
                   "grouped_dequant_combine"):
            assert counts.get(f"{op}.torch", 0) > 0, op
            assert f"{op}.cuda" not in counts
    finally:
        rb.close()
        tb.close()


def test_join_release_pause_resume_match_reference(models):
    """Mid-flight admission into a freed slot and pause/resume through the
    engine keep logits equal to the reference."""
    cfg, ref, params, port, tparams = models
    kw = dict(hi_slots=8, lo_slots=4, async_prefetch=False)
    rb = RefHobbit(RefEngine(ref, params, RefEngineConfig(**kw)))
    tb = HobbitBackend(OffloadEngine(port, tparams, EngineConfig(**kw)))
    rng = np.random.default_rng(11)
    p0, p1, p2 = (rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                  for n in (6, 9, 5))
    try:
        outs = []
        for be in (rb, tb):
            be.start_batch(2, 40)
            be.release(0)
            be.release(1)
            lg = [be.join(0, p0)]
            lg.append(be.step(np.asarray([3, 0], np.int32))[0])
            lg.append(be.join(1, p1))
            lg.append(be.step(np.asarray([5, 7], np.int32)))
            snap = be.pause(0)
            # another request overwrites the paused slot's KV rows
            lg.append(be.join(0, p2))
            lg.append(be.step(np.asarray([2, 9], np.int32)))
            be.release(0)
            be.resume(0, snap)
            lg.append(be.step(np.asarray([11, 13], np.int32)))
            outs.append(lg)
        for a, b in zip(*outs):
            np.testing.assert_allclose(b, a, atol=1e-4)
    finally:
        rb.close()
        tb.close()


def test_lo_pairs_per_launch_counts_every_grouped_launch(models):
    """stats()["lo_pairs_per_launch"]: one histogram entry per grouped lo
    launch pair — one per MoE layer and decode step, at the fixed pair
    count B * top_k, as the reference launches them — each the number of
    real (row, expert) pairs it carried (0 for a launch of pads only); the
    real pairs add up to the lo decisions of the trace."""
    from repro_torch.core.scoring import PREC_LO
    from repro_torch.kernels import ops as kops
    cfg, _, _, port, tparams = models
    eng = OffloadEngine(port, tparams, EngineConfig(hi_slots=3, lo_slots=2,
                                                    async_prefetch=False))
    tb = HobbitBackend(eng)
    rng = np.random.default_rng(3)
    steps = 4
    try:
        tb.start_batch(2, 32)
        kops.reset_dispatch_counts()
        tb.prefill(rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32))
        for _ in range(steps):
            tb.step(rng.integers(0, cfg.vocab_size, 2).astype(np.int32))
        st = eng.stats()
        lo = st["lo_pairs_per_launch"]
        launches = st["kernel_dispatch"].get("grouped_dequant_matmul.torch", 0)
        assert launches == steps * eng.num_moe_layers and lo["launches"] == launches
        assert st["kernel_dispatch"]["grouped_dequant_combine.torch"] == launches
        assert sum(lo["hist"].values()) == launches
        assert 0 <= lo["min"] <= lo["median"] <= lo["max"] <= 2 * cfg.moe.top_k
        assert lo["min"] == min(lo["hist"]) and lo["max"] == max(lo["hist"])
        lo_decisions = sum(int((precision_decisions(np.asarray(t.gate_vals),
                                                    eng.loader.th) == PREC_LO).sum())
                           for row in eng.trace for t in row)
        assert lo_decisions > 0
        assert sum(n * c for n, c in lo["hist"].items()) == lo_decisions
    finally:
        tb.close()


def test_hi_pairs_per_launch_counts_every_grouped_launch(models):
    """stats()["hi_pairs_per_launch"]: one histogram entry per MoE layer and
    decode step (the grouped hi product pair launches on every layer at
    the fixed pair count), each its real hi pairs, adding up to the hi
    decisions of the trace (synchronous loading: no downgrades)."""
    from repro_torch.core.scoring import PREC_HI
    from repro_torch.kernels import ops as kops
    cfg, _, _, port, tparams = models
    eng = OffloadEngine(port, tparams, EngineConfig(hi_slots=3, lo_slots=2,
                                                    async_prefetch=False))
    tb = HobbitBackend(eng)
    rng = np.random.default_rng(5)
    steps = 4
    try:
        tb.start_batch(2, 32)
        kops.reset_dispatch_counts()
        tb.prefill(rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32))
        for _ in range(steps):
            tb.step(rng.integers(0, cfg.vocab_size, 2).astype(np.int32))
        st = eng.stats()
        hi = st["hi_pairs_per_launch"]
        assert hi["launches"] == steps * eng.num_moe_layers == sum(hi["hist"].values())
        assert st["kernel_dispatch"]["grouped_matmul.torch"] == 2 * hi["launches"]
        assert 0 <= hi["min"] <= hi["median"] <= hi["max"] <= 2 * cfg.moe.top_k
        hi_decisions = sum(int((precision_decisions(np.asarray(t.gate_vals),
                                                    eng.loader.th) == PREC_HI).sum())
                           for row in eng.trace for t in row)
        assert hi_decisions > 0
        assert sum(n * c for n, c in hi["hist"].items()) == hi_decisions
    finally:
        tb.close()


def test_default_async_engine_matches_dense_unconstrained():
    """Default EngineConfig (async staging on two streams, measured link)
    with every expert resident at full precision equals the dense model —
    the port's and the reference's."""
    cfg, ref, params, port, tparams = _load("mixtral-smoke", capacity_factor=8.0)
    n = cfg.num_layers * cfg.moe.num_experts
    ecfg = EngineConfig(hi_slots=n, lo_slots=1, thresholds=Thresholds(1.0, 1.0),
                        prefetch=False)
    assert ecfg.async_prefetch
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    teacher = rng.integers(0, cfg.vocab_size, (4, 2)).astype(np.int32)
    dense, hob, rdense = (DenseBackend(port, tparams),
                          HobbitBackend(OffloadEngine(port, tparams, ecfg)),
                          RefDense(ref, params))
    try:
        for be in (dense, hob, rdense):
            be.start_batch(2, 32)
        lg_d, lg_h, lg_r = (be.prefill(prompts) for be in (dense, hob, rdense))
        np.testing.assert_allclose(lg_h, lg_d, atol=1e-3)
        np.testing.assert_allclose(lg_d, lg_r, atol=1e-4)
        for t in range(4):
            lg_d, lg_h, lg_r = (be.step(teacher[t]) for be in (dense, hob, rdense))
            np.testing.assert_allclose(lg_h, lg_d, atol=1e-3)
            np.testing.assert_allclose(lg_d, lg_r, atol=1e-4)
    finally:
        hob.close()
