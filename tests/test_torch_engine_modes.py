"""The port's per-expert reference path, host compute mode and
single-sequence API against the JAX reference.

On the trained smoke checkpoints (``_load`` of test_torch_engine.py) the
per-expert path (``grouped=False``) loads synchronously, so the two engines
must agree on every decision: per-step logits within atol 1e-4 (float32
sums in another order), the routed experts, their precision decisions, the
hi/lo load counts, cache hits and misses, and union-overflow reloads.  Host
compute mode is held to the reference's host mode (1e-4) and to the port's
device path (1e-3, as tests/test_engine.py).  The reference's own engine
tests (tests/test_engine.py) run on the port on the same float32
``smoke_variant`` init, carried over by ``weights.from_jax_params``.

Every engine built here runs under the port's thread-confinement guard
(``core.cache_guard.InstrumentedCache``), as the reference suite runs its
engines under the reference's (tests/conftest.py).
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_variant
from repro.core import EngineConfig as RefEngineConfig
from repro.core import OffloadEngine as RefEngine
from repro.models import build_model as build_ref
from repro.serving import api as ref_api
from repro_torch.core import PREC_HI, EngineConfig, OffloadEngine, Thresholds
from repro_torch.core import engine as engine_mod
from repro_torch.core.cache_guard import InstrumentedCache, ThreadConfinementError
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.serving import api
from repro_torch.weights import from_jax_params
from test_torch_engine import _decisions, _load

torch.set_num_threads(2)
GROUPED_OPS = ("gating_topk", "grouped_dequant_matmul", "grouped_dequant_combine")


@pytest.fixture(autouse=True)
def thread_confined_cache(monkeypatch):
    """Build every port engine's cache as an `InstrumentedCache`."""
    monkeypatch.setattr(engine_mod, "MultidimensionalCache", InstrumentedCache)
    yield


@pytest.fixture(scope="module", params=["mixtral-smoke", "phi-smoke"])
def models(request):
    return _load(request.param)


def _close_all(*backends):
    for be in backends:
        be.close()


# ------------------------------------------------- per-expert reference path
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("slots", [(16, 8), (3, 2)], ids=["roomy", "overflow"])
def test_per_expert_path_matches_reference(models, slots, paged):
    cfg, ref, params, port, tparams = models
    hi, lo = slots
    kw = dict(hi_slots=hi, lo_slots=lo, async_prefetch=False, grouped=False,
              paged_kv=paged)
    r_eng = RefEngine(ref, params, RefEngineConfig(**kw))
    t_eng = OffloadEngine(port, tparams, EngineConfig(**kw))
    rb, tb = ref_api.HobbitBackend(r_eng), api.HobbitBackend(t_eng)
    rng = np.random.default_rng(7)
    b, s, steps = 2, 8, 4
    prompts = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    teacher = rng.integers(0, cfg.vocab_size, (steps, b)).astype(np.int32)
    try:
        for be in (rb, tb):
            be.start_batch(b, 32)
        kops.reset_dispatch_counts()
        np.testing.assert_allclose(tb.prefill(prompts), rb.prefill(prompts), atol=1e-4)
        for t in range(steps):
            np.testing.assert_allclose(tb.step(teacher[t]), rb.step(teacher[t]),
                                       atol=1e-4)
        th = Thresholds(0.6, 0.9)
        assert [[e.experts for e in row] for row in t_eng.trace] == \
            [[e.experts for e in row] for row in r_eng.trace]
        assert _decisions(t_eng.trace, th) == _decisions(r_eng.trace, th)
        rs, ts = r_eng.stats(), t_eng.stats()
        for key in ("loads_hi", "loads_lo", "skips", "loaded_bytes", "union_reloads"):
            assert ts[key] == rs[key], key
        for key in ("hits_hi", "hits_lo", "misses_hi", "misses_lo", "evictions"):
            assert ts["cache"][key] == rs["cache"][key], key
        assert ts["loads_hi"] > 0 and ts["loads_lo"] > 0
        if slots == (3, 2):
            assert ts["union_reloads"] > 0
        # the per-expert path gates on the host and never uses the grouped
        # kernels or the staging engine
        counts = ts["kernel_dispatch"]
        assert counts.get("dequant_matmul.torch", 0) > 0
        assert counts.get("stacked_gating.torch", 0) > 0
        for op in GROUPED_OPS:
            assert counts.get(f"{op}.torch", 0) == 0, op
        assert ts["prefetch_jobs"] == 0 and ts["expert_dispatches"] == 0
        assert t_eng.pool_hi["wi"].shape[0] == hi and t_eng.pool_lo["wi_data"].shape[0] == lo
    finally:
        _close_all(rb, tb)


def _step_logits(port, tparams, ecfg, prompts, teacher):
    be = api.HobbitBackend(OffloadEngine(port, tparams, ecfg))
    try:
        be.start_batch(prompts.shape[0], 32)
        out = [be.prefill(prompts)]
        out += [be.step(teacher[t]) for t in range(teacher.shape[0])]
        return np.stack(out)
    finally:
        be.close()


def test_grouped_matches_per_expert_path_every_slot(models):
    """tests/test_grouped_decode.py:51 on the port: the grouped path (async
    staging, the grouped kernels' plain versions) reproduces the per-expert
    path's logits for every batch slot under mixed precision, a constrained
    cache and prefetch."""
    cfg, _, _, port, tparams = models
    ecfg = EngineConfig(hi_slots=6, lo_slots=4, thresholds=Thresholds(0.6, 0.9))
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, cfg.vocab_size, (4, 6))
    teacher = rng.integers(0, cfg.vocab_size, (5, 4))
    lg_g = _step_logits(port, tparams, ecfg, prompts, teacher)
    lg_r = _step_logits(port, tparams, dataclasses.replace(
        ecfg, grouped=False, async_prefetch=False), prompts, teacher)
    for slot in range(prompts.shape[0]):
        np.testing.assert_allclose(lg_g[:, slot], lg_r[:, slot], atol=1e-3)


# --------------------------------------------------------- host compute mode
@pytest.mark.parametrize("th", [(1.0, 1.0), (0.6, 0.9)], ids=["all_hi", "mixed"])
def test_host_mode_matches_reference_and_device(models, th):
    """compute_mode="host" against the reference's host mode (1e-4) and the
    port's device path (1e-3, tests/test_engine.py:84); the mixed setting
    computes lo experts from dequantized host codes."""
    cfg, ref, params, port, tparams = models
    toks = [int(t) for t in np.random.default_rng(5).integers(0, cfg.vocab_size, 6)]
    kw = dict(hi_slots=32, lo_slots=8, thresholds=Thresholds(*th), prefetch=False)
    host = OffloadEngine(port, tparams, EngineConfig(compute_mode="host", **kw))
    dev = OffloadEngine(port, tparams, EngineConfig(**kw))
    r_host = RefEngine(ref, params, RefEngineConfig(compute_mode="host", **kw))
    try:
        got = host.score_nll(toks)
        assert abs(got - r_host.score_nll(toks)) < 1e-4
        assert abs(got - dev.score_nll(toks)) < 1e-3
        assert host.stats()["loads_hi"] == r_host.stats()["loads_hi"]
        assert host.stats()["loads_lo"] == r_host.stats()["loads_lo"]
        if th == (0.6, 0.9):
            assert host.loader.n_loads[1] > 0
    finally:
        _close_all(host, dev, r_host)


# ------------------------------------------------------ single-sequence API
def test_generate_and_score_nll_match_reference(models):
    """engine.generate and engine.score_nll, and serving.api.score_nll through
    HobbitBackend and DenseBackend, against the reference's."""
    cfg, ref, params, port, tparams = models
    rng = np.random.default_rng(9)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 4)]
    toks = [int(t) for t in rng.integers(0, cfg.vocab_size, 6)]
    kw = dict(hi_slots=8, lo_slots=4, async_prefetch=False)
    t_eng = OffloadEngine(port, tparams, EngineConfig(**kw))
    r_eng = RefEngine(ref, params, RefEngineConfig(**kw))
    try:
        assert t_eng.generate(prompt, 4) == r_eng.generate(prompt, 4)
        assert abs(t_eng.score_nll(toks) - r_eng.score_nll(toks)) < 1e-4
        got = api.score_nll(api.HobbitBackend(t_eng), toks)
        assert abs(got - ref_api.score_nll(ref_api.HobbitBackend(r_eng), toks)) < 1e-4
    finally:
        _close_all(t_eng, r_eng)
    got = api.score_nll(api.DenseBackend(port, tparams), toks)
    assert abs(got - ref_api.score_nll(ref_api.DenseBackend(ref, params), toks)) < 1e-4


def test_decode_token_is_batch_one(models):
    _, _, _, port, tparams = models
    eng = OffloadEngine(port, tparams, EngineConfig(async_prefetch=False))
    try:
        eng.start_sequence(8, batch=2)
        with pytest.raises(ValueError, match="batch 1"):
            eng.decode_token(3)
    finally:
        eng.close()


def test_unknown_compute_mode_raises(models):
    _, _, _, port, tparams = models
    with pytest.raises(ValueError, match="compute_mode"):
        OffloadEngine(port, tparams, EngineConfig(compute_mode="gpu"))


def test_fetch_many_writes_all_slots(models):
    """tests/test_grouped_decode.py:138 on the port: every admitted slot is
    written and counted as loader traffic."""
    _, _, _, port, tparams = models
    eng = OffloadEngine(port, tparams, EngineConfig(hi_slots=8, lo_slots=4))
    try:
        eng.start_batch(1, 8)
        items = []
        for e in range(3):
            slot, _ = eng.cache.admit((0, e), True, 0)
            items.append((0, e, PREC_HI, slot))
        slot, _ = eng.cache.admit((1, 2), False, 0)
        items.append((1, 2, 1, slot))
        before_hi, before_lo = eng.loader.n_loads[PREC_HI], eng.loader.n_loads[1]
        eng._fetch_many(items)
        assert eng.loader.n_loads[PREC_HI] == before_hi + 3
        assert eng.loader.n_loads[1] == before_lo + 1
        for mi, e, prec, slot in items:
            if prec == PREC_HI:
                for n in ("wi", "wo"):
                    assert torch.equal(eng.pool_hi[n][slot], eng.storage_hi[mi][n][e])
            else:
                for n in ("wi_data", "wi_scale", "wo_data", "wo_scale"):
                    assert torch.equal(eng.pool_lo[n][slot], eng.storage_lo[mi][n][e])
    finally:
        eng.close()


# ------------------------------ tests/test_engine.py on the float32 smoke init
@pytest.fixture(scope="module")
def smoke():
    cfg = dataclasses.replace(
        smoke_variant(get_config("mixtral-8x7b"), layers=4, d_model=128, vocab=256),
        dtype="float32")
    params = build_ref(cfg).init(jax.random.PRNGKey(0))
    return build_model(cfg), from_jax_params(cfg, params, device="cpu")


def _model_nll(m, params, toks):
    """Teacher-forced NLL through the port's model decode (no engine)."""
    cache = m.init_cache(1, len(toks) + 1, "cpu")
    pos = torch.zeros((1,), dtype=torch.int64)
    nll, n = 0.0, 0
    lg = m.decode_step(params, cache, torch.tensor([[toks[0]]]), pos)
    for t in toks[1:]:
        p = lg[0].to(torch.float64).numpy()
        p = p - p.max()
        p = p - np.log(np.exp(p).sum())
        nll -= p[t]
        n += 1
        pos = pos + 1
        lg = m.decode_step(params, cache, torch.tensor([[t]]), pos)
    return nll / n


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "per_expert"])
def test_all_hi_engine_matches_model(smoke, grouped):
    m, params = smoke
    toks = [1, 5, 9, 13, 2, 7, 20, 33]
    eng = OffloadEngine(m, params, EngineConfig(
        hi_slots=32, lo_slots=1, thresholds=Thresholds(1.0, 1.0), prefetch=False,
        grouped=grouped))
    try:
        assert abs(eng.score_nll(toks) - _model_nll(m, params, toks)) < 1e-4
    finally:
        eng.close()


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "per_expert"])
def test_mixed_precision_close_but_not_identical(smoke, grouped):
    m, params = smoke
    toks = [1, 5, 9, 13, 2, 7, 20, 33, 40, 41]
    base = OffloadEngine(m, params, EngineConfig(
        hi_slots=32, lo_slots=1, thresholds=Thresholds(1.0, 1.0), prefetch=False,
        grouped=grouped))
    mixed = OffloadEngine(m, params, EngineConfig(
        hi_slots=32, lo_slots=32, thresholds=Thresholds(0.55, 1.0), prefetch=False,
        grouped=grouped))
    try:
        nb, nm = base.score_nll(toks), mixed.score_nll(toks)
        assert nm != nb                       # int4 substitution changes numerics
        assert abs(nm - nb) / nb < 0.15       # ... but only slightly
        assert mixed.loader.n_loads[1] > 0
    finally:
        _close_all(base, mixed)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "per_expert"])
def test_small_cache_thrashes_but_stays_correct(smoke, grouped):
    m, params = smoke
    toks = [1, 5, 9, 13]
    tiny = OffloadEngine(m, params, EngineConfig(
        hi_slots=2, lo_slots=1, thresholds=Thresholds(1.0, 1.0), prefetch=False,
        grouped=grouped))
    try:
        assert abs(tiny.score_nll(toks) - _model_nll(m, params, toks)) < 1e-4
        assert tiny.cache.stats.hit_ratio() < 0.6
    finally:
        tiny.close()


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_host_mode_matches_device_on_smoke_init(act):
    """tests/test_engine.py:84 (host vs device within 1e-3), also with the
    tanh GELU, and host mode against the reference's host mode."""
    cfg = dataclasses.replace(
        smoke_variant(get_config("mixtral-8x7b"), layers=4, d_model=128, vocab=256),
        dtype="float32", ffn_activation=act)
    ref = build_ref(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    m, tparams = build_model(cfg), from_jax_params(cfg, params, device="cpu")
    toks = [3, 8, 1, 4]
    kw = dict(hi_slots=32, lo_slots=8, thresholds=Thresholds(0.6, 1.0), prefetch=False)
    dev = OffloadEngine(m, tparams, EngineConfig(**kw))
    host = OffloadEngine(m, tparams, EngineConfig(compute_mode="host", **kw))
    r_host = RefEngine(ref, params, RefEngineConfig(compute_mode="host", **kw))
    try:
        got = host.score_nll(toks)
        assert abs(dev.score_nll(toks) - got) < 1e-3
        assert abs(r_host.score_nll(toks) - got) < 1e-4
    finally:
        _close_all(dev, host, r_host)


# ------------------------------------------------- the runtime thread guard
def test_instrumented_cache_fires_off_thread():
    """tests/test_analysis.py:301 on the port's guard."""
    c = InstrumentedCache(2, 2, 2)
    c.new_sequence()
    c.advance_token()
    assert ("new_sequence", threading.current_thread().name) in c.mutation_log
    caught = []

    def rogue():
        try:
            c.admit((0, 0), True, 1)
        except ThreadConfinementError as e:
            caught.append(e)

    t = threading.Thread(target=rogue, name="rogue-stager")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert caught and "rogue-stager" in str(caught[0])


def test_engine_tests_run_under_instrumented_cache(models):
    """tests/test_analysis.py:323 on the port: the autouse fixture patches
    the engine's constructor binding, so engines built here (async staging
    included) run under the guard."""
    assert engine_mod.MultidimensionalCache is InstrumentedCache
    cfg, _, _, port, tparams = models
    eng = OffloadEngine(port, tparams, EngineConfig(hi_slots=4, lo_slots=2))
    try:
        assert isinstance(eng.cache, InstrumentedCache)
        eng.generate([1, 2, 3], 3)
        assert len(eng.cache.mutation_log) > 0
        assert {t for _, t in eng.cache.mutation_log} == {threading.current_thread().name}
    finally:
        eng.close()
