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


def _record_prefetches(eng):
    """Record every prefetch job eng's synchronous loader is given."""
    jobs = []
    enqueue = eng.loader.enqueue_prefetch

    def spy(layer, experts, dec, *a, **kw):
        jobs.append((layer, list(experts), np.asarray(dec).tolist()))
        return enqueue(layer, experts, dec, *a, **kw)
    eng.loader.enqueue_prefetch = spy
    return jobs


def _predict_on_host(eng):
    """Turn eng's grouped path back to per-row host calls: each row's
    predictions come from ``predict_layers`` on the float32 hidden state
    its segment computed (read back on the CPU), not from the segment's
    probabilities."""
    hidden = {}
    attn, prefetch = eng._attn_segment, eng._prefetch_predictions

    def attn_segment(mi, x):
        x, h, h32 = attn(mi, x)
        hidden[mi] = h32.numpy().copy()
        return x, h, h32

    def prefetch_on_host(mi, rows, *, use_async, h_host=None, probs=None):
        return prefetch(mi, rows, use_async=use_async, h_host=hidden[mi])
    eng._attn_segment, eng._prefetch_predictions = attn_segment, prefetch_on_host


def test_segment_predictions_equal_per_row_host_calls(models):
    """The grouped path's predictor probabilities, computed for every row
    in each MoE layer's segment, equal ``predict_layers`` called per row on
    the segment's hidden state, and an engine that predicts through those
    per-row host calls makes the same predictions, prefetch jobs, trace and
    ``pred_accuracy`` (batch 4, 16 steps, synchronous loading).  The
    segment launches the stacked gating once per MoE layer but the last,
    and the predictor no call from the host."""
    from repro_torch.kernels import ops as kops
    cfg, _, _, port, tparams = models
    ecfg = EngineConfig(hi_slots=8, lo_slots=4, async_prefetch=False)
    seg, host = (OffloadEngine(port, tparams, ecfg) for _ in range(2))
    _predict_on_host(host)
    jobs = [_record_prefetches(e) for e in (seg, host)]
    probs_seen = []
    layer_probs = seg.predictor.layer_probs

    def spy(x, layer, p=None):
        out = layer_probs(x, layer, p)
        if out is not None:
            probs_seen.append((x.clone(), layer, out.clone()))
        return out
    seg.predictor.layer_probs = spy
    b, steps = 4, 16
    rng = np.random.default_rng(13)
    prompts = rng.integers(0, cfg.vocab_size, (b, 6))
    teacher = rng.integers(0, cfg.vocab_size, (steps, b))
    try:
        for e in (seg, host):
            e.start_batch(b, 32)
            e.prefill_batch(prompts)
        kops.reset_dispatch_counts()
        for t in range(steps):
            seg.decode_step_batch(teacher[t])
        launches = kops.dispatch_counts().get("stacked_gating.torch", 0)
        seg.predictor.layer_probs = layer_probs
        for t in range(steps):
            host.decode_step_batch(teacher[t])
        assert launches == len(probs_seen) == steps * (seg.num_moe_layers - 1)
        for x, layer, out in probs_seen:
            assert out.shape == (min(ecfg.prefetch_p, seg.num_moe_layers - 1 - layer), b,
                                 cfg.moe.num_experts)
            for r in range(b):
                assert torch.equal(out[:, r], layer_probs(x[r:r + 1], layer)[:, 0])
                for p in (None, 1):
                    want = seg.predictor.predict_layers(x[r].numpy(), layer, p)
                    got = seg.predictor.predict_layers(None, layer, p,
                                                       probs=out[:, r].numpy())
                    assert [(w.layer, w.experts) for w in want] == \
                        [(g.layer, g.experts) for g in got]
                    assert all(np.array_equal(w.gate_vals, g.gate_vals)
                               for w, g in zip(want, got))
        assert jobs[0] and jobs[0] == jobs[1]
        assert len(seg.trace) == len(host.trace) == steps * b
        for ra, rb_ in zip(seg.trace, host.trace):
            for a, c in zip(ra, rb_):
                assert a.experts == c.experts and a.pred_experts == c.pred_experts
                assert (a.pred_gate_vals is None) == (c.pred_gate_vals is None)
                if a.pred_gate_vals is not None:
                    assert np.array_equal(a.pred_gate_vals, c.pred_gate_vals)
        assert any(t.pred_experts for row in seg.trace for t in row)
        ss, hs = seg.stats(), host.stats()
        assert ss["pred_accuracy"] and ss["pred_accuracy"] == hs["pred_accuracy"]
        for key in ("loads_hi", "loads_lo", "loaded_bytes", "union_reloads"):
            assert ss[key] == hs[key], key
        assert ss["segment_predictions"] == steps * b * (seg.num_moe_layers - 1)
        # the check above called predict_layers from the host on seg
        # itself, once per row, layer and p
        assert ss["predictor_host_calls"] == 2 * len(probs_seen) * b
        assert hs["predictor_host_calls"] >= steps * b * (host.num_moe_layers - 1)
        assert hs["segment_predictions"] == 0
    finally:
        seg.close()
        host.close()


def test_segment_launches_no_predictor_gating_without_prefetch(models):
    """With prefetch off the grouped segment has no stacked-gating launch and
    nothing predicts."""
    from repro_torch.kernels import ops as kops
    cfg, _, _, port, tparams = models
    eng = OffloadEngine(port, tparams, EngineConfig(hi_slots=8, lo_slots=4,
                                                    async_prefetch=False, prefetch=False))
    rng = np.random.default_rng(17)
    try:
        eng.start_batch(4, 32)
        eng.prefill_batch(rng.integers(0, cfg.vocab_size, (4, 6)))
        kops.reset_dispatch_counts()
        for _ in range(4):
            eng.decode_step_batch(rng.integers(0, cfg.vocab_size, 4))
        counts = kops.dispatch_counts()
        assert counts["gating_topk.torch"] == 4 * eng.num_moe_layers
        assert counts.get("stacked_gating.torch", 0) == 0
        st = eng.stats()
        assert st["predictor_host_calls"] == st["segment_predictions"] == 0
        assert all(t.pred_experts is None for row in eng.trace for t in row)
    finally:
        eng.close()


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
