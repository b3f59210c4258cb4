"""Captured steps on a CUDA card (marked ``cuda``; each test skips
without a card).  This file imports neither JAX nor the reference, so it
runs on the machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_capture_card.py

* ``DenseBackend(jit=True)`` on both KV layouts: the replayed step gives
  the eager step's logits bit for bit (the same kernels on the same
  inputs), one capture and then replays, and the kernel launch counts of
  the eager run (a replay adds its captured launches);
* the same for the SSM models (Mamba2-780m's and Jamba's smoke variants,
  bf16): the replayed step steps the state in the buffers it baked in,
  and slot 0 paused and resumed continues as the eager run does;
* ``start_batch`` drops the graphs with the buffers they bake in;
* ``CapturedStep`` around one kernel: replays agree with the plain version
  and count one launch each;
* a capture during which Python's cyclic collector would free a dead graph
  waiting in a reference cycle goes through (the collector is held off);
* the offload engine's grouped FFN (one graph for every MoE layer, fixed
  pair count B * top_k) on both KV layouts: every call after the first
  replays, and a replay on a fixed input equals the eager call bit for bit;
* ``ChunkedPrefill(jit=True)``: chunks after the first replay, and the
  logits and the pool's pages equal ``jit=False``'s bit for bit;
* the one-shot dense-KV prefill (``models.prefill.DenseKVPrefill``,
  "prefill"): a shape's first call runs eagerly, its second captures, and
  a replay after ``start_batch`` gives the eager prefill's logits and cache
  bit for bit; two prompt lengths alternated replay right though their
  graphs share one memory pool; joins into two slots replay one graph; at
  the graph bound a more frequent shape replaces the least-used graph (its
  outputs freed into the shared pool) and every call stays equal to eager;
* the engine's per-expert path: its segments and experts replay (never
  eager), and one segment's and one hi and one lo expert's replay on a
  fixed input equal the eager calls bit for bit; the expert graphs outlive
  ``start_batch``;
* ``kops.grouped_matmul`` against its plain version (rtol/atol 1e-4:
  float32 sums in another order), pads and shared slots, the 1024-pair
  maximum, 9 and 17 pairs on one slot, K off the ring's 64-row stage and
  ragged N, bf16 and float32, two calls bit-identical.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch import capture
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import PREC_HI, PREC_LO, EngineConfig, OffloadEngine, Thresholds
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model
from repro_torch.models.kv_pages import ChunkedPrefill
from repro_torch.models.prefill import DenseKVPrefill
from repro_torch.serving import api


def _granite():
    cfg = smoke_variant(get_config("granite-3-2b"), layers=2, d_model=256, vocab=512)
    return build_model(dataclasses.replace(cfg, dtype="bfloat16"))


def _prompts(cfg, b=2, s=6, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# --------------------------------------------------------------------------
# on a card: replay against eager, launch counts, graphs dropped
# --------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: chip_smoke.py runs these paths on the H100")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense-kv", "paged-kv"])
def test_dense_backend_replay_equals_eager_on_card(card, paged):
    port = _granite()
    params = port.init(0, device=card)
    logits = {}
    for jit in (True, False):
        be = api.DenseBackend(port, params, jit=jit, paged=paged)
        be.start_batch(2, 24)
        ops.reset_dispatch_counts()
        out = [be.prefill(_prompts(port.cfg))]
        out += [be.step(np.asarray([t, t + 1])) for t in range(5)]
        logits[jit] = np.stack(out), ops.dispatch_counts()
    np.testing.assert_array_equal(logits[True][0], logits[False][0])
    counts = logits[True][1]
    assert counts["serve_step.capture"] == 1 and counts["serve_step.graph"] == 4
    assert "serve_step.eager" not in counts
    # paged: the prefill's one chunk is the captured chunk step's warm-up
    assert counts.get("prefill_chunk.capture", 0) == (1 if paged else 0)
    assert "prefill_chunk.eager" not in counts
    # dense: the one-shot prefill's first call of a shape runs eagerly
    assert counts.get("prefill.eager", 0) == (0 if paged else 1)
    assert "prefill.capture" not in counts
    kernels = {k: v for k, v in counts.items()
               if not k.startswith(("serve_step.", "prefill_chunk.", "prefill."))}
    assert kernels == logits[False][1]          # launches grow on every replay


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b"])
def test_ssm_backend_replay_equals_eager_on_card(card, arch):
    cfg = smoke_variant(get_config(arch), d_model=256, vocab=512)
    port = build_model(dataclasses.replace(cfg, dtype="bfloat16"))
    params = port.init(0, device=card)
    logits = {}
    for jit in (True, False):
        be = api.DenseBackend(port, params, jit=jit)
        be.start_batch(2, 48)
        ops.reset_dispatch_counts()
        out = [be.prefill(_prompts(port.cfg, s=37))]
        for t in range(8):
            if t == 3:
                snap = be.pause(0)
            if t == 5:
                be.resume(0, snap)
            out.append(be.step(np.asarray([t, t + 1])))
        logits[jit] = np.stack(out), ops.dispatch_counts()
    np.testing.assert_array_equal(logits[True][0], logits[False][0])
    counts = logits[True][1]
    assert counts["serve_step.capture"] == 1 and counts["serve_step.graph"] == 7
    assert "serve_step.eager" not in counts


@pytest.mark.cuda
def test_start_batch_drops_the_graphs_on_card(card):
    port = _granite()
    be = api.DenseBackend(port, port.init(0, device=card), paged=True)
    be.start_batch(2, 24)
    be.prefill(_prompts(port.cfg))
    be.step(np.asarray([1, 2]))
    be.step(np.asarray([3, 4]))
    assert be._step.graphs == 1
    be.start_batch(2, 24)
    assert be._step.graphs == 0


@pytest.mark.cuda
def test_captured_step_counts_launches_on_replay(card):
    from repro_torch.kernels import ref
    x = torch.randn(4, 256, device=card, dtype=torch.bfloat16)
    gates = torch.randn(1, 256, 8, device=card)
    step = capture.CapturedStep(lambda a: ops.gating_topk(a, gates, top_k=2), "probe")
    ops.reset_dispatch_counts()
    outs = [tuple(t.clone() for t in step(x)) for _ in range(3)]
    assert ops.dispatch_counts() == {"probe.capture": 1, "probe.graph": 2,
                                     "gating_topk.cuda": 3}
    want = ref.gating_topk_ref(x.cpu(), gates.cpu(), top_k=2)
    for out in outs:
        for got, w in zip(out, want):
            torch.testing.assert_close(got.cpu(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_capture_survives_a_dead_graph_in_a_reference_cycle(card):
    """A dead CapturedStep whose graph only the cyclic collector can free
    waits in a reference cycle, and the step captured next allocates enough
    containers during its capture to start an automatic collection there.
    ``CapturedStep._capture`` holds the collector off for the capture (a
    pass that destroys a graph mid-capture invalidates it), so the capture
    goes through, replays, and the dead graph is freed afterwards."""
    x = torch.randn(64, device=card)
    held = []

    def busy(t):
        if torch.cuda.is_current_stream_capturing():
            held.append([[] for _ in range(20000)])   # an automatic pass's worth
        return t * 2 + 1

    threshold = gc.get_threshold()
    gc.collect()
    try:
        gc.set_threshold(10 ** 9)       # no automatic pass while the cycle is made
        dead = capture.CapturedStep(lambda t: t + 1, "dead_step")
        dead(x)
        dead(x)
        assert dead.graphs == 1
        cycle = {"step": dead}
        cycle["self"] = cycle
        alive = weakref.ref(dead)
        del dead, cycle
        assert alive() is not None      # reachable from nothing but a cycle
        # the next automatic pass starts 2000 allocations from here: inside
        # the capture, after the warm-up
        gc.set_threshold(gc.get_count()[0] + 2000)
        live = capture.CapturedStep(busy, "live_step")
        ops.reset_dispatch_counts()
        first = live(x).clone()
        again = live(x).clone()
        torch.cuda.synchronize()
        assert ops.dispatch_counts() == {"live_step.capture": 1, "live_step.graph": 1}
        assert held, "the capture did not run the step"
        torch.testing.assert_close(first, x * 2 + 1)
        assert torch.equal(again, first)
        [[] for _ in range(5000)]
        assert alive() is None          # freed by an automatic pass after the capture
    finally:
        gc.set_threshold(*threshold)
        gc.collect()


def _mixtral():
    cfg = smoke_variant(get_config("mixtral-8x7b"), layers=2, d_model=256, vocab=512)
    return build_model(dataclasses.replace(cfg, dtype="bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense-kv", "paged-kv"])
def test_engine_ffn_replay_equals_eager_on_card(card, paged):
    port = _mixtral()
    eng = OffloadEngine(port, port.init(0, device=card), EngineConfig(
        hi_slots=3, lo_slots=2, async_prefetch=False, paged_kv=paged))
    hob = api.HobbitBackend(eng)
    rng = np.random.default_rng(1)
    steps = 4
    try:
        hob.start_batch(2, 32)
        ops.reset_dispatch_counts()
        hob.prefill(_prompts(port.cfg))
        for _ in range(steps):
            hob.step(rng.integers(0, port.cfg.vocab_size, 2))
        counts = ops.dispatch_counts()
        calls = steps * eng.num_moe_layers
        assert counts["engine_ffn.capture"] == 1 and counts["engine_ffn.graph"] == calls - 1
        assert "engine_ffn.eager" not in counts and eng._ffn_step.graphs == 1
        assert counts["grouped_matmul.cuda"] == 2 * calls
        assert counts["grouped_dequant_combine.cuda"] == calls
        g = torch.Generator(device=card).manual_seed(2)
        hs = torch.randn((2, port.cfg.d_model), generator=g, device=card).to(torch.bfloat16)
        x = torch.randn((2, 1, port.cfg.d_model), generator=g, device=card).to(torch.bfloat16)
        replay = eng._ffn_step(hs, x, key=eng._ffn_key()).clone()
        assert ops.dispatch_counts()["engine_ffn.graph"] == calls
        eager = eng._ffn(hs, x)
        assert torch.equal(replay, eager)
    finally:
        hob.close()


@pytest.mark.cuda
def test_chunked_prefill_replay_equals_eager_on_card(card):
    port = _granite()
    params = port.init(0, device=card)
    prompts = np.random.default_rng(4).integers(0, port.cfg.vocab_size, (2, 20))
    runs = {}
    for jit in (True, False):
        pool = port.init_cache(2, 40, card, paged=True, page_size=16)
        adm = ChunkedPrefill(port, params, pool, chunk=4, jit=jit)
        ops.reset_dispatch_counts()
        runs[jit] = adm.run_batch(prompts, 40), pool, ops.dispatch_counts()
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    for a, b in zip((*runs[True][1].k, *runs[True][1].v), (*runs[False][1].k, *runs[False][1].v)):
        assert torch.equal(a, b)
    counts = runs[True][2]
    assert counts["prefill_chunk.capture"] == 1 and counts["prefill_chunk.graph"] == 4
    assert "prefill_chunk.eager" not in counts
    kernels = {k: v for k, v in counts.items() if not k.startswith("prefill_chunk.")}
    assert kernels == runs[False][2]


def _dense_calls(port, params, jit, calls):
    """DenseBackend(jit=jit) on dense KV through `calls`, a list of
    ("start", batch) / ("prefill", prompts) / ("join", slot, prompt):
    each prefill's and join's logits and a copy of the cache after it, and
    the launch counts."""
    be = api.DenseBackend(port, params, jit=jit)
    ops.reset_dispatch_counts()
    out = []
    for call in calls:
        if call[0] == "start":
            be.start_batch(call[1], 24)
            continue
        lg = be.prefill(call[1]) if call[0] == "prefill" else be.join(call[1], call[2])
        out.append((lg, [{n: b.clone() for n, b in c.items()} for c in be.cache]))
    return be, out, ops.dispatch_counts()


def _assert_same_runs(got, want):
    for (lg, cache), (lg0, cache0) in zip(got, want):
        np.testing.assert_array_equal(lg, lg0)
        for c, c0 in zip(cache, cache0):
            for name in c0:
                assert torch.equal(c[name], c0[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-2b", "jamba-v0.1-52b"])
def test_prefill_replay_after_start_batch_equals_eager_on_card(card, arch):
    """Three prefills of one shape, a start_batch before each: the first
    runs eagerly, the second captures, the third replays; each writes the
    eager prefill's logits and cache bit for bit, with the eager run's
    launches."""
    cfg = smoke_variant(get_config(arch), d_model=256, vocab=512)
    port = build_model(dataclasses.replace(cfg, dtype="bfloat16"))
    params = port.init(0, device=card)
    calls = []
    for seed in range(3):
        calls += [("start", 2), ("prefill", _prompts(port.cfg, s=9, seed=seed))]
    be, got, counts = _dense_calls(port, params, True, calls)
    _, want, eager = _dense_calls(port, params, False, calls)
    _assert_same_runs(got, want)
    assert counts["prefill.eager"] == 1 and counts["prefill.capture"] == 1
    assert counts["prefill.graph"] == 1
    assert be._prefill.step.graphs == 1
    assert {k: v for k, v in counts.items() if not k.startswith("prefill.")} == eager


@pytest.mark.cuda
def test_prefill_lengths_alternated_share_a_pool_on_card(card):
    """Two prompt lengths alternated: two graphs in one memory pool, each
    replay right (each call reads its outputs before the next replays),
    and joins of one length into two slots replay one graph."""
    port = _granite()
    params = port.init(0, device=card)
    calls = [("start", 2)]
    for i in range(7):      # 11, 6: eager, then captured, then replayed
        calls.append(("prefill", _prompts(port.cfg, s=6 if i % 2 else 11, seed=i)))
    calls += [("join", i % 2, _prompts(port.cfg, b=1, s=5, seed=7 + i)[0]) for i in range(4)]
    be, got, counts = _dense_calls(port, params, True, calls)
    _, want, _ = _dense_calls(port, params, False, calls)
    _assert_same_runs(got, want)
    assert counts["prefill.eager"] == 3 and counts["prefill.capture"] == 3
    assert counts["prefill.graph"] == 5
    assert be._prefill.step.graphs == 3


@pytest.mark.cuda
def test_prefill_graph_bound_on_card(card, monkeypatch):
    """With room for two graphs, a third shape asked for more than twice as
    often as a held one's is captured and the least-used graph dropped (its
    static outputs freed into the shared pool, where the next capture may
    reuse them); every call, replays after the drop included, equals
    eager."""
    monkeypatch.setattr(DenseKVPrefill, "MAX_GRAPHS", 2)
    port = _granite()
    params = port.init(0, device=card)
    lens = [7, 7, 9, 9, 11, 11, 11, 11, 11, 9, 7, 11]
    calls = [("start", 2)] + [("prefill", _prompts(port.cfg, s=n, seed=i))
                              for i, n in enumerate(lens)]
    be, got, counts = _dense_calls(port, params, True, calls)
    _, want, _ = _dense_calls(port, params, False, calls)
    _assert_same_runs(got, want)
    held = {k[0][0][0][1] for k in be._prefill.step._graphs}
    # 7 and 9 captured on their second calls; 11 eager until its fifth
    # call, which replaces 7's graph (two calls); 9 replays after the drop;
    # 7's third call is not twice 9's (eager); 11 replays
    pf = {k: v for k, v in counts.items() if k.startswith("prefill.")}
    assert pf == {"prefill.eager": 7, "prefill.capture": 3, "prefill.graph": 2}
    assert held == {9, 11}


@pytest.mark.cuda
def test_per_expert_path_replays_equal_eager_on_card(card):
    """The per-expert path on the card: every segment and expert call after
    the first of its key replays a graph, none runs eagerly, and a
    replayed segment, hi expert and lo expert equal the eager calls on the
    same input bit for bit; start_batch keeps the expert graphs."""
    port = _mixtral()
    # rank 0 hi, rank 1 lo in every row: both expert steps replay
    eng = OffloadEngine(port, port.init(0, device=card), EngineConfig(
        hi_slots=3, lo_slots=2, async_prefetch=False, grouped=False,
        thresholds=Thresholds(0.0, 1.0)))
    hob = api.HobbitBackend(eng)
    rng = np.random.default_rng(3)
    try:
        hob.start_batch(2, 32)
        hob.prefill(_prompts(port.cfg))
        ops.reset_dispatch_counts()
        for _ in range(6):
            hob.step(rng.integers(0, port.cfg.vocab_size, 2))
        counts = ops.dispatch_counts()
        for name in ("engine_attn0", "engine_attn1", "engine_hi", "engine_lo",
                     "engine_embed", "engine_logits"):
            assert counts.get(f"{name}.graph", 0) > 0, name
            assert f"{name}.eager" not in counts, name
        g = torch.Generator(device=card).manual_seed(5)
        x = torch.randn((2, 1, port.cfg.d_model), generator=g, device=card).to(torch.bfloat16)
        key = eng._segment_key(eng.moe_layers[0])
        replay = [t.clone() for t in eng._attn_steps[0](x, key=key)]
        eager = eng._attn_segment(0, x)
        for a, b in zip(replay, eager):
            assert torch.equal(a, b)
        h = eager[1][:1]
        for prec, fn in ((PREC_HI, eng._hi_expert), (PREC_LO, eng._lo_expert)):
            slot = next(s for p, s in eng._expert_steps if p == prec)
            before = ops.dispatch_counts()
            pool = eng.pool_hi if prec == PREC_HI else eng.pool_lo
            got = eng._expert_step(prec, slot)(h, key=capture.addresses(pool.values())).clone()
            name = "engine_hi" if prec == PREC_HI else "engine_lo"
            assert ops.dispatch_counts()[f"{name}.graph"] == before[f"{name}.graph"] + 1
            assert torch.equal(got, fn(slot, h))
        # the expert graphs outlive start_batch (the pools stay)
        held = {k: (st, st.graphs) for k, st in eng._expert_steps.items()}
        hob.start_batch(2, 32)
        assert {k: (st, st.graphs) for k, st in eng._expert_steps.items()} == held
    finally:
        hob.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k,n,slots", [
    (64, 256, [0]), (1000, 264, [1, 1]), (3000, 512, [0, 2, 2, 2, 2, 2, 2, 2]),
    (4096, 512, [4, 0, 4, 1, 2, 2, 3, 0, 5, 5, 1]), (512, 128, [3] * 9),
    (192, 200, np.random.default_rng(3).integers(0, 40, 1024).tolist()), (520, 136, [5] * 17),
    (72, 72, [0, 1, 0])],
    ids=["one pair", "2 on 1 slot, ragged", "8 pairs 6 pads", "P=11 shared", "9 on 1 slot",
         "1024 pairs", "17 on 1 slot, ragged", "K off the ring's tile"])
def test_grouped_matmul_equals_plain_on_card(card, dtype, k, n, slots):
    g = torch.Generator(device=card).manual_seed(k + n)
    dt = getattr(torch, dtype)
    x = torch.randn((len(slots), k), generator=g, device=card).to(dt)
    w = (torch.randn((max(slots) + 1, k, n), generator=g, device=card) * 0.05).to(dt)
    slot = torch.tensor(slots, dtype=torch.int32, device=card)
    ops.reset_dispatch_counts()
    got = ops.grouped_matmul(x, w, slot)
    again = ops.grouped_matmul(x, w, slot)
    torch.cuda.synchronize()
    assert ops.dispatch_counts() == {"grouped_matmul.cuda": 2}
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref.grouped_matmul_ref(x, w, slot), rtol=1e-4, atol=1e-4)
