"""The captured one-shot dense-KV prefill and the engine's captured
per-expert path against the JAX reference, on the CPU (where a captured
step runs eagerly).

* ``Model.prefill_entries`` + ``Model.write_cache`` (what
  ``models.prefill.DenseKVPrefill`` runs, the first part captured per
  repeated prompt shape on the card) on
  the smoke model of every decoder family the backends serve on dense KV
  (all-attention MoE, windowed rings with ``make_mask`` / ``chunked_mha``,
  MLA latents, Mamba-2 SSD states, the Jamba hybrid), float32, prompts
  shorter and longer than the rings: the logits and every cache buffer
  equal the reference's jitted ``make_prefill_step`` within
  tests/test_kernels.py's float32 tolerances (rtol 1e-5, atol 1e-4), and
  ``Model.prefill`` copied into the cache bit for bit, over a cache filled
  with garbage first (the zeros past the prompt are written).  Through
  ``DenseBackend``: a full-batch prefill, then a join into slot 1 after it
  was released and stepped (its SSM state overwritten), slot 0 untouched;
  on the all-attention MoE model the offload engine's ``prefill_batch`` and
  join too.
* The prefill's graph key is the prompt's shape alone: not max_len, the
  slot or a cache address, and ``start_batch`` never drops its graphs.
  Which calls capture (a shape's second call), replay, run eagerly (a
  shape's first call, a prompt past ``MAX_TOKENS``, a shape asked for at
  most twice as often as every held graph's) or replace the least-used
  graph (at ``MAX_GRAPHS``, captured before the old one is dropped).
* The per-expert path (``grouped=False``) with its captured segments,
  experts, embedding and logits (``engine_attn<i>``, ``engine_hi``,
  ``engine_lo``, ``engine_embed``, ``engine_logits``: one eager call each
  here) against the reference engine's per-expert step, as
  tests/test_torch_engine_modes.py holds it: logits within atol 1e-4, the
  same routes, precision decisions, loads and cache counters.  The expert
  steps outlive ``start_batch`` and go only when the pools are
  reallocated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant
from repro.core import EngineConfig as RefEngineConfig
from repro.core import OffloadEngine as RefEngine
from repro.models import build_model as build_ref
from repro.models.model import Batch as RefBatch
from repro.serving import api as ref_api
from repro.serving import decode as ref_decode
from repro_torch import capture
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import PREC_HI, PREC_LO, EngineConfig, OffloadEngine, Thresholds
from repro_torch.core import engine as engine_mod
from repro_torch.core.cache_guard import InstrumentedCache
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.prefill import DenseKVPrefill
from repro_torch.serving import api
from repro_torch.weights import from_jax_params
from test_torch_engine import _decisions, _load

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-4)        # tests/test_kernels.py, float32
MAX_LEN = 16
WINDOW = 8                              # the rings wrap at the longer prompt
PROMPT_LENS = (5, 11)                   # shorter and longer than the rings

# family -> (arch, smoke_variant arguments, d_ff 0 as published)
FAMILIES = {
    "moe-attn": ("mixtral-8x7b", dict(layers=2, d_model=64, vocab=128), False),
    "windowed": ("gemma2-27b", dict(layers=2, d_model=64), False),
    "chunked-moe": ("llama4-scout-17b-a16e", dict(layers=4, d_model=64), False),
    "mla": ("deepseek-v2-236b", dict(d_model=64), False),
    "mamba2": ("mamba2-780m", dict(d_model=64), True),
    "jamba": ("jamba-v0.1-52b", dict(d_model=64), False),
}


@pytest.fixture(autouse=True)
def thread_confined_cache(monkeypatch):
    """Build every port engine's cache as an `InstrumentedCache`."""
    monkeypatch.setattr(engine_mod, "MultidimensionalCache", InstrumentedCache)
    yield


def _smoke(family, get, smoke):
    arch, kw, no_ffn = FAMILIES[family]
    cfg = dataclasses.replace(smoke(get(arch), **kw), dtype="float32", window_size=WINDOW)
    if no_ffn:
        cfg = dataclasses.replace(cfg, d_ff=0)
    if cfg.moe is not None:     # no token dropped: the dense dispatch at any batch
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg.validate()


_MODELS = {}


def _family(family):
    """(reference model, its params, port model, the same params in the port)."""
    if family not in _MODELS:
        ref = build_ref(_smoke(family, ref_get_config, ref_smoke_variant))
        port = build_model(_smoke(family, get_config, smoke_variant))
        params = ref.init(jax.random.PRNGKey(list(FAMILIES).index(family)))
        tparams = from_jax_params(port.cfg, jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu")
        _MODELS[family] = ref, params, port, tparams
    return _MODELS[family]


def _ref_prefill(ref, params, prompts):
    """The reference's jitted prefill: last logits and its cache flattened
    to one {name: array} per layer, in the port's layer order."""
    b, s = prompts.shape
    lg, cache, _ = jax.jit(ref_decode.make_prefill_step(ref, MAX_LEN))(
        params, RefBatch(tokens=jnp.asarray(prompts, jnp.int32), loss_mask=jnp.ones((b, s))))
    cfg = ref.cfg
    flat = [dict(c) for c in cache["prefix"]]
    for bi in range(cfg.num_blocks):
        flat += [{k: v[bi] for k, v in cache["blocks"][j].items()} for j in range(cfg.period)]
    flat += [dict(c) for c in cache["tail"]]
    return np.asarray(lg), [{k: np.asarray(v) for k, v in c.items()} for c in flat]


def _today(port, tparams, prompts, batch, slot=None):
    """``Model.prefill`` copied into a zeroed cache of `batch` rows, as the
    backends did it before the split (every row, or one prompt into row
    `slot`)."""
    lg, fresh, _ = port.prefill(tparams, torch.from_numpy(prompts), MAX_LEN)
    cache = port.init_cache(batch, MAX_LEN, "cpu")
    for dst, src in zip(cache, fresh):
        for name, buf in dst.items():
            (buf if slot is None else buf[slot]).copy_(src[name] if slot is None
                                                       else src[name][0])
    return lg.numpy(), cache


def _garbage(cache, seed):
    g = torch.Generator().manual_seed(seed)
    for c in cache:
        for buf in c.values():
            buf.copy_(torch.randn(buf.shape, generator=g))


def _assert_caches_equal(got, want):
    assert [set(c) for c in got] == [set(c) for c in want]
    for li, (a, b) in enumerate(zip(got, want)):
        for name in b:
            assert torch.equal(a[name], b[name]), f"layer {li} {name}"


@pytest.mark.parametrize("prompt_len", PROMPT_LENS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_split_prefill_equals_reference_and_model_prefill(family, prompt_len):
    """The split prefill over a garbage-filled cache gives Model.prefill's
    logits and cache bit for bit, and the reference's within TOL; the
    DenseBackend's prefill (captured step, eager here) writes the same."""
    ref, params, port, tparams = _family(family)
    prompts = np.random.default_rng(prompt_len).integers(
        0, port.cfg.vocab_size, (2, prompt_len)).astype(np.int64)
    lg_r, cache_r = _ref_prefill(ref, params, prompts)
    lg_0, cache_0 = _today(port, tparams, prompts, 2)

    lg, entries = port.prefill_entries(tparams, torch.from_numpy(prompts))
    cache = port.init_cache(2, MAX_LEN, "cpu")
    _garbage(cache, prompt_len)
    port.write_cache(cache, entries, prompt_len, MAX_LEN)
    assert torch.equal(lg, torch.from_numpy(lg_0))
    _assert_caches_equal(cache, cache_0)

    np.testing.assert_allclose(lg.numpy(), lg_r, **TOL)
    for li, (c, cr) in enumerate(zip(cache, cache_r)):
        assert set(c) == set(cr), li
        for name, buf in c.items():
            np.testing.assert_allclose(buf.numpy(), cr[name], **TOL,
                                       err_msg=f"layer {li} {name}")

    be = api.DenseBackend(port, tparams, jit=True)
    be.start_batch(2, MAX_LEN)
    ops.reset_dispatch_counts()
    np.testing.assert_array_equal(be.prefill(prompts), lg_0)
    assert ops.dispatch_counts()["prefill.eager"] == 1
    _assert_caches_equal(be.cache, cache_0)
    np.testing.assert_array_equal(be.positions, [prompt_len] * 2)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_join_into_a_dead_row(family):
    """Slot 1 released and stepped on (an SSM layer steps a dead row's
    state), then a join of a 3-token prompt into it: row 1 of every buffer
    equals Model.prefill's cache for that prompt copied in (the reference's
    within TOL), zeros past the prompt; row 0 is untouched."""
    ref, params, port, tparams = _family(family)
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, port.cfg.vocab_size, (2, 6))
    join = rng.integers(0, port.cfg.vocab_size, 3)
    be = api.DenseBackend(port, tparams, jit=True)
    be.start_batch(2, MAX_LEN)
    be.prefill(prompts)
    be.step(np.asarray([1, 2]))
    be.release(1)
    be.step(np.asarray([3, 4]))
    row0 = [{n: buf[0].clone() for n, buf in c.items()} for c in be.cache]
    ops.reset_dispatch_counts()
    lg = be.join(1, join)
    assert ops.dispatch_counts()["prefill.eager"] == 1
    lg_0, cache_0 = _today(port, tparams, join[None], 2, slot=1)
    np.testing.assert_array_equal(lg, lg_0[0])
    for c, c0, r0 in zip(be.cache, cache_0, row0):
        for name, buf in c.items():
            assert torch.equal(buf[1], c0[name][1]), name
            assert torch.equal(buf[0], r0[name]), name
    lg_r, cache_r = _ref_prefill(ref, params, join[None])
    np.testing.assert_allclose(lg, lg_r[0], **TOL)
    for c, cr in zip(be.cache, cache_r):
        for name, buf in c.items():
            np.testing.assert_allclose(buf[1].numpy(), cr[name][0], **TOL, err_msg=name)


def test_engine_dense_kv_prefill_and_join_equal_model_prefill():
    """The offload engine's dense-KV prefill_batch and join write what
    Model.prefill copied in writes, bit for bit, and return its logits."""
    _, _, port, tparams = _family("moe-attn")
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, port.cfg.vocab_size, (2, 7))
    join = rng.integers(0, port.cfg.vocab_size, 4)
    n = port.cfg.num_layers * port.cfg.moe.num_experts
    eng = OffloadEngine(port, tparams, EngineConfig(
        hi_slots=n, lo_slots=1, thresholds=Thresholds(1.0, 1.0), prefetch=False))
    try:
        eng.start_batch(2, MAX_LEN)
        ops.reset_dispatch_counts()
        lg = eng.prefill_batch(prompts)
        lg_0, cache_0 = _today(port, tparams, prompts, 2)
        np.testing.assert_array_equal(lg, lg_0)
        _assert_caches_equal(eng.kv_cache, cache_0)
        lg = eng.join(1, join)
        _, one = _today(port, tparams, join[None], 2, slot=1)
        for c, c0, c1 in zip(eng.kv_cache, cache_0, one):
            for name, buf in c.items():
                assert torch.equal(buf[1], c1[name][1]) and torch.equal(buf[0], c0[name][0])
        np.testing.assert_array_equal(eng.positions, [7, 4])
        assert ops.dispatch_counts()["prefill.eager"] == 2
    finally:
        eng.close()


# --------------------------------------------------------------------------
# the prefill's key
# --------------------------------------------------------------------------
def test_prefill_key_is_the_prompt_shape_alone(monkeypatch):
    """Across two max_lens, start_batch, both slots and both backends, every
    prefill's graph key is the prompt's shape (with dtype and device)
    alone, the same for the same shape and different for another; no
    prefill step is ever reset."""
    keys, resets = [], []
    run, reset = DenseKVPrefill._run, capture.CapturedStep.reset

    def spy_run(self, tokens):
        keys.append((id(self.step), self.step.graph_key(tokens)))
        return run(self, tokens)

    def spy_reset(self):
        resets.append(self.name)
        return reset(self)

    monkeypatch.setattr(DenseKVPrefill, "_run", spy_run)
    monkeypatch.setattr(capture.CapturedStep, "reset", spy_reset)
    _, _, port, tparams = _family("moe-attn")
    rng = np.random.default_rng(2)
    eng = OffloadEngine(port, tparams, EngineConfig(prefetch=False, async_prefetch=False))
    try:
        for be in (api.DenseBackend(port, tparams), api.HobbitBackend(eng)):
            for max_len in (MAX_LEN, 2 * MAX_LEN):
                be.start_batch(2, max_len)
                be.prefill(rng.integers(0, port.cfg.vocab_size, (2, 5)))
                for slot in (0, 1):
                    be.join(slot, rng.integers(0, port.cfg.vocab_size, 3))
    finally:
        eng.close()
    assert len(keys) == 2 * 2 * 3 and "prefill" not in resets and resets
    batch_key = ((((2, 5), torch.int64, torch.device("cpu")),), ())
    join_key = ((((1, 3), torch.int64, torch.device("cpu")),), ())
    for i, (_, k) in enumerate(keys):
        assert k == (batch_key if i % 3 == 0 else join_key)
    assert len({step for step, _ in keys}) == 2        # one step per backend, kept


class _HeldStep(capture.CapturedStep):
    """A prefill step that holds a graph per key on the CPU, as the card
    does, and logs what each call did."""

    def __init__(self, fn):
        super().__init__(fn, "prefill")
        self.log = []

    def __call__(self, tokens, key=()):
        k = self.graph_key(tokens, key=key)
        self.log.append(("graph" if k in self else "capture", tokens.shape[1]))
        self._graphs[k] = None
        return self.fn(tokens)

    def drop(self, k):
        self.log.append(("drop", k[0][0][0][1]))
        super().drop(k)


def test_prefill_captures_repeated_shapes_within_bounds(monkeypatch):
    """A shape's first call runs eagerly, its second captures, later ones
    replay; a prompt past MAX_TOKENS never captures; at MAX_GRAPHS a shape
    asked for more than twice as often as the least-used held graph's
    captures it and then drops that graph, one asked for less often runs
    eagerly.  Every call writes what the eager prefill writes."""
    monkeypatch.setattr(DenseKVPrefill, "MAX_GRAPHS", 2)
    monkeypatch.setattr(DenseKVPrefill, "MAX_TOKENS", 2 * 6)
    _, _, port, tparams = _family("moe-attn")
    pf = DenseKVPrefill(port, tparams)
    pf.step = _HeldStep(pf._entries)
    eager = DenseKVPrefill(port, tparams, jit=False)
    rng = np.random.default_rng(6)
    # 2 x 7 tokens: past the bound; 3 and 4 captured on their second
    # calls; 5 eager until its fifth call outnumbers 4's two calls twice
    lens = [7, 7, 7, 3, 3, 4, 4, 5, 5, 5, 3, 5, 5, 5]
    ops.reset_dispatch_counts()
    for n in lens:
        prompts = rng.integers(0, port.cfg.vocab_size, (2, n))
        got, want = port.init_cache(2, MAX_LEN, "cpu"), port.init_cache(2, MAX_LEN, "cpu")
        _garbage(got, n)
        np.testing.assert_array_equal(pf(got, prompts, MAX_LEN), eager(want, prompts, MAX_LEN))
        _assert_caches_equal(got, want)
    assert pf.step.log == [("capture", 3), ("capture", 4), ("graph", 3), ("capture", 5),
                           ("drop", 4), ("graph", 5)]
    assert {k: v for k, v in ops.dispatch_counts().items()
            if k.startswith("prefill")} == {"prefill.eager": 9}
    assert pf.uses == {pf.step.graph_key(torch.zeros((2, n), dtype=torch.int64)): c
                       for n, c in ((7, 3), (3, 3), (4, 2), (5, 6))}


# --------------------------------------------------------------------------
# the per-expert path's captured steps
# --------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["mixtral-smoke", "phi-smoke"])
def engine_models(request):
    return _load(request.param)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_per_expert_captured_steps_match_reference(engine_models, paged):
    """The per-expert path runs its embedding, each MoE layer's segment, each
    expert and its logits through captured steps (one eager call each on
    the CPU: engine_attn<i> once per layer and step, engine_hi / engine_lo
    once per hi / lo expert computed, two dequant_matmul per lo expert),
    no grouped step, and matches the reference's per-expert step."""
    cfg, ref, params, port, tparams = engine_models
    kw = dict(hi_slots=3, lo_slots=2, async_prefetch=False, grouped=False, paged_kv=paged)
    r_eng = RefEngine(ref, params, RefEngineConfig(**kw))
    t_eng = OffloadEngine(port, tparams, EngineConfig(**kw))
    rb, tb = ref_api.HobbitBackend(r_eng), api.HobbitBackend(t_eng)
    rng = np.random.default_rng(8)
    b, s, steps = 2, 8, 4
    prompts = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    teacher = rng.integers(0, cfg.vocab_size, (steps, b)).astype(np.int32)
    try:
        for be in (rb, tb):
            be.start_batch(b, 32)
        np.testing.assert_allclose(tb.prefill(prompts), rb.prefill(prompts), atol=1e-4)
        ops.reset_dispatch_counts()
        for t in range(steps):
            np.testing.assert_allclose(tb.step(teacher[t]), rb.step(teacher[t]), atol=1e-4)
        counts = ops.dispatch_counts()
        th = Thresholds(0.6, 0.9)
        decisions = _decisions(t_eng.trace, th)
        assert [[e.experts for e in row] for row in t_eng.trace] == \
            [[e.experts for e in row] for row in r_eng.trace]
        assert decisions == _decisions(r_eng.trace, th)
        rs, ts = r_eng.stats(), t_eng.stats()
        for key in ("loads_hi", "loads_lo", "skips", "loaded_bytes", "union_reloads"):
            assert ts[key] == rs[key], key
        for key in ("hits_hi", "hits_lo", "misses_hi", "misses_lo", "evictions"):
            assert ts["cache"][key] == rs["cache"][key], key
    finally:
        rb.close()
        tb.close()
    flat = [d for row in decisions for layer in row for d in layer]
    n_hi, n_lo = flat.count(PREC_HI), flat.count(PREC_LO)
    assert n_hi > 0 and n_lo > 0
    want = {"engine_embed.eager": steps, "engine_logits.eager": steps,
            "engine_hi.eager": n_hi, "engine_lo.eager": n_lo}
    want.update({f"engine_attn{mi}.eager": steps for mi in range(t_eng.num_moe_layers)})
    assert {k: v for k, v in counts.items() if k.startswith("engine_")} == want
    assert counts["dequant_matmul.torch"] == 2 * n_lo
    assert counts.get("paged_flash_decode.torch", 0) == (
        steps * cfg.num_layers if paged else 0)
    assert len(t_eng._expert_steps) <= 3 + 2        # one step per (precision, pool slot)


def test_expert_steps_live_until_the_pools_are_reallocated(engine_models):
    """The per-expert path's expert steps survive start_batch (its pools are
    never reallocated after the first); on the grouped path a start_batch
    that grows the pools' overflow rows drops every expert step and opens a
    new graph pool."""
    cfg, _, _, port, tparams = engine_models
    rng = np.random.default_rng(12)
    eng = OffloadEngine(port, tparams, EngineConfig(
        hi_slots=3, lo_slots=2, async_prefetch=False, grouped=False))
    try:
        for b in (2, 4):
            eng.start_batch(b, 16)
            eng.prefill_batch(rng.integers(0, cfg.vocab_size, (b, 4)))
            if b == 2:
                eng.decode_step_batch(rng.integers(0, cfg.vocab_size, b))
                steps, pool = dict(eng._expert_steps), eng._expert_pool
                assert steps
        assert eng._expert_steps == steps and eng._expert_pool is pool
    finally:
        eng.close()
    eng = OffloadEngine(port, tparams, EngineConfig(async_prefetch=False))
    try:
        eng.start_batch(1, 16)
        eng._expert_steps[PREC_HI, 0] = sentinel = object()
        pool = eng._expert_pool
        eng.start_batch(1, 16)                 # the same overflow rows: kept
        assert eng._expert_steps == {(PREC_HI, 0): sentinel}
        eng.start_batch(4, 16)                 # more rows: reallocated
        assert eng._expert_steps == {} and eng._expert_pool is not pool
    finally:
        eng.close()
