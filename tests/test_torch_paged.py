"""The port's paged KV layout against the JAX reference.

* The page pool: the port's `PagedKVPool` and the reference's run the seeded
  op streams of tests/test_paged_properties.py (admit / fork with a shared
  prefix / decode / release / double release) in lockstep, with distinct
  K/V values written wherever a real writer would write; after every op the
  tables, owners, refcounts, free lists, lengths, reservations, COW debt,
  counters and page contents must be equal.
* The model: chunked prefill and paged decode on the trained smoke
  checkpoints (logits atol 1e-4: float32 sums in another order), and
  chunked against one-shot prefill.
* The engine and the scheduler with ``paged_kv=True`` and prefix sharing:
  per-step logits, precision decisions and load counts, and each request's
  greedy tokens under preemption and a pool small enough to queue.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import CACHE_DIR, bench_config
from repro.core import EngineConfig as RefEngineConfig
from repro.core import OffloadEngine as RefEngine
from repro.models import build_model as build_ref
from repro.models import kv_pages as rkv
from repro.serving.api import DenseBackend as RefDense
from repro.serving.api import HobbitBackend as RefHobbit
from repro.serving.batching import BatchingServer as RefServer
from repro.serving.batching import Request as RefRequest
from repro.training import checkpoint as ckpt
from repro_torch.core import EngineConfig, OffloadEngine, Thresholds
from repro_torch.core.scoring import precision_decisions
from repro_torch.models import build_model
from repro_torch.models import kv_pages as tkv
from repro_torch.serving.api import DenseBackend, HobbitBackend
from repro_torch.serving.batching import BatchingServer, Request
from repro_torch.weights import from_jax_params, load_checkpoint

torch.set_num_threads(2)
ATOL = 1e-4


# --------------------------------------------------------------------------
# (b) the page pool, differential
# --------------------------------------------------------------------------
PSZ, NPAGES, BATCH, MAXP = 4, 16, 5, 6      # tests/test_paged_properties.py
MAXTOK = MAXP * PSZ
CHUNK = 3
LAYERS, HKV, HD = 2, 1, 2


def _prompt(seed, length):
    return [int(x) for x in np.random.default_rng(seed).integers(0, 7, length)]


class Twin:
    """The reference pool and the port's pool driven in lockstep."""

    def __init__(self, sharing):
        kw = dict(num_layers=LAYERS, num_kv_heads=HKV, head_dim=HD, num_pages=NPAGES,
                  page_size=PSZ, max_pages_per_slot=MAXP, prefix_sharing=sharing)
        self.ref = rkv.PagedKVPool(dtype="float32", **kw)
        self.port = tkv.PagedKVPool(dtype=torch.float32, device="cpu", **kw)
        self.ref.start(BATCH)
        self.port.start(BATCH)
        self.live = {}          # slot -> [prompt, length, budget]
        self.history = []
        self.tag = 0
        self.restored = 0

    def both(self, name, *args, **kw):
        out_r = getattr(self.ref, name)(*args, **kw)
        out_t = getattr(self.port, name)(*args, **kw)
        assert out_t == out_r, name
        self.check()
        return out_t

    def write(self, slot, start, end):
        """Write distinct K/V rows at positions [start, end) of `slot`."""
        for t in range(start, end):
            self.tag += 1
            page, off = int(self.ref.table[slot, t // PSZ]), t % PSZ
            for li in range(LAYERS):
                val = np.full((HKV, HD), self.tag * (li + 1), np.float32)
                self.ref.k[li] = self.ref.k[li].at[page, off].set(val)
                self.ref.v[li] = self.ref.v[li].at[page, off].set(-val)
                self.port.k[li][page, off] = torch.from_numpy(val)
                self.port.v[li][page, off] = torch.from_numpy(-val)

    def check(self):
        r, p = self.ref, self.port
        np.testing.assert_array_equal(p.table, r.table)
        assert p.owned == [[int(x) for x in o] for o in r.owned]
        np.testing.assert_array_equal(p.refcount, r.refcount)
        assert p.free == [int(x) for x in r.free]
        np.testing.assert_array_equal(p.lens, r.lens)
        np.testing.assert_array_equal(p.reserved, r.reserved)
        assert (p.cow_debt, p.cow_copies, p.prefix_hit_tokens) == \
            (r.cow_debt, r.cow_copies, r.prefix_hit_tokens)
        for li in range(LAYERS):
            np.testing.assert_array_equal(p.k[li][:NPAGES].numpy(), np.asarray(r.k[li]))
            np.testing.assert_array_equal(p.v[li][:NPAGES].numpy(), np.asarray(r.v[li]))

    def admit(self, prompt, new_tokens):
        free = [s for s in range(BATCH) if s not in self.live]
        if not free or not prompt:
            return
        slot, need = free[0], len(prompt) + new_tokens + 1
        parr = np.asarray(prompt, np.int32)
        if not self.both("can_reserve", need, prompt=parr):
            return
        matched = self.both("reserve", slot, need, prompt=parr)
        fed = min(matched, len(prompt) - 1)
        while fed < len(prompt):
            n = min(CHUNK, len(prompt) - fed)
            self.both("ensure", slot, fed + n)
            self.both("make_writable", slot, max(fed, matched), fed + n)
            self.write(slot, max(fed, matched), fed + n)
            fed += n
            self.check()
        self.both("register_prefix", slot, parr)
        self.live[slot] = [list(prompt), len(prompt), need]
        self.history.append(list(prompt))

    def decode(self, pick):
        if not self.live:
            return
        slot = sorted(self.live)[pick % len(self.live)]
        _, length, budget = self.live[slot]
        if length + 1 > budget:
            return
        self.both("ensure", slot, length + 1)
        self.both("make_writable", slot, length, length + 1)
        self.write(slot, length, length + 1)
        self.live[slot][1] = length + 1
        self.check()

    def release(self, pick, double=False):
        if not self.live:
            return
        slot = sorted(self.live)[pick % len(self.live)]
        self.both("release", slot)
        if double:
            self.both("release", slot)
        del self.live[slot]

    def preempt(self, pick):
        """Snapshot + release a live slot, then restore it into the lowest
        free slot when the pool can host it (else it stays out)."""
        if not self.live:
            return
        slot = sorted(self.live)[pick % len(self.live)]
        snap_r, snap_t = self.ref.snapshot_slot(slot), self.port.snapshot_slot(slot)
        for a, b in zip(snap_t["k"] + snap_t["v"], snap_r["k"] + snap_r["v"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        self.both("release", slot)
        state = self.live.pop(slot)
        dst = min(s for s in range(BATCH) if s not in self.live)
        need = int(snap_t["num_pages"]) + int(snap_t["reserved"])
        if need > self.port.reservable_pages():
            with pytest.raises(tkv.PagePoolExhausted):
                self.port.restore_slot(dst, snap_t)
            return
        self.ref.restore_slot(dst, snap_r)
        self.port.restore_slot(dst, snap_t)
        self.check()
        self.live[dst] = state
        self.restored += 1


def _run_ops(ops, sharing):
    """The interpreter of tests/test_paged_properties.py over both pools."""
    d = Twin(sharing)
    for op, a, b, c in ops:
        if op == "admit":
            plen = 1 + a % 18
            d.admit(_prompt(b, plen), c % max(1, MAXTOK - plen - 1))
        elif op == "fork":
            if d.history:
                base = d.history[a % len(d.history)]
                cut = b % (len(base) + 1)
                d.admit((base[:cut] + _prompt(b + 1, 1 + c % 8))[:MAXTOK - 4], 3)
        elif op == "decode":
            d.decode(a)
        elif op == "release":
            d.release(a)
        elif op == "preempt":
            d.preempt(a)
        else:
            d.release(a, double=True)
    for _ in list(d.live):
        d.release(0, double=True)
    assert d.port.pages_used == 0
    return d


NAMES = ["admit", "fork", "decode", "release", "double_release"]


@pytest.mark.parametrize("sharing", [True, False], ids=["sharing", "no-sharing"])
@pytest.mark.parametrize("seeds", [range(0, 10), range(10, 20), range(20, 30)],
                         ids=["seeds0-9", "seeds10-19", "seeds20-29"])
def test_pool_matches_reference_on_seeded_op_streams(seeds, sharing):
    """The seeded streams of test_pseudorandom_interleavings_deterministic,
    each run with sharing on and off."""
    hits = 0
    for seed in seeds:
        rng = np.random.default_rng(seed)
        ops = [(NAMES[int(rng.integers(0, 5))], int(rng.integers(0, 2**16)),
                int(rng.integers(0, 2**16)), int(rng.integers(0, 2**16)))
               for _ in range(25)]
        hits += _run_ops(ops, sharing).port.prefix_hit_tokens
    assert (hits > 0) == sharing


@pytest.mark.parametrize("sharing", [True, False], ids=["sharing", "no-sharing"])
def test_pool_snapshot_restore_matches_reference(sharing):
    """Streams with preemption (snapshot, release, restore into another
    slot) keep both pools and their page contents equal."""
    names = NAMES + ["preempt"]
    restored = 0
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        ops = [(names[int(rng.integers(0, 6))], int(rng.integers(0, 2**16)),
                int(rng.integers(0, 2**16)), int(rng.integers(0, 2**16)))
               for _ in range(30)]
        restored += _run_ops(ops, sharing).restored
    assert restored > 0


def test_pool_scripted_shared_prefix_copy_on_write():
    """A prompt that is a registered partial page's prefix aliases it and
    copies it on its first write; the copy carries the donor's rows."""
    d = Twin(True)
    sys_p = _prompt(1, 10)                  # 2 full pages + a 2-token partial
    d.admit(sys_p, 6)
    d.admit(sys_p + _prompt(2, 5), 4)       # matches all 10 tokens, COW at 10
    assert d.port.prefix_hit_tokens == 10 and d.port.cow_copies == 1
    d.decode(0)                             # donor appends into the shared page
    assert d.port.cow_copies == 1           # sole owner now: no second copy
    d.admit(sys_p + _prompt(3, 2), 4)
    assert d.port.prefix_hit_tokens == 20 and d.port.cow_copies == 2
    for _ in list(d.live):
        d.release(0, double=True)
    assert d.port.pages_used == 0


# --------------------------------------------------------------------------
# (c) the model
# --------------------------------------------------------------------------
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
    return _load(request.param, capacity_factor=8.0)


def _prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, 10)
    return (sys_p, np.concatenate([sys_p, rng.integers(0, vocab, 6)]),
            rng.integers(0, vocab, 7))


def _pool_contents_equal(tpool, rpool):
    for li in range(len(rpool.k)):
        for slot, own in enumerate(rpool.owned):
            idx = np.asarray(own, np.int64)
            np.testing.assert_allclose(tpool.k[li][idx].numpy(), np.asarray(rpool.k[li])[idx],
                                       atol=ATOL, err_msg=f"K layer {li} slot {slot}")
            np.testing.assert_allclose(tpool.v[li][idx].numpy(), np.asarray(rpool.v[li])[idx],
                                       atol=ATOL, err_msg=f"V layer {li} slot {slot}")


@pytest.mark.parametrize("sharing", [True, False], ids=["sharing", "no-sharing"])
def test_chunked_prefill_and_paged_decode_match_reference(models, sharing):
    """Three admissions (the second aliases the first's pages and copies a
    shared partial page on write), then paged decode steps with one slot
    released: inactive rows write nothing a live slot reads."""
    cfg, ref, params, port, tparams = models
    kw = dict(paged=True, page_size=4, prefix_sharing=sharing)
    rpool = ref.init_cache(3, 40, **kw)
    tpool = port.init_cache(3, 40, "cpu", **kw)
    radm = rkv.ChunkedPrefill(ref, params, rpool, chunk=5, jit=False)
    tadm = tkv.ChunkedPrefill(port, tparams, tpool, chunk=5)
    pa, pb, pc = _prompts(cfg.vocab_size, 3)
    for slot, prompt in ((0, pa), (1, pb)):
        np.testing.assert_allclose(tadm.run(slot, prompt, len(prompt) + 8),
                                   radm.run(slot, prompt, len(prompt) + 8), atol=ATOL)
    tadm.begin(2, pc, 12)
    radm.begin(2, pc, 12)
    done_t, done_r = {}, {}
    while 2 not in done_t:
        done_t.update(tadm.step())
        done_r.update(radm.step())
    np.testing.assert_allclose(done_t[2], done_r[2], atol=ATOL)
    assert tpool.prefix_hit_tokens == rpool.prefix_hit_tokens
    assert tpool.cow_copies == rpool.cow_copies
    if sharing:
        assert tpool.prefix_hit_tokens == 10 and tpool.cow_copies >= 1
    np.testing.assert_array_equal(tpool.table, rpool.table)
    _pool_contents_equal(tpool, rpool)

    for pool in (tpool, rpool):
        pool.release(2)
    active = np.asarray([True, True, False])
    positions = np.asarray([len(pa), len(pb), len(pc)])
    teacher = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 3))
    for t in range(3):
        for pool in (tpool, rpool):
            for r in (0, 1):
                pool.ensure(r, int(positions[r]) + 1)
                pool.make_writable(r, int(positions[r]), int(positions[r]) + 1)
        lg_t = port.decode_step_paged(
            tparams, tpool.k, tpool.v, tpool.table_device(),
            torch.from_numpy(teacher[t][:, None]), torch.from_numpy(positions),
            torch.from_numpy(active))
        lg_r, ks, vs = ref.decode_step_paged(
            params, rpool.k, rpool.v, rpool.table_device(),
            jnp.asarray(teacher[t][:, None], jnp.int32), jnp.asarray(positions, jnp.int32),
            jnp.asarray(active))
        rpool.k, rpool.v = list(ks), list(vs)
        np.testing.assert_allclose(lg_t.numpy()[:2], np.asarray(lg_r)[:2], atol=ATOL)
        positions = positions + active
    _pool_contents_equal(tpool, rpool)
    assert tpool.cow_copies == rpool.cow_copies


def test_chunked_prefill_matches_one_shot_prefill(models):
    """Chunked prefill through the pool gives the one-shot prefill's
    last-token logits (capacity 8: no MoE drops on either side)."""
    cfg, _, _, port, tparams = models
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (2, 13))
    want, _, _ = port.prefill(tparams, torch.from_numpy(prompts), 32)
    for chunk in (4, 5, 13):
        pool = port.init_cache(2, 32, "cpu", paged=True, page_size=4)
        adm = tkv.ChunkedPrefill(port, tparams, pool, chunk=chunk)
        got = np.stack([adm.run(r, prompts[r], 32) for r in range(2)])
        np.testing.assert_allclose(got, want.numpy(), atol=ATOL)


# --------------------------------------------------------------------------
# (d) the engine
# --------------------------------------------------------------------------
def _decisions(trace, th):
    return [[precision_decisions(np.asarray(t.gate_vals), th).tolist() for t in row]
            for row in trace]


def _engine_pair(models, slots):
    cfg, ref, params, port, tparams = models
    kw = dict(hi_slots=slots[0], lo_slots=slots[1], async_prefetch=False, paged_kv=True,
              kv_page_size=4, prefill_chunk=5)
    r_eng = RefEngine(ref, params, RefEngineConfig(**kw))
    t_eng = OffloadEngine(port, tparams, EngineConfig(**kw))
    return r_eng, t_eng


def _same_engine_state(t_eng, r_eng):
    th = Thresholds(0.6, 0.9)
    assert [[e.experts for e in row] for row in t_eng.trace] == \
        [[e.experts for e in row] for row in r_eng.trace]
    assert _decisions(t_eng.trace, th) == _decisions(r_eng.trace, th)
    rs, ts = r_eng.stats(), t_eng.stats()
    for key in ("loads_hi", "loads_lo", "skips", "loaded_bytes", "union_reloads",
                "kv_pages_used", "kv_pages_total", "prefix_hit_tokens", "cow_copies"):
        assert ts[key] == rs[key], key
    for key in ("hits_hi", "hits_lo", "misses_hi", "misses_lo", "evictions"):
        assert ts["cache"][key] == rs["cache"][key], key
    assert ts["kernel_dispatch"].get("paged_flash_decode.torch", 0) > 0
    return ts


@pytest.mark.parametrize("slots", [(16, 8), (3, 2)], ids=["roomy", "overflow"])
def test_paged_engine_matches_reference(models, slots):
    """Prefix-sharing admissions, decode, pause / resume into another slot
    and a re-admission over a released slot, on both engines."""
    cfg = models[0]
    r_eng, t_eng = _engine_pair(models, slots)
    rb, tb = RefHobbit(r_eng), HobbitBackend(t_eng)
    pa, pb, pc = _prompts(cfg.vocab_size, 6)
    teacher = np.random.default_rng(8).integers(0, cfg.vocab_size, (6, 3))
    try:
        outs = []
        for be in (rb, tb):
            be.start_batch(3, 40)
            for s in range(3):
                be.release(s)
            lg = [be.join(0, pa), be.step(teacher[0])[0], be.join(1, pb)]
            lg.append(be.step(teacher[1])[:2])
            snap = be.pause(1)
            lg.append(be.join(1, pc))
            lg.append(be.step(teacher[2])[:2])
            be.resume(2, snap)
            lg += [be.step(teacher[t]) for t in range(3, 6)]
            outs.append(lg)
        for a, b in zip(*outs):
            np.testing.assert_allclose(b, a, atol=ATOL)
        ts = _same_engine_state(t_eng, r_eng)
        assert ts["prefix_hit_tokens"] >= 10 and ts["cow_copies"] >= 1
        assert ts["loads_hi"] > 0
    finally:
        rb.close()
        tb.close()


def test_paged_engine_prefill_batch_matches_reference(models):
    """The full-batch prefill path (chunked through the pool, every row
    reserving max_len) and batched decode."""
    cfg = models[0]
    r_eng, t_eng = _engine_pair(models, (8, 4))
    rb, tb = RefHobbit(r_eng), HobbitBackend(t_eng)
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    teacher = rng.integers(0, cfg.vocab_size, (4, 2)).astype(np.int32)
    try:
        for be in (rb, tb):
            be.start_batch(2, 24)
        np.testing.assert_allclose(tb.prefill(prompts), rb.prefill(prompts), atol=ATOL)
        for t in range(4):
            np.testing.assert_allclose(tb.step(teacher[t]), rb.step(teacher[t]), atol=ATOL)
        _same_engine_state(t_eng, r_eng)
        assert tb.kv is t_eng.kv_pool and tb.kv.pages_used == 2 * 4   # 15 tokens each
    finally:
        rb.close()
        tb.close()


# --------------------------------------------------------------------------
# (e) the scheduler
# --------------------------------------------------------------------------
class _Injecting:
    """Backend wrapper that submits urgent requests after the `after`-th
    decode step (traffic arriving while the pool is busy)."""

    def __init__(self, inner, after, make_reqs):
        self.inner, self.model = inner, inner.model
        self.after, self.make_reqs = after, make_reqs
        self.server, self._steps, self.refused = None, 0, 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def can_admit(self, tokens, *, prompt=None):
        ok = self.inner.can_admit(tokens, prompt=prompt)
        self.refused += not ok
        return ok

    def step(self, tokens):
        self._steps += 1
        if self._steps == self.after:
            for r in self.make_reqs():
                self.server.submit(r)
        return self.inner.step(tokens)


def _shared_workload(vocab):
    """rid 0 carries the 6-token system prompt alone (a 2-token partial page
    later prompts alias); the others append seeded bodies."""
    rng = np.random.default_rng(21)
    sys_p = rng.integers(0, vocab, 6)
    prompts = [sys_p] + [np.concatenate([sys_p, rng.integers(0, vocab, n)])
                         for n in (3, 5, 4, 2, 6)]
    new = [8, 5, 6, 4, 5, 4]
    return prompts, new


def _serve(server_cls, request_cls, backend, vocab):
    prompts, new = _shared_workload(vocab)
    inj = _Injecting(backend, after=4, make_reqs=lambda: [
        request_cls(rid=i, prompt=prompts[i], max_new_tokens=new[i], priority=2,
                    ttft_slo_s=10.0) for i in (4, 5)])
    # 10 pages of 4 tokens: two requests fit, so the third queues
    srv = server_cls(inj, max_batch=3, max_len=24, admit_k=1, preempt_margin=0.5,
                     aging_s=1e6)     # no aging: the order does not depend on speed
    inj.server = srv
    for i in range(4):
        srv.submit(request_cls(rid=i, prompt=prompts[i], max_new_tokens=new[i]))
    try:
        srv.run()
        st = srv.stats()["backend"]
        assert inj.refused > 0, "the pool never made a request wait"
        return ({r.rid: np.asarray(r.output) for r in srv.completed}, srv.preemptions,
                st["prefix_hit_tokens"], st["cow_copies"])
    finally:
        srv.close()


@pytest.mark.parametrize("kind", ["dense", "hobbit"])
def test_paged_batching_server_tokens_match_reference(models, kind):
    cfg, ref, params, port, tparams = models
    pk = dict(page_size=4, kv_pages=10, prefill_chunk=4, prefix_sharing=True)
    if kind == "dense":
        rbe = RefDense(ref, params, jit=False, paged=True, **pk)
        tbe = DenseBackend(port, tparams, paged=True, **pk)
    else:
        ekw = dict(hi_slots=8, lo_slots=4, async_prefetch=False, paged_kv=True,
                   kv_page_size=4, kv_pages=10, prefill_chunk=4)
        rbe = RefHobbit(RefEngine(ref, params, RefEngineConfig(**ekw)))
        tbe = HobbitBackend(OffloadEngine(port, tparams, EngineConfig(**ekw)))
    out_r, pre_r, hits_r, cow_r = _serve(RefServer, RefRequest, rbe, cfg.vocab_size)
    out_t, pre_t, hits_t, cow_t = _serve(BatchingServer, Request, tbe, cfg.vocab_size)
    assert pre_t >= 1 and pre_r >= 1
    assert hits_t > 0 and cow_t > 0
    assert sorted(out_t) == sorted(out_r) == list(range(6))
    for rid in out_r:
        np.testing.assert_array_equal(out_t[rid], out_r[rid])


class _ShortResume:
    """Backend wrapper whose first resume finds the pool short."""

    def __init__(self, inner):
        self.inner, self.model = inner, inner.model
        self.failed = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def resume(self, slot, snapshot):
        if not self.failed:
            self.failed += 1
            raise tkv.PagePoolExhausted("pool short on resume")
        return self.inner.resume(slot, snapshot)


def test_paged_resume_short_of_pages_requeues_the_victim(models):
    """A resume that raises PagePoolExhausted requeues the paused request
    and waits for a retirement; every request still completes with the
    tokens of the run where the resume succeeds at once."""
    cfg, _, _, port, tparams = models
    pk = dict(page_size=4, kv_pages=10, prefill_chunk=4)
    outs = []
    for wrap in (lambda b: b, _ShortResume):
        be = wrap(DenseBackend(port, tparams, paged=True, **pk))
        out, pre, _, _ = _serve(BatchingServer, Request, be, cfg.vocab_size)
        assert pre >= 1
        outs.append(out)
    assert be.failed == 1
    assert sorted(outs[0]) == sorted(outs[1]) == list(range(6))
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[1][rid], outs[0][rid])
