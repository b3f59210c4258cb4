"""The port's grouped FFN at the fixed pair count P = B * top_k against the
JAX reference, on the CPU (plain versions of the kernels).

* ``core.engine.grouped_ffn`` on a table written by ``pack_pair_table``
  against the reference's ``OffloadEngine._grouped_ffn`` on the same pools
  (the reference's pool slots and overflow buffers are the port's pool
  rows), hidden state and pairs: hi-only and lo-only layers, an all-pad
  layer, skipped ranks, rows sharing a slot, union-overflow slots, B = 1
  and 4, SwiGLU and GELU; rtol 1e-5 / atol 1e-4 (float32 sums in another
  order).
* ``kops.grouped_matmul``'s plain version against the reference's hi
  einsum on gathered slots, with pads and shared slots, float32 and bf16
  values; an out-of-range slot raises.
* ``pack_pair_table``'s layout and pads.

The card's side (the FFN's replay against its eager call, the kernel
against its plain version) is in tests/test_torch_capture_card.py and
chip_smoke.py.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant
from repro.core import EngineConfig as RefEngineConfig
from repro.core import OffloadEngine as RefEngine
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.engine import grouped_ffn, pack_pair_table, pair_table_words
from repro_torch.kernels import ops

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-4
D, F, K = 64, 32, 2                 # d_model, d_ff_expert, top_k
HI_SLOTS, LO_SLOTS = 4, 3
BITS, GROUP = 4, 16

# name -> (B, hi pairs, lo pairs), pairs [(row, rank, pool slot)] in row
# order as the engine emits them; slots >= HI_SLOTS / LO_SLOTS are the
# union-overflow rows after the cache slots
CASES = {
    "hi-only B=1": (1, [(0, 0, 1), (0, 1, 3)], []),
    "lo-only B=4": (4, [], [(0, 0, 2), (0, 1, 0), (1, 0, 1), (1, 1, 2), (2, 0, 0),
                            (2, 1, 1), (3, 0, 2), (3, 1, 0)]),
    "all pads B=4": (4, [], []),
    "skipped ranks B=2": (2, [(0, 0, 1)], [(1, 0, 2)]),
    "rows on one slot B=4": (4, [(0, 0, 2), (1, 0, 2), (3, 1, 2)],
                             [(0, 1, 1), (2, 0, 1), (2, 1, 0)]),
    "union overflow B=4": (4, [(0, 0, 4), (1, 0, 5), (2, 1, 1)],
                           [(0, 1, 3), (1, 1, 4), (3, 0, 0)]),
    "mixed B=4": (4, [(0, 0, 3), (1, 1, 0), (2, 0, 1), (2, 1, 2), (3, 0, 3)],
                  [(0, 1, 2), (1, 0, 1), (3, 1, 1)]),
    "inactive row B=4": (4, [(0, 0, 0), (3, 0, 1)], [(0, 1, 1), (1, 0, 2), (1, 1, 0)]),
}


def _cfgs(act):
    """(port config, reference config) with the given FFN activation."""
    port = smoke_variant(get_config("mixtral-8x7b"), layers=1, d_model=D, vocab=256)
    ref = ref_smoke_variant(ref_get_config("mixtral-8x7b"), layers=1, d_model=D, vocab=256)
    return (dataclasses.replace(port, dtype="float32", ffn_activation=act),
            dataclasses.replace(ref, dtype="float32", ffn_activation=act))


def _pools(b, act, seed):
    """Seeded float32 hi pools and 4-bit lo pools (random codes, scales in
    [0, 0.05)), each with B * K overflow rows after the cache slots."""
    rng = np.random.default_rng(seed)
    wi_cols = 2 * F if act == "swiglu" else F
    nh, nl = HI_SLOTS + b * K, LO_SLOTS + b * K
    hi = {"wi": rng.standard_normal((nh, D, wi_cols)).astype(np.float32) * 0.1,
          "wo": rng.standard_normal((nh, F, D)).astype(np.float32) * 0.1}
    lo = {"wi_data": rng.integers(-128, 128, (nl, D // 2, wi_cols), dtype=np.int8),
          "wi_scale": (rng.random((nl, D // GROUP, wi_cols)) * 0.05).astype(np.float32),
          "wo_data": rng.integers(-128, 128, (nl, F // 2, D), dtype=np.int8),
          "wo_scale": (rng.random((nl, F // GROUP, D)) * 0.05).astype(np.float32)}
    return hi, lo


def _weights(b, hi_pairs, lo_pairs, seed):
    rng = np.random.default_rng(seed + 100)
    w_hi = np.zeros((b, K), np.float32)
    w_lo = np.zeros((b, K), np.float32)
    for w, pairs in ((w_hi, hi_pairs), (w_lo, lo_pairs)):
        for r, j, _ in pairs:
            w[r, j] = rng.uniform(0.05, 0.6)
    return w_hi, w_lo


def _reference(ref_cfg, hi, lo, hs, hi_pairs, lo_pairs, w_hi, w_lo):
    """The reference's _grouped_ffn on the same pools: its cache slots and
    its overflow buffers are the port's pool rows before and after the
    slot count; its pads carry slot 0.  Returns y (B, 1, D)."""
    b = hs.shape[0]
    pp = b * K
    arrays = []
    for pairs in (hi_pairs, lo_pairs):
        rows, ranks, slots = np.full(pp, b, np.int32), np.zeros(pp, np.int32), \
            np.zeros(pp, np.int32)
        for i, (r, j, s) in enumerate(pairs):
            rows[i], ranks[i], slots[i] = r, j, s
        arrays += [jnp.asarray(rows), jnp.asarray(ranks), jnp.asarray(slots)]
    ns = types.SimpleNamespace(ecfg=RefEngineConfig(lo_bits=BITS, group_size=GROUP),
                               cfg=ref_cfg)
    ns._activate = lambda z: RefEngine._activate(ns, z)
    pools = [jnp.asarray(hi["wi"][:HI_SLOTS]), jnp.asarray(hi["wo"][:HI_SLOTS])]
    pools += [jnp.asarray(lo[n][:LO_SLOTS]) for n in ("wi_data", "wi_scale", "wo_data",
                                                      "wo_scale")]
    ovf = [jnp.asarray(hi["wi"][HI_SLOTS:]), jnp.asarray(hi["wo"][HI_SLOTS:])]
    ovf += [jnp.asarray(lo[n][LO_SLOTS:]) for n in ("wi_data", "wi_scale", "wo_data",
                                                    "wo_scale")]
    y = RefEngine._grouped_ffn(ns, *pools, *ovf, jnp.asarray(hs[:, None, :]), *arrays,
                               jnp.asarray(w_hi), jnp.asarray(w_lo))
    return np.asarray(y)


def _port(port_cfg, hi, lo, hs, x, hi_pairs, lo_pairs, w_hi, w_lo):
    b = hs.shape[0]
    table = np.zeros(pair_table_words(b, K), np.int32)
    pack_pair_table(table, hi_pairs, lo_pairs, w_hi, w_lo)
    out = grouped_ffn(torch.from_numpy(hs), torch.from_numpy(x), torch.from_numpy(table),
                      {n: torch.from_numpy(v) for n, v in hi.items()},
                      {n: torch.from_numpy(v) for n, v in lo.items()}, port_cfg,
                      top_k=K, lo_bits=BITS, group_size=GROUP)
    return out.numpy()


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_ffn_matches_reference(case, act):
    b, hi_pairs, lo_pairs = CASES[case]
    seed = sorted(CASES).index(case)
    port_cfg, ref_cfg = _cfgs(act)
    hi, lo = _pools(b, act, seed)
    rng = np.random.default_rng(seed + 7)
    hs = rng.standard_normal((b, D)).astype(np.float32)
    x = rng.standard_normal((b, 1, D)).astype(np.float32)
    w_hi, w_lo = _weights(b, hi_pairs, lo_pairs, seed)
    ops.reset_dispatch_counts()
    got = _port(port_cfg, hi, lo, hs, x, hi_pairs, lo_pairs, w_hi, w_lo)
    counts = ops.dispatch_counts()
    want = x + _reference(ref_cfg, hi, lo, hs, hi_pairs, lo_pairs, w_hi, w_lo)
    assert got.shape == (b, 1, D)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # one launch of each kernel, whatever the pairs: the fixed-shape step
    assert counts == {"grouped_matmul.torch": 2, "grouped_dequant_matmul.torch": 1,
                      "grouped_dequant_combine.torch": 1}
    rows = {r for r, _, _ in hi_pairs + lo_pairs}
    for r in range(b):
        if r not in rows:           # nothing kept: the residual passes through
            np.testing.assert_array_equal(got[r], x[r])


def test_pack_pair_table_layout_and_pads():
    b = 2
    hi_pairs, lo_pairs = [(0, 0, 3), (1, 1, 5)], []
    w_hi = np.asarray([[0.5, 0.0], [0.0, 0.25]], np.float32)
    w_lo = np.zeros((b, K), np.float32)
    table = np.full(pair_table_words(b, K), -7, np.int32)
    pack_pair_table(table, hi_pairs, lo_pairs, w_hi, w_lo)
    idx = table[:6 * b * K].reshape(6, b * K)
    np.testing.assert_array_equal(idx[0], [0, 1, b, b])          # hi rows, pads row B
    np.testing.assert_array_equal(idx[1], [0, 1, 0, 0])          # hi ranks
    np.testing.assert_array_equal(idx[2], [3, 5, 5, 5])          # pads repeat the last slot
    np.testing.assert_array_equal(idx[3], [b] * (b * K))         # lo: pads only
    np.testing.assert_array_equal(idx[4:], 0)                    # ranks 0, slot 0
    w = table[6 * b * K:].view(np.float32).reshape(2, b, K)
    np.testing.assert_array_equal(w[0], w_hi)
    np.testing.assert_array_equal(w[1], w_lo)


# name -> (each pair's slot, pool slots S); "6 pads" repeats the last real
# pair's slot as the engine pads
GMM_CASES = {
    "P=1": ([2], 3), "P=4": ([0, 3, 1, 2], 4), "2 pairs on 1 slot": ([1, 1], 2),
    "8 pairs, 6 pads": ([0, 2, 2, 2, 2, 2, 2, 2], 3), "P=11 shared": ([4, 0, 4, 1, 2, 2, 3,
                                                                      0, 5, 5, 1], 6),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_grouped_matmul_matches_reference_einsum(case, dtype):
    """The plain version against the reference's hi product,
    ``einsum("pd,pdc->pc", x, w[slot])``, both in float32 on the same
    (bf16-valued for bfloat16) inputs."""
    sl, s = GMM_CASES[case]
    rng = np.random.default_rng(len(sl) * 10 + s)
    k, n = 96, 40
    x = torch.from_numpy(rng.standard_normal((len(sl), k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((s, k, n)).astype(np.float32) * 0.1)
    x, w = x.to(getattr(torch, dtype)), w.to(getattr(torch, dtype))
    slot = torch.tensor(sl, dtype=torch.int32)
    ops.reset_dispatch_counts()
    got = ops.grouped_matmul(x, w, slot)
    assert ops.dispatch_counts() == {"grouped_matmul.torch": 1}
    xf, wf = x.to(torch.float32).numpy(), w.to(torch.float32).numpy()
    want = np.asarray(jnp.einsum("pd,pdc->pc", jnp.asarray(xf),
                                 jnp.asarray(wf)[jnp.asarray(sl)]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(sl), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", [3, -1])
def test_grouped_matmul_slot_out_of_range_raises(bad):
    x = torch.zeros((2, 8))
    w = torch.zeros((3, 8, 4))
    with pytest.raises(IndexError):
        ops.grouped_matmul(x, w, torch.tensor([0, bad], dtype=torch.int32))


# a card's SM count and its cluster fit for the bf16 kernel (ranks ->
# clusters at once): the H100 (every SM pair holds a cluster), and a small
# card
CARDS = {"h100": (132, {1: 132, 2: 66}), "small": (8, {1: 8, 2: 4})}
# at Mixtral's hi shapes, P = 1 and P = 8, the plan on the H100
MIXTRAL_PLANS = {(4096, 28672): (2, 66, 448, 2048), (14336, 4096): (2, 66, 64, 7168)}


@pytest.mark.parametrize("k,n,pairs", [(4096, 28672, 1), (14336, 4096, 1), (4096, 28672, 8),
                                       (14336, 4096, 8), (64, 256, 2), (100, 8, 4),
                                       (6144, 4096, 2), (128, 128, 2), (1000, 264, 17),
                                       (3000, 132, 1024)])
def test_grouped_matmul_plan_covers_k(k, n, pairs):
    """The ranks' K ranges are whole GMM_BOX_ROWS (128-row) units that cover
    K once, in rank order (the last may run past K, read as zeros, by less
    than one unit per rank); the grid's clusters fit the card's SMs and its
    fit; the tiles cover N.  At Mixtral's hi shapes on the H100 both wi and
    wo take 2 ranks on 66 clusters (every SM), at 97% of an even split."""
    for sms, fit in CARDS.values():
        plan = ops.grouped_matmul_plan(k, n, pairs, sms, fit)
        assert plan.ranks in ops.GMM_RANKS
        assert 1 <= plan.clusters <= fit[plan.ranks] and plan.clusters * plan.ranks <= sms
        assert (plan.tiles - 1) * ops.GMM_TILE_N < n <= plan.tiles * ops.GMM_TILE_N
        ranges = plan.ranges(k)
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
        assert plan.rows % ops.GMM_BOX_ROWS == 0
        units = -(-k // ops.GMM_BOX_ROWS)
        assert units <= plan.ranks * plan.rows // ops.GMM_BOX_ROWS < units + plan.ranks
    if (k, n) in MIXTRAL_PLANS:
        plan = ops.grouped_matmul_plan(k, n, pairs, *CARDS["h100"])
        assert tuple(plan) == MIXTRAL_PLANS[(k, n)]
        assert ops._even_share(plan.tiles, k, 2, 66, 132) == pytest.approx(0.9697, abs=1e-4)
        assert ops._even_share(plan.tiles, k, 1, 132, 132) < 0.86


# each pair's slot; "6 pads" repeats the last real pair's slot, "1024" is
# the most pairs of a launch
SCHEDULE_SLOTS = {
    "P=1": [0], "P=8 distinct": list(range(8)), "8 pairs, 6 pads": [0, 1, 1, 1, 1, 1, 1, 1],
    "17 on one slot": [2] * 17, "P=11 shared": [4, 0, 4, 1, 2, 2, 3, 0, 5, 5, 1],
    "1024": np.random.default_rng(7).integers(0, 40, 1024).tolist(),
}


def test_grouped_matmul_groups_follow_the_kernel_order():
    """Slots in order of their first pair, each slot's pairs in pair order,
    at most GMM_GROUP a group: 17 pairs on one slot are 3 passes."""
    assert ops.grouped_matmul_groups([2] * 17) == [
        (2, list(range(8))), (2, list(range(8, 16))), (2, [16])]
    assert ops.grouped_matmul_groups([4, 0, 4, 1, 0]) == [(4, [0, 2]), (0, [1, 4]), (1, [3])]
    for sl in SCHEDULE_SLOTS.values():
        groups = ops.grouped_matmul_groups(sl)
        pairs = [p for _, ps in groups for p in ps]
        assert sorted(pairs) == list(range(len(sl)))
        assert all(1 <= len(ps) <= ops.GMM_GROUP and all(sl[p] == s for p in ps)
                   for s, ps in groups)


def _tiles_of(work):
    """The (group, tile) pairs of a block's sweeps, in order."""
    return [(g, tile0 + i) for g, tile0, w, _, _ in work for i in range(w)]


@pytest.mark.parametrize("card", sorted(CARDS))
@pytest.mark.parametrize("k,n", [(4096, 28672), (14336, 4096), (1000, 264), (3000, 132)])
@pytest.mark.parametrize("case", sorted(SCHEDULE_SLOTS))
def test_grouped_matmul_schedule_is_even_and_covers_every_job_once(case, k, n, card):
    """Every (group, tile) is streamed once by each rank, over that rank's
    K range, in sweeps of at most GMM_SWEEP adjacent tiles of one group, so
    every (pair, column, K row) is covered once; every block of the grid
    streams the same number of tiles within one (its weight bytes within
    one unit, a tile's K range, of every other block's and of an even split
    over the card); and the schedule is a function of the plan and the
    group count alone (the reduction order cannot change between calls)."""
    sl = SCHEDULE_SLOTS[case]
    sms, fit = CARDS[card]
    plan = ops.grouped_matmul_plan(k, n, len(sl), sms, fit)
    groups = len(ops.grouped_matmul_groups(sl))
    sched = ops.grouped_matmul_schedule(plan, groups)
    assert sched == ops.grouped_matmul_schedule(plan, groups)
    assert len(sched) == plan.clusters * plan.ranks
    for work in sched:
        assert all(1 <= w <= ops.GMM_SWEEP and tile0 + w <= plan.tiles
                   for _, tile0, w, _, _ in work)
    for r in range(plan.ranks):
        blocks = range(r, len(sched), plan.ranks)
        tiles = [t for b in blocks for t in _tiles_of(sched[b])]
        assert sorted(tiles) == [(g, t) for g in range(groups) for t in range(plan.tiles)]
        assert {(r0, r1) for b in blocks for *_, r0, r1 in sched[b]} <= {
            (r * plan.rows, (r + 1) * plan.rows)}
    count = [len(_tiles_of(work)) for work in sched]
    assert max(count) - min(count) <= 1
    if plan.clusters * plan.ranks == sms:
        # an even split over the card: the busiest block within one tile's
        # K range of the mean
        assert max(count) - groups * plan.tiles * plan.ranks / sms <= 1


@pytest.mark.parametrize("card", sorted(CARDS))
@pytest.mark.parametrize("case", ["P=1", "8 pairs, 6 pads", "17 on one slot", "P=11 shared"])
def test_grouped_matmul_schedule_sums_in_rank_order(case, card):
    """The kernel's arithmetic replayed in numpy from the schedule at a small
    ragged shape: each rank's partial tile over its K range, the owner
    adding the ranks' partials in rank order.  Each (pair, column, K row)
    is added exactly once; two replays are bit-identical and agree with
    the reference's einsum (float32 sums in another order)."""
    sl = SCHEDULE_SLOTS[case]
    k, n = 200, 136                            # 2 rank units, 3 tiles, both ragged
    sms, fit = CARDS[card]
    plan = ops.grouped_matmul_plan(k, n, len(sl), sms, fit)
    rng = np.random.default_rng(len(sl))
    x = rng.standard_normal((len(sl), k)).astype(np.float32)
    w = rng.standard_normal((max(sl) + 1, k, n)).astype(np.float32)

    def replay():
        groups = ops.grouped_matmul_groups(sl)
        seen = np.zeros((len(sl), n, k), np.int32)
        parts = {}
        for b, work in enumerate(ops.grouped_matmul_schedule(plan, len(groups))):
            r = b % plan.ranks
            for g, t in _tiles_of(work):
                s, pairs = groups[g]
                r0, r1 = plan.ranges(k)[r]
                cols = slice(t * ops.GMM_TILE_N, min(n, (t + 1) * ops.GMM_TILE_N))
                seen[np.ix_(pairs, range(n)[cols], range(r0, r1))] += 1
                parts[(g, t, r)] = x[pairs][:, r0:r1] @ w[s][r0:r1, cols]
        y = np.full((len(sl), n), np.nan, np.float32)
        for (g, t, r), v in sorted(parts.items()):
            if r:
                continue
            for q in range(1, plan.ranks):
                v = v + parts[(g, t, q)]
            cols = slice(t * ops.GMM_TILE_N, min(n, (t + 1) * ops.GMM_TILE_N))
            assert np.isnan(y[groups[g][1], cols]).all()
            y[groups[g][1], cols] = v
        assert (seen == 1).all()
        return y

    y = replay()
    np.testing.assert_array_equal(y, replay())
    want = np.asarray(jnp.einsum("pd,pdc->pc", jnp.asarray(x), jnp.asarray(w)[jnp.asarray(sl)]))
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-4)
