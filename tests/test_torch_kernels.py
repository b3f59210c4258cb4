"""Plain PyTorch versions of the seven kernels against the JAX package's
ops, in both of its modes: ``mode="pallas"`` (the Pallas kernel body in
interpret mode) and ``mode="xla"`` (its jnp oracle).  Tolerance rtol 1e-5 /
atol 1e-4, the tests/test_kernels.py convention (atol 1e-3 where that file
accumulates over K = 1024); the flash-decode cases use that file's own
tolerances (1e-5 for float32 K/V, 3e-2 for bfloat16).  Inputs are made with
numpy from a seed and handed to both sides.

The CUDA kernels cannot run here (no nvcc, no card); chip_smoke.py holds
each one against these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_decode import paged_flash_decode_pallas
from repro.quant.quantize import quantize as jquantize
from repro_torch.kernels import ops, ref
from repro_torch.quant.quantize import QTensor, dequantize, quantize, unpack_codes

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-4
MODES = ["pallas", "xla"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# gating
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("e", [8, 16])
@pytest.mark.parametrize("b", [1, 4])
def test_gating_topk_matches_reference(mode, e, b):
    rng = np.random.default_rng(e * 10 + b)
    d = 256
    x = rng.standard_normal((b, d)).astype(np.float32)
    gates = (rng.standard_normal((1, d, e)) / np.sqrt(d)).astype(np.float32)
    lg_r, v_r, i_r = jops.gating_topk(jnp.asarray(x), jnp.asarray(gates), top_k=2,
                                      mode=mode)
    lg_t, v_t, i_t = ops.gating_topk(_t(x), _t(gates), top_k=2)
    _close(lg_t, lg_r)
    _close(v_t, v_r)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))
    assert i_t.dtype == torch.int32


@pytest.mark.parametrize("mode", MODES)
def test_gating_topk_ties_go_to_lowest_index(mode):
    """Duplicate router columns give exactly equal logits: both sides pick
    the lower expert index first."""
    rng = np.random.default_rng(5)
    d, e = 128, 8
    gates = (rng.standard_normal((1, d, e)) / np.sqrt(d)).astype(np.float32)
    gates[0, :, 5] = gates[0, :, 2]
    gates[0, :, 7] = gates[0, :, 2]
    x = rng.standard_normal((3, d)).astype(np.float32)
    # make expert 2 (and its copies 5, 7) the winners for every row
    x = x + 4.0 * gates[0, :, 2][None, :] / np.square(gates[0, :, 2]).sum()
    _, v_r, i_r = jops.gating_topk(jnp.asarray(x), jnp.asarray(gates), top_k=3,
                                   mode=mode)
    _, v_t, i_t = ops.gating_topk(_t(x), _t(gates), top_k=3)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))
    np.testing.assert_array_equal(i_t.numpy(), np.tile([2, 5, 7], (3, 1))[None])
    _close(v_t, v_r)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,e", [(1, 8), (2, 8), (3, 16)])
def test_stacked_gating_matches_reference(mode, p, e):
    rng = np.random.default_rng(p * 100 + e)
    d = 256
    x = rng.standard_normal((1, d)).astype(np.float32)
    gates = (rng.standard_normal((p, d, e)) / np.sqrt(d)).astype(np.float32)
    want = jops.stacked_gating(jnp.asarray(x), jnp.asarray(gates), mode=mode)
    got = ops.stacked_gating(_t(x), _t(gates))
    assert got.shape == (p, 1, e) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("d", [2048, 4096, 5120, 4097])
@pytest.mark.parametrize("e", [1, 3, 8, 16, 160, 256])
@pytest.mark.parametrize("vec", [True, False])
def test_gating_plan_slices_cover_d_once(d, e, vec):
    """The cluster kernel's cut: the ranks' slices tile [0, D) in order with
    no gap or overlap, each within one tile, the cluster within the card's
    limit, and the block's shared x tile and partials within its buffer."""
    for b in (1, 4, 9):
        plan = ops.gating_plan(d, e, b, vec=vec)
        covered = np.zeros(d, np.int64)
        for d0, d1 in plan.slices(d):
            assert 0 <= d0 <= d1 <= d
            covered[d0:d1] += 1
        assert (covered == 1).all()
        assert 1 <= plan.ranks <= ops.GATING_MAX_CLUSTER == 8
        # what each launch passes does not depend on the batch
        assert ops._gating_cut(d, e, vec) == (int(plan.vec == 4), plan.ranks)
        assert plan.slice <= plan.tile or plan.ranks == ops.GATING_MAX_CLUSTER
        assert plan.groups * plan.vec == e and plan.groups <= plan.lanes < 2 * plan.groups
        assert 32 % plan.lanes == 0 or plan.lanes % 32 == 0
        assert plan.rows * plan.lanes == ops.GATING_THREADS
        assert plan.row_pass * plan.passes >= b and plan.row_pass <= ops.GATING_ROWS
        assert plan.row_pass * plan.tile <= ops.GATING_BUF_FLOATS
        assert plan.slots * plan.row_pass * e <= ops.GATING_BUF_FLOATS
        assert plan.vec == (4 if vec and e % 4 == 0 else 1)
    # Mixtral's router: 8 ranks of one 512-row tile, 16-byte loads
    if (d, e, vec) == (4096, 8, True):
        assert (plan.ranks, plan.slice, plan.tile) == (8, 512, 512)


def _fma(x, g, acc):
    """float32 fmaf(x, g, acc): the product is exact in float64."""
    return (x.astype(np.float64) * g.astype(np.float64) + acc).astype(np.float32)


def _gating_emulation(x, gates, top_k, plan):
    """gating.cu's cluster kernel in float32, in its order of operations:
    each thread's FMA chain over rows d0 + r, d0 + r + rows, ... of its
    rank's slice; the xor butterfly over the rows a warp holds (lanes <= 32);
    the warps (or rows of groups) in order; the ranks in rank order; then
    per token row the softmax and k rounds of argmax as one warp computes
    them (lane l sums experts l, l + 32, ..., then a butterfly; each round
    picks the largest exp(l - max), ties at the lowest index, and divides
    only the pick by the sum)."""
    p, d, e = gates.shape
    b = x.shape[0]
    rows, lanes = plan.rows, plan.lanes
    logits = np.zeros((p, b, e), np.float32)
    for pi in range(p):
        total = np.zeros((b, e), np.float32)
        for d0, d1 in plan.slices(d):
            n = d1 - d0
            steps = -(-n // rows)
            xs = np.zeros((b, steps * rows), np.float32)
            xs[:, :n] = x[:, d0:d1]
            gs = np.zeros((steps * rows, e), np.float32)
            gs[:n] = gates[pi, d0:d1]
            xs, gs = xs.reshape(b, steps, rows), gs.reshape(steps, rows, e)
            acc = np.zeros((b, rows, e), np.float32)            # thread (r, column)
            for i in range(steps):
                acc = _fma(xs[:, i, :, None], gs[i][None], acc)
            if lanes <= 32:
                per_warp = 32 // lanes
                acc = acc.reshape(b, rows // per_warp, per_warp, e)
                o = per_warp // 2
                while o >= 1:
                    acc = acc + acc[:, :, np.arange(per_warp) ^ o]
                    o //= 2
                slots = acc[:, :, 0]
            else:
                slots = acc
            part = np.zeros((b, e), np.float32)
            for k in range(slots.shape[1]):
                part = part + slots[:, k]
            total = total + part
        logits[pi] = total
    z = np.exp(logits - logits.max(-1, keepdims=True)).astype(np.float32)
    ez = np.zeros((p, b, 256), np.float32)
    ez[..., :e] = z
    lane_sum = np.zeros((p, b, 32), np.float32)
    for i in range(8):
        lane_sum = lane_sum + ez[..., 32 * i:32 * i + 32]
    o = 16
    while o >= 1:
        lane_sum = lane_sum + lane_sum[..., np.arange(32) ^ o]
        o //= 2
    work, total = z.copy(), lane_sum[..., 0]
    vals, idx = [], []
    for _ in range(top_k):
        i = work.argmax(-1)                      # first maximal exp(l - max)
        vals.append(np.take_along_axis(work, i[..., None], -1)[..., 0] / total)
        idx.append(i)
        np.put_along_axis(work, i[..., None], -1.0, -1)
    return logits, np.stack(vals, -1), np.stack(idx, -1).astype(np.int32)


def _topk_match(idx, want_idx, want_vals_sorted):
    """idx equal to the reference's, except where the reference's top-k gap
    (a selected value to the next candidate) is under 1e-6."""
    if np.array_equal(idx, want_idx):
        return
    k = want_idx.shape[-1]
    gaps = np.abs(want_vals_sorted[..., :k] - want_vals_sorted[..., 1:k + 1]).min(-1)
    rows = (idx != want_idx).any(-1)
    assert (gaps[rows] < 1e-6).all(), "top-k indices differ where the gap exceeds 1e-6"


# (P, D, E, K, B, 16-byte gate loads); the first six are the serving path's
# shapes (Mixtral's router for B 1-4, the predictor's stack of 2)
GATING_EMULATION_CASES = [
    (1, 4096, 8, 2, 1, True), (1, 4096, 8, 2, 2, True), (1, 4096, 8, 2, 3, True),
    (1, 4096, 8, 2, 4, True), (2, 4096, 8, 2, 1, True), (1, 4096, 8, 2, 1, False),
    (1, 2048, 16, 1, 9, True), (2, 4096, 16, 6, 5, True), (1, 5120, 160, 6, 8, True),
    (1, 2048, 160, 2, 3, False), (1, 4096, 256, 6, 9, True), (2, 2048, 256, 1, 2, False),
    (1, 4097, 8, 2, 4, True), (3, 512, 3, 2, 7, True),
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", GATING_EMULATION_CASES,
                         ids=["p{}-d{}-e{}-k{}-b{}-{}".format(*c[:5], "v4" if c[5] else "v1")
                              for c in GATING_EMULATION_CASES])
def test_gating_cluster_order_meets_card_tolerance(mode, case):
    """The cluster kernel's summation order and warp top-k, emulated in
    float32, against the JAX package's gating_topk and stacked_gating at
    chip_smoke.py's tolerances: rtol/atol 1e-5 on logits and vals, idx
    exact unless the top-k gap is under 1e-6.  x is rounded to bf16 first,
    as the serving path hands it over."""
    p, d, e, k, b, vec = case
    rng = np.random.default_rng(d + e + b)
    x = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    x = x.to(torch.bfloat16).to(torch.float32).numpy()
    gates = (rng.standard_normal((p, d, e)) / np.sqrt(d)).astype(np.float32)
    plan = ops.gating_plan(d, e, b, vec=vec)
    lg, vals, idx = _gating_emulation(x, gates, k, plan)
    lg_r, v_r, i_r = jops.gating_topk(jnp.asarray(x), jnp.asarray(gates), top_k=k, mode=mode)
    np.testing.assert_allclose(lg, np.asarray(lg_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vals, np.asarray(v_r), rtol=1e-5, atol=1e-5)
    probs = np.asarray(jref.gating_topk_ref(jnp.asarray(x), jnp.asarray(gates), top_k=e)[1])
    _topk_match(idx, np.asarray(i_r), probs)
    want = jops.stacked_gating(jnp.asarray(x), jnp.asarray(gates), mode=mode)
    np.testing.assert_allclose(lg, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("e,k,b", [(8, 3, 4), (16, 6, 9), (160, 6, 3)])
def test_gating_cluster_order_keeps_ties_at_lowest_index(mode, e, k, b):
    """Duplicate router columns give exactly equal logits in the emulated
    cluster order too (each column's chain, butterfly and slot sums have the
    same shape), and the warp argmax picks the lower index first."""
    rng = np.random.default_rng(e * k)
    d = 2048
    gates = (rng.standard_normal((1, d, e)) / np.sqrt(d)).astype(np.float32)
    for c in (5, 7):
        gates[0, :, c] = gates[0, :, 2]
    x = rng.standard_normal((b, d)).astype(np.float32)
    x = x + 4.0 * gates[0, :, 2][None, :] / np.square(gates[0, :, 2]).sum()
    lg, vals, idx = _gating_emulation(x, gates, k, ops.gating_plan(d, e, b))
    assert (lg[..., 2] == lg[..., 5]).all() and (lg[..., 2] == lg[..., 7]).all()
    _, v_r, i_r = jops.gating_topk(jnp.asarray(x), jnp.asarray(gates), top_k=k, mode=mode)
    np.testing.assert_array_equal(idx[..., :3], np.tile([2, 5, 7], (1, b, 1)))
    np.testing.assert_array_equal(idx, np.asarray(i_r))
    np.testing.assert_allclose(vals, np.asarray(v_r), rtol=1e-5, atol=1e-5)


def test_gating_at_a_cluster_size_needs_cuda():
    """The forced-cluster entry that chip_smoke.py sweeps has no plain path:
    CPU tensors raise for both router ops."""
    x, gates = torch.zeros((1, 64)), torch.zeros((1, 64, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ops._gating_at(8, x, gates, top_k=2)
    with pytest.raises(ValueError, match="CUDA"):
        ops._gating_at(1, x, gates)


# --------------------------------------------------------------------------
# dense dequant-matmul (cases of tests/test_kernels.py's dequant section)
# --------------------------------------------------------------------------
def _dq_pair(mode, x, bits, group, w_shape, seed, x_dtype="float32"):
    """(port's plain version, reference) for x @ dequant(quantize(w)): one
    JAX QTensor, its arrays handed to the port's QTensor."""
    w = np.random.default_rng(seed).normal(size=w_shape).astype(np.float32)
    jq = jquantize(jnp.asarray(w), bits=bits, group_size=group)
    q = QTensor(_t(np.array(jq.data)), _t(np.array(jq.scale)), bits, group, jq.orig_k)
    jdt = jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if x_dtype == "bfloat16" else torch.float32
    want = jops.dequant_matmul(jnp.asarray(x, jdt), jq, mode=mode)
    got = ops.dequant_matmul(_t(x).to(tdt), q)
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("m,k,n", [(8, 256, 128), (16, 512, 256), (8, 256, 384)])
def test_dequant_matmul_matches_reference(mode, bits, m, k, n):
    x = np.random.default_rng(m + k).normal(size=(m, k)).astype(np.float32)
    got, want = _dq_pair(mode, x, bits, 128, (k, n), seed=bits)
    _close(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,group", [(8, 64), (4, 128), (2, 32)])
def test_dequant_matmul_dtypes_and_groups(mode, x_dtype, bits, group):
    """bf16 x rounds alike on both sides before the float32 product."""
    x = np.random.default_rng(3).normal(size=(8, 256)).astype(np.float32)
    got, want = _dq_pair(mode, x, bits, group, (256, 128), seed=3, x_dtype=x_dtype)
    _close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_dequant_matmul_multi_kstep_accumulation(mode):
    x = np.random.default_rng(5).normal(size=(8, 1024)).astype(np.float32)
    got, want = _dq_pair(mode, x, 4, 128, (1024, 128), seed=5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-3)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k,n,bits", [(5, 384, 96, 8), (1, 256, 100, 4), (7, 128, 36, 2)])
def test_dequant_matmul_ragged_shapes(mode, m, k, n, bits):
    """M, N and K off the Pallas blocks: the reference pads, the port's
    kernel masks the edge."""
    x = np.random.default_rng(7).normal(size=(m, k)).astype(np.float32)
    got, want = _dq_pair(mode, x, bits, 128 if k % 128 == 0 else 64, (k, n), seed=7)
    _close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_dequant_matmul_leading_batch_dims(mode):
    x = np.random.default_rng(9).normal(size=(2, 3, 256)).astype(np.float32)
    got, want = _dq_pair(mode, x, 4, 128, (256, 128), seed=9)
    assert got.shape == (2, 3, 128)
    _close(got, want)


# clusters of each size the H100 runs at once with one decode block per SM
# (chip_smoke.py phase 3c prints ops.dequant_mmv_fit)
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


@pytest.mark.parametrize("m,k,n,bits,want", [(4, 2048, 16384, 4, 1), (4, 8192, 2048, 4, 6),
                                             (1, 8192, 2048, 4, 6), (64, 2048, 16384, 4, 2),
                                             (64, 8192, 2048, 4, 16), (256, 8192, 2048, 4, 4)])
def test_dequant_mm_splits_fill_the_card(m, k, n, bits, want):
    """Granite's FFN shapes at group 128 on 132 SMs: decode (M <= 4, the
    tensor-core decode kernel, one block per SM) splits K over a cluster
    only where the 128-column tiles leave the card idle: wi's 128 tiles not
    at all, wo's 16 tiles 6 ways (16 clusters of 7 or 8 do not fit); prefill (the tensor-core prefill kernel,
    64 x 128 tiles) splits until the grid holds the two blocks per SM the
    card reports for 4-bit codes in groups of 128: wo's 16 column tiles 16
    ways at M = 64."""
    kernel = ops.dequant_mm_kernel(m, n, torch.bfloat16, 128, True, True)
    assert kernel == ("mmv" if m <= 4 else "mma")
    blocks = 2 if kernel == "mma" else ops.DEQUANT_MM_BLOCKS_PER_SM
    s = ops.dequant_mm_splits(m, k, n, bits, 128, 132, kernel, blocks, H100_CLUSTERS)
    assert s == want and 1 <= s <= k // 128
    per = -(-(k // 128) // s)
    assert (s - 1) * per < k // 128              # no empty split


@pytest.mark.parametrize("group", [8, 16, 32, 128])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 4, 5, 64])
def test_dequant_mm_kernel_choice(m, x_dtype, group):
    """Tensor cores for bf16 x in groups of a multiple of 16: the decode
    kernel for M <= 4 rows, the prefill kernel above; the gemv kernel for
    float32 x and other groups."""
    tc = x_dtype == torch.bfloat16 and group % 16 == 0
    want = ("mmv" if m <= 4 else "mma") if tc else "gemv"
    assert ops.dequant_mm_kernel(m, 2048, x_dtype, group, True, True) == want


@pytest.mark.parametrize("m", [1, 4, 5, 64, 256])
def test_dequant_mm_kernel_unaligned_bf16_x_takes_gemv(m):
    """bf16 x off 16-byte alignment (a contiguous view at an odd element
    offset) cannot feed the tensor-core kernels' 16- and 8-byte copies, at
    decode or prefill M: the gemv kernel, correct at any alignment, serves
    it."""
    assert ops.dequant_mm_kernel(m, 2048, torch.bfloat16, 128, False, True) == "gemv"


@pytest.mark.parametrize("m,n,codes_aligned,want", [
    (1, 100, True, "gemv"), (4, 100, True, "gemv"), (3, 2056, True, "gemv"),
    (2, 2048, False, "gemv"), (4, 96, True, "mmv"), (2, 272, True, "mmv"),
    (24, 100, True, "mma"), (64, 2048, False, "mma")])
def test_dequant_mm_kernel_decode_needs_tma_codes(m, n, codes_aligned, want):
    """The decode kernel reads the codes through a TMA tensor map, which
    needs rows of a multiple of 16 bytes (N % 16 == 0) and a 16-byte
    aligned base: other decode calls go to the gemv kernel.  The prefill
    kernel copies any N % 4 at any 4-byte alignment."""
    assert ops.dequant_mm_kernel(m, n, torch.bfloat16, 128, True, codes_aligned) == want


@pytest.mark.parametrize("blocks,want", [(1, 8), (2, 16), (4, 32)])
def test_dequant_mm_splits_follow_occupancy(blocks, want):
    """The tensor-core split fills the blocks per SM the occupancy
    calculator reports: Granite's wo at M = 64 (16 blocks on 132 SMs) splits
    8 ways at one block per SM (8-bit stages), 16 at two, 32 at four."""
    s = ops.dequant_mm_splits(64, 8192, 2048, 4, 128, 132, "mma", blocks)
    assert s == want


def _mma_case(bits, k, m, n=256, group=128):
    rng = np.random.default_rng(bits * 1000 + k + m)
    w = _t((rng.normal(size=(k, n)) * 0.02).astype(np.float32))
    x = _t(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    return x, quantize(w, bits=bits, group_size=group)


def _mma_emulation(x, q, splits):
    """The tensor-core kernel's arithmetic: bf16 x times integer codes (each
    product exact in float32) summed per quant group into a float32
    partial, then partial * scale added to the split's accumulator, groups
    in order; splits of whole groups added in split order."""
    codes = unpack_codes(q.data, q.bits).to(torch.float32)
    xf = x.to(torch.float32)
    gs = q.group_size
    groups = x.shape[-1] // gs
    per = -(-groups // splits)
    total = None
    for s0 in range(0, groups, per):
        acc = torch.zeros((x.shape[0], codes.shape[1]))
        for gi in range(s0, min(groups, s0 + per)):
            part = xf[:, gi * gs:(gi + 1) * gs] @ codes[gi * gs:(gi + 1) * gs]
            acc = acc + part * q.scale[gi]
        total = acc if total is None else total + acc
    return total


DQ_CARD_TOL = dict(rtol=1e-4, atol=1e-4)      # chip_smoke.py's DQ_TOL


@pytest.mark.parametrize("m", [17, 64])
@pytest.mark.parametrize("k", [2048, 8192])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_dequant_mma_numeric_scheme_meets_card_tolerance(bits, k, m):
    """Exact bf16 codes on tensor cores with the group scale applied in
    float32 after each group, at the split the card would pick, against the
    plain version at the card's rtol/atol 1e-4."""
    x, q = _mma_case(bits, k, m)
    assert ops.dequant_mm_kernel(m, 256, x.dtype, q.group_size, True, True) == "mma"
    blocks = 1 if bits == 8 else 2           # the card's occupancy at group 128
    splits = ops.dequant_mm_splits(m, k, 256, bits, 128, 132, "mma", blocks)
    got = _mma_emulation(x, q, splits)
    want = ref.dequant_matmul_ref(x, q)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **DQ_CARD_TOL)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_dequant_mma_scale_folded_into_bf16_misses_card_tolerance(bits):
    """Rounding code * scale to a bf16 weight (2^-9 per weight) breaks
    rtol/atol 1e-4 on outputs of magnitude ~1: the scale stays out of the
    MMA."""
    x, q = _mma_case(bits, 2048, 64)
    want = ref.dequant_matmul_ref(x, q)
    folded = x.to(torch.float32) @ dequantize(q, dtype=torch.bfloat16).to(torch.float32)
    err = (folded - want).abs()
    assert bool((err > DQ_CARD_TOL["atol"] + DQ_CARD_TOL["rtol"] * want.abs()).any())
    np.testing.assert_allclose(_mma_emulation(x, q, 1).numpy(), want.numpy(), **DQ_CARD_TOL)


@pytest.mark.parametrize("k,n,group,fit,want", [
    (8192, 2048, 128, H100_CLUSTERS, 6), (8192, 2048, 128, None, 7),
    (2048, 16384, 128, H100_CLUSTERS, 1), (128, 512, 128, H100_CLUSTERS, 1),
    (1280, 2048, 128, H100_CLUSTERS, 6), (384, 512, 128, H100_CLUSTERS, 3),
    (8192, 2048, 256, H100_CLUSTERS, 6), (512, 256, 16, H100_CLUSTERS, 8),
    (2048, 8192, 128, H100_CLUSTERS, 2)])
def test_dequant_mmv_cluster_choice(k, n, group, fit, want):
    """The decode kernel's cluster grows from 1 while its blocks (column
    tiles x cluster) stay under three quarters of 132 SMs, every tile's
    cluster still fits at one block per SM, and there are groups to share:
    wo's 16 tiles stop at 6 on the H100 (15 clusters of 7 fit), at 7 on an
    ideal card; a single group is never split, 3 groups go 3 ways, 10
    groups 6 ways (unevenly)."""
    assert ops.dequant_mm_splits(4, k, n, 4, group, 132, "mmv", 1, fit) == want


def _mmv_emulation(x, q, ranks, warps=8):
    """The decode kernel's arithmetic: the rank's whole groups, split into
    runs of k16 steps over `warps` warps; bf16 x times integer codes (each
    product exact in float32) summed per k16 step into a float32 partial,
    partial * scale added to the warp's accumulator where the group or the
    run ends; the warps' sums added in warp order, then the ranks' in rank
    order."""
    codes = unpack_codes(q.data, q.bits).to(torch.float32)
    xf = x.to(torch.float32)
    spg = q.group_size // 16
    groups = x.shape[-1] // q.group_size
    step = [xf[:, 16 * s:16 * s + 16] @ codes[16 * s:16 * s + 16]
            for s in range(x.shape[-1] // 16)]
    total = None
    for r in range(ranks):
        r0, r1 = r * groups // ranks * spg, (r + 1) * groups // ranks * spg
        block = None
        for w in range(warps):
            s0, s1 = r0 + w * (r1 - r0) // warps, r0 + (w + 1) * (r1 - r0) // warps
            acc = torch.zeros((x.shape[0], codes.shape[1]))
            part = torch.zeros_like(acc)
            for s in range(s0, s1):
                part = part + step[s]
                if (s + 1) % spg == 0 or s + 1 == s1:
                    acc = acc + part * q.scale[s // spg]
                    part = torch.zeros_like(acc)
            block = acc if block is None else block + acc
        total = block if total is None else total + block
    return total


@pytest.mark.parametrize("k", [2048, 8192])
@pytest.mark.parametrize("group", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_dequant_mmv_numeric_scheme_meets_card_tolerance(m, bits, group, k):
    """The decode kernel's scheme (exact bf16 codes, a float32 partial per
    group and warp run times its scale, warps then cluster ranks added in
    order) at the cluster the card would pick for 256 columns, against the
    plain version at the card's rtol/atol 1e-4."""
    x, q = _mma_case(bits, k, m, group=group)
    assert ops.dequant_mm_kernel(m, 256, x.dtype, q.group_size, True, True) == "mmv"
    ranks = ops.dequant_mm_splits(m, k, 256, bits, group, 132, "mmv", 1, H100_CLUSTERS)
    got = _mmv_emulation(x, q, ranks)
    want = ref.dequant_matmul_ref(x, q)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **DQ_CARD_TOL)


def test_dequant_matmul_on_a_named_kernel_needs_cuda():
    """The kernel-by-name entry that chip_smoke.py times beside the wrapper
    has no plain path: CPU tensors raise."""
    x, q = _mma_case(4, 256, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ops._dequant_matmul_on("gemv", x, q)


# --------------------------------------------------------------------------
# grouped dequant GEMV (+ combine)
# --------------------------------------------------------------------------
PACK = {8: 1, 4: 2, 2: 4}


def _pool(rng, slots, k, n, bits, gs):
    data = rng.integers(-128, 128, (slots, k // PACK[bits], n)).astype(np.int8)
    scale = (rng.random((slots, k // gs, n)) * 0.05 + 1e-3).astype(np.float32)
    return data, scale


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_grouped_dequant_matmul_gathered_signature(mode, bits):
    """slot = arange(P) with per-pair tensors is the reference's gathered
    signature."""
    rng = np.random.default_rng(bits)
    p, k, n, gs = 4, 256, 128, 64
    x = rng.standard_normal((p, k)).astype(np.float32)
    data, scale = _pool(rng, p, k, n, bits, gs)
    want = jops.grouped_dequant_matmul(jnp.asarray(x), jnp.asarray(data),
                                       jnp.asarray(scale), bits=bits, group_size=gs,
                                       mode=mode)
    got = ops.grouped_dequant_matmul(_t(x), _t(data), _t(scale),
                                     torch.arange(p, dtype=torch.int32),
                                     bits=bits, group_size=gs)
    _close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_grouped_dequant_matmul_reads_pool_by_slot(mode):
    """Pairs read arbitrary (repeated) pool slots in place: equal to the
    reference run on the gathered copies."""
    rng = np.random.default_rng(9)
    k, n, gs, bits = 256, 128, 64, 4
    data, scale = _pool(rng, 6, k, n, bits, gs)
    slot = np.asarray([4, 0, 4, 2, 5], np.int32)
    x = rng.standard_normal((len(slot), k)).astype(np.float32)
    want = jops.grouped_dequant_matmul(jnp.asarray(x), jnp.asarray(data[slot]),
                                       jnp.asarray(scale[slot]), bits=bits,
                                       group_size=gs, mode=mode)
    got = ops.grouped_dequant_matmul(_t(x), _t(data), _t(scale), _t(slot),
                                     bits=bits, group_size=gs)
    _close(got, want)


COMBINE_CASES = {
    # non-decreasing rows with repeats, one pad pair, row 2 never visited
    "pads_and_unvisited": ([0, 0, 1, 3, 3, 4, 4], 4),
    # every pair on one row
    "one_row": ([1, 1, 1, 1], 3),
    # all pads: every row zero
    "all_pads": ([2, 2], 2),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("case", sorted(COMBINE_CASES))
def test_grouped_dequant_combine_matches_reference(mode, bits, case):
    rows, num_rows = COMBINE_CASES[case]
    rows = np.asarray(rows, np.int32)
    rng = np.random.default_rng(bits * 7 + len(rows))
    p, k, n, gs = len(rows), 256, 128, 64
    x = rng.standard_normal((p, k)).astype(np.float32)
    data, scale = _pool(rng, p, k, n, bits, gs)
    w = rng.random(p).astype(np.float32)
    w[rows == num_rows] = 0.0
    want = jops.grouped_dequant_combine(
        jnp.asarray(x), jnp.asarray(data), jnp.asarray(scale), jnp.asarray(rows),
        jnp.asarray(w), bits=bits, group_size=gs, num_rows=num_rows, mode=mode)
    got = ops.grouped_dequant_combine(
        _t(x), _t(data), _t(scale), torch.arange(p, dtype=torch.int32), _t(rows),
        _t(w), bits=bits, group_size=gs, num_rows=num_rows)
    assert got.shape == (num_rows, n)
    _close(got, want)
    for r in range(num_rows):
        if r not in rows:
            assert torch.all(got[r] == 0)


def test_grouped_dequant_combine_pool_slots_match_gathered():
    rng = np.random.default_rng(21)
    k, n, gs, bits = 256, 128, 64, 4
    data, scale = _pool(rng, 5, k, n, bits, gs)
    slot = np.asarray([3, 1, 1, 0], np.int32)
    rows = np.asarray([0, 0, 1, 2], np.int32)
    w = rng.random(4).astype(np.float32)
    w[rows == 2] = 0.0
    x = rng.standard_normal((4, k)).astype(np.float32)
    want = jops.grouped_dequant_combine(
        jnp.asarray(x), jnp.asarray(data[slot]), jnp.asarray(scale[slot]),
        jnp.asarray(rows), jnp.asarray(w), bits=bits, group_size=gs, num_rows=2,
        mode="xla")
    got = ops.grouped_dequant_combine(_t(x), _t(data), _t(scale), _t(slot), _t(rows),
                                      _t(w), bits=bits, group_size=gs, num_rows=2)
    _close(got, want)


@pytest.mark.parametrize("op", ["grouped_dequant_matmul", "grouped_dequant_combine"])
@pytest.mark.parametrize("bad", [3, -1])
def test_grouped_dequant_slot_out_of_range_raises(op, bad):
    """A slot past the pool or negative raises (the kernel aborts there)
    instead of wrapping around or dropping the pair."""
    rng = np.random.default_rng(5)
    k, n, gs, bits = 256, 128, 64, 4
    data, scale = _pool(rng, 3, k, n, bits, gs)
    x = _t(rng.standard_normal((2, k)).astype(np.float32))
    slot = torch.tensor([0, bad], dtype=torch.int32)
    kw = dict(bits=bits, group_size=gs)
    with pytest.raises(IndexError, match="slot outside"):
        if op == "grouped_dequant_matmul":
            ops.grouped_dequant_matmul(x, _t(data), _t(scale), slot, **kw)
        else:
            ops.grouped_dequant_combine(x, _t(data), _t(scale), slot,
                                        torch.tensor([0, 1], dtype=torch.int32),
                                        torch.ones(2), num_rows=2, **kw)


# --------------------------------------------------------------------------
# grouped dequant: the tensor-core kernel's shape rule, planner and order
# --------------------------------------------------------------------------
# clusters of each size the H100 runs at once with the tensor-core grouped
# kernel's blocks at a 2-stage ring (two per SM) and at 4-bit codes in
# groups of 64 (chip_smoke.py prints ops.grouped_info)
H100_GROUPED_CLUSTERS = {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30}
# (config, its lo matrices as (K, N)): up/gate (d_model -> 2 d_ff) and down
MOE_LO_SHAPES = {"mixtral-8x7b": ((4096, 28672), (14336, 4096)),
                 "phi-moe": ((4096, 12800), (6400, 4096))}


@pytest.mark.parametrize("arch", sorted(MOE_LO_SHAPES))
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_grouped_kernel_takes_every_moe_lo_launch(arch, x_dtype):
    """With the engine's lo defaults (4-bit codes, group 64) every lo launch
    of the Mixtral and Phi-MoE serves (bf16 x, 16-byte aligned) takes the
    tensor-core kernel; float32 x the two-pass kernel."""
    from repro_torch.configs import get_config
    from repro_torch.core import EngineConfig
    ecfg = EngineConfig()
    cfg = get_config(arch)
    want = "mmv" if x_dtype == torch.bfloat16 else "two_pass"
    for k, n in ((cfg.d_model, 2 * cfg.moe.d_ff_expert), (cfg.moe.d_ff_expert, cfg.d_model)):
        assert (k, n) in MOE_LO_SHAPES[arch]
        assert n % ops.DEQUANT_COL_ALIGN == 0 and k % ecfg.group_size == 0
        assert ops.grouped_dequant_kernel(x_dtype, ecfg.group_size, True) == want


@pytest.mark.parametrize("group,aligned,want", [
    (16, True, "mmv"), (32, True, "mmv"), (48, True, "mmv"), (64, True, "mmv"),
    (128, True, "mmv"), (256, True, "mmv"), (8, True, "two_pass"), (24, True, "two_pass"),
    (512, True, "two_pass"), (64, False, "two_pass")])
def test_grouped_kernel_shape_rule(group, aligned, want):
    """bf16 x in groups of a multiple of 16 up to 256, 16-byte aligned: the
    tensor-core kernel; other groups and unaligned x the two-pass kernel."""
    assert ops.grouped_dequant_kernel(torch.bfloat16, group, aligned) == want


@pytest.mark.parametrize("arch,which,want", [
    ("mixtral-8x7b", 0, 1), ("mixtral-8x7b", 1, 7), ("phi-moe", 0, 2), ("phi-moe", 1, 7)])
def test_grouped_plan_at_the_moe_shapes(arch, which, want):
    """At two blocks per SM the column tiles fill the H100 for Mixtral's wi
    (224 tiles: one rank); its wo (32 tiles) splits 7 ways, as 32 clusters
    of 7 run at once and 32 of 8 do not (30 fit); Phi-MoE's wi (100 tiles)
    splits 2 ways."""
    k, n = MOE_LO_SHAPES[arch][which]
    plan = ops.grouped_plan(k, n, 64, 132, H100_GROUPED_CLUSTERS)
    assert plan.ranks == want
    assert plan.blocks_per_sm == 2


# clusters of each size the H100 runs at once with one block per SM (what
# it reports for the dense decode kernel, whose blocks take one SM each)
H100_ONE_BLOCK_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
GROUPED_FITS = {"two_per_sm": H100_GROUPED_CLUSTERS, "one_per_sm": H100_ONE_BLOCK_CLUSTERS}


@pytest.mark.parametrize("fit", sorted(GROUPED_FITS))
@pytest.mark.parametrize("k,n,group", [
    (4096, 28672, 64), (14336, 4096, 64), (6400, 4096, 64), (4096, 12800, 64),
    (512, 256, 64), (448, 4096, 64), (64, 256, 64), (1024, 256, 16),
    (3072, 384, 48), (2048, 272, 128), (14336, 4096, 256), (960, 128, 64)])
def test_grouped_plan_covers_k_once_and_fits_the_card(k, n, group, fit):
    """The planner's ranks cover K once, in whole groups, in rank order,
    none empty; every column tile gets a cluster of at most 8 ranks; the
    blocks per SM are those the card's fit at cluster size 1 gives on 132
    SMs, the grid stays within them, and every tile's cluster runs at once;
    one rank more would break one of these."""
    clusters = GROUPED_FITS[fit]
    plan = ops.grouped_plan(k, n, group, 132, clusters)
    groups = k // group
    tiles = -(-n // ops.GROUPED_TILE_N)
    sl = plan.slices(groups)
    assert sl[0][0] == 0 and sl[-1][1] == groups
    assert all(a < b for a, b in sl) and all(sl[i][1] == sl[i + 1][0] for i in range(len(sl) - 1))
    assert 1 <= plan.ranks <= min(ops.GROUPED_MAX_CLUSTER, groups)
    assert plan.blocks_per_sm == clusters[1] // 132
    assert tiles * plan.ranks <= plan.blocks_per_sm * 132 or plan.ranks == 1
    assert tiles <= clusters[plan.ranks] or plan.ranks == 1
    more = plan.ranks + 1
    assert (more > min(ops.GROUPED_MAX_CLUSTER, groups)
            or tiles * more > plan.blocks_per_sm * 132 or tiles > clusters[more])


def test_grouped_plan_forced_cluster_passes_through():
    """A forced cluster size passes through at any fit; the blocks per SM
    follow the fit at cluster size 1."""
    for fit, per_sm in (("two_per_sm", 2), ("one_per_sm", 1)):
        plan = ops.grouped_plan(14336, 4096, 64, 132, GROUPED_FITS[fit], ranks=3)
        assert (plan.ranks, plan.blocks_per_sm) == (3, per_sm)


def test_grouped_kernel_entry_needs_cuda():
    """The forced-plan entry that chip_smoke.py sweeps has no plain path:
    CPU tensors raise; the per-kernel counters stay empty on the CPU."""
    ops.reset_dispatch_counts()
    rng = np.random.default_rng(3)
    data, scale = _pool(rng, 2, 256, 128, 4, 64)
    x = torch.randn(2, 256)
    slot = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops._grouped_at(2, x, _t(data), _t(scale), slot, bits=4, group_size=64)
    ops.grouped_dequant_matmul(x, _t(data), _t(scale), slot, bits=4, group_size=64)
    assert ops.grouped_launches() == {}
    assert ops.dispatch_counts() == {"grouped_dequant_matmul.torch": 1}
    ops.reset_dispatch_counts()


def _fma_t(a, b, c):
    """float32 tensors a * b + c rounded once, as the card's FFMA."""
    return (a.double() * b.double() + c.double()).float()


def _grouped_emulation(x, data, scale, slot, bits, group, ranks, rows=None, w=None,
                       num_rows=None):
    """The tensor-core kernel's summation order: passes of 8 pairs; each
    rank's whole groups cut into stages of 16 / bits k16 steps, runs of
    whole stages per warp (8 warps); per k16 step the exact bf16 x times
    integer codes summed in float32 into a group partial, which gets its
    float32 scale with one FMA per accumulator where the group or the
    warp's run ends; a pair adds nothing for the slots it does not read;
    the warps' sums added in warp order, the ranks' in rank order; the
    combine adds each row's pairs in pair order (FMA) on top of what the
    earlier passes left there.  Pads (rows outside 0..num_rows-1) are never
    streamed."""
    p, k = x.shape
    n = data.shape[-1]
    xf = x.float()
    u = ops.GROUPED_STAGE_ROWS // (2 * bits)
    spg = group // 16
    groups = k // group
    codes = {s: unpack_codes(data[s], bits).float() for s in set(slot.tolist())}
    y = torch.zeros((p, n))
    for r in range(ranks):
        r0, r1 = r * groups // ranks * spg, (r + 1) * groups // ranks * spg
        rank_stages = -(-(r1 - r0) // u)
        block = torch.zeros((p, n))
        for wi in range(8):
            st0 = wi * rank_stages // 8
            s0 = r0 + st0 * u
            steps = max(0, min(r1, r0 + (wi + 1) * rank_stages // 8 * u) - s0)
            acc = torch.zeros((p, n))
            for q in range(p):
                if rows is not None and not 0 <= int(rows[q]) < num_rows:
                    continue
                c, sc = codes[int(slot[q])], scale[int(slot[q])]
                part = torch.zeros(n)
                left = spg - s0 % spg
                for i in range(steps):
                    s = s0 + i
                    part = part + xf[q, 16 * s:16 * s + 16] @ c[16 * s:16 * s + 16]
                    left -= 1
                    if left == 0 or i + 1 == steps:
                        acc[q] = _fma_t(part, sc[s // spg], acc[q])
                        part = torch.zeros(n)
                        left = spg
            block = block + acc
        y = y + block
    if rows is None:
        return y
    out = torch.zeros((num_rows, n))
    for q in range(p):
        rr = int(rows[q])
        if 0 <= rr < num_rows:
            out[rr] = _fma_t(w[q].expand(n), y[q], out[rr])
    return out


GROUPED_ORDER_CASES = {
    # (K, N, bits, group, slots, rows, num_rows)
    "matmul shared slot": (2048, 256, 4, 64, [2, 0, 2], None, None),
    "matmul 2-bit group 128": (2048, 128, 2, 128, [1, 0], None, None),
    "matmul 8-bit group 48": (1536, 128, 8, 48, [0, 1, 1], None, None),
    "combine pads and unvisited row": (1024, 256, 4, 64, [1, 0, 1, 2, 3, 3],
                                       [0, 0, 1, 3, 3, 4], 4),
    "combine 11 pairs over 2 passes": (512, 128, 4, 32, [i % 4 for i in range(11)],
                                       [i // 3 for i in range(11)], 4),
    "combine wo-like ranks": (4096, 128, 4, 64, [0, 1], [0, 0], 1),
}


@pytest.mark.parametrize("case", sorted(GROUPED_ORDER_CASES))
def test_grouped_mmv_order_meets_card_tolerance(case):
    """The tensor-core kernel's order of float32 sums, at the cluster size
    the planner picks on the H100, held to the JAX package's op (its jnp
    oracle, on each pair's gathered expert) at chip_smoke.py's tolerance
    (rtol 1e-4, atol 1e-3), with shared slots, pads, an unvisited row and
    more than one pass of 8 pairs."""
    k, n, bits, group, sl, rw, nr = GROUPED_ORDER_CASES[case]
    rng = np.random.default_rng(k + n + bits + group + len(sl))
    data, scale = _pool(rng, max(sl) + 1, k, n, bits, group)
    data, scale = _t(data), _t(scale)
    x = _t(rng.standard_normal((len(sl), k)).astype(np.float32)).to(torch.bfloat16)
    slot = torch.tensor(sl, dtype=torch.int32)
    ranks = ops.grouped_plan(k, n, group, 132, H100_GROUPED_CLUSTERS).ranks
    # the reference's gathered signature: pair p's expert at index p
    jx = jnp.asarray(x.float().numpy())
    jdata, jscale = jnp.asarray(data.numpy()[sl]), jnp.asarray(scale.numpy()[sl])
    if rw is None:
        got = _grouped_emulation(x, data, scale, slot, bits, group, ranks)
        want = jops.grouped_dequant_matmul(jx, jdata, jscale, bits=bits, group_size=group,
                                           mode="xla")
    else:
        rows = torch.tensor(rw, dtype=torch.int32)
        w = _t(rng.random(len(sl)).astype(np.float32))
        w[rows >= nr] = 0.0
        got = _grouped_emulation(x, data, scale, slot, bits, group, ranks, rows, w, nr)
        want = jops.grouped_dequant_combine(jx, jdata, jscale, jnp.asarray(rows.numpy()),
                                            jnp.asarray(w.numpy()), bits=bits,
                                            group_size=group, num_rows=nr, mode="xla")
        for r in range(nr):
            if r not in rw:
                assert torch.all(got[r] == 0)
    assert ranks > 1 or k <= 1024
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)


# --------------------------------------------------------------------------
# paged flash decode (cases of tests/test_kernels.py's paged section)
# --------------------------------------------------------------------------
PAGED_IMPLS = ["pallas", "oracle"]


def _paged_inputs(b, hq, hkv, hd, psz, maxp, num_pages, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, hd)).astype(np.float32)
    pk = rng.normal(size=(num_pages, psz, hkv, hd)).astype(np.float32)
    pv = rng.normal(size=(num_pages, psz, hkv, hd)).astype(np.float32)
    table = rng.integers(0, num_pages, (b, maxp)).astype(np.int32)
    return q, pk, pv, table


def _paged_pair(impl, q, pk, pv, table, lengths, dtype=np.float32, softcap=0.0):
    """(port's plain version, reference) on the same inputs, cast to
    `dtype` on both sides (float32 -> bfloat16 rounds alike in both)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    lengths = np.asarray(lengths, np.int32)
    jargs = [jnp.asarray(a, jdt) for a in (q, pk, pv)] + [jnp.asarray(table),
                                                          jnp.asarray(lengths)]
    if impl == "pallas":
        want = paged_flash_decode_pallas(*jargs, interpret=True, softcap=softcap)
    else:
        want = jref.paged_flash_decode_ref(*jargs, softcap=softcap)
    got = ops.paged_flash_decode(*[_t(a).to(tdt) for a in (q, pk, pv)], _t(table),
                                 _t(lengths), softcap=softcap)
    assert got.dtype == torch.float32 and got.shape == q.shape
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("impl", PAGED_IMPLS)
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (12, 2)])
@pytest.mark.parametrize("psz,maxp", [(4, 6), (8, 3)])
def test_paged_flash_decode_matches_reference(impl, hq, hkv, psz, maxp):
    q, pk, pv, table = _paged_inputs(3, hq, hkv, 32, psz, maxp, 12, seed=hq * 10 + psz)
    lengths = np.random.default_rng(1).integers(1, psz * maxp + 1, (3,))
    got, want = _paged_pair(impl, q, pk, pv, table, lengths)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", PAGED_IMPLS)
@pytest.mark.parametrize("lengths", [[0, 0], [1, 0], [4, 8], [12, 1]])
def test_paged_flash_decode_edge_lengths(impl, lengths):
    """Length 0 gives exact zeros; page-boundary and one-token lengths."""
    q, pk, pv, table = _paged_inputs(2, 4, 2, 16, 4, 3, 8, seed=3)
    got, want = _paged_pair(impl, q, pk, pv, table, lengths)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.isfinite(got).all()
    for r, n in enumerate(lengths):
        if n == 0:
            np.testing.assert_array_equal(got[r], 0.0)


@pytest.mark.parametrize("impl", PAGED_IMPLS)
def test_paged_flash_decode_junk_table_rows_isolated(impl):
    """A row whose table aliases a neighbour's pages changes only its own
    output."""
    q, pk, pv, table = _paged_inputs(3, 4, 2, 16, 4, 3, 8, seed=5)
    lengths = [7, 12, 3]
    base, _ = _paged_pair(impl, q, pk, pv, table, lengths)
    junk = table.copy()
    junk[1] = table[0, 0]
    got, want = _paged_pair(impl, q, pk, pv, junk, lengths)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[[0, 2]], base[[0, 2]])


@pytest.mark.parametrize("impl", PAGED_IMPLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_flash_decode_dtypes(impl, dtype):
    q, pk, pv, table = _paged_inputs(2, 4, 2, 32, 4, 4, 8, seed=7)
    got, want = _paged_pair(impl, q, pk, pv, table, [5, 16], dtype=dtype)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", PAGED_IMPLS)
def test_paged_flash_decode_softcap(impl):
    """Softcap applies before the mask, as in the reference."""
    q, pk, pv, table = _paged_inputs(2, 4, 4, 16, 4, 3, 8, seed=9)
    got, want = _paged_pair(impl, q, pk, pv, table, [5, 11], softcap=5.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    uncapped, _ = _paged_pair(impl, q, pk, pv, table, [5, 11])
    assert np.abs(got - uncapped).max() > 1e-6


@pytest.mark.parametrize("bad", [8, -1])
def test_paged_flash_decode_page_out_of_range_raises(bad):
    """A page id outside the pool raises (the kernel aborts there) instead
    of wrapping around or reading past the pool."""
    q, pk, pv, table = _paged_inputs(2, 4, 2, 16, 4, 3, 8, seed=11)
    table[1, 2] = bad
    with pytest.raises(IndexError, match="page id outside"):
        ops.paged_flash_decode(_t(q), _t(pk), _t(pv), _t(table),
                               torch.tensor([3, 5], dtype=torch.int32))


@pytest.mark.parametrize("b,hkv,maxp,want", [(4, 8, 2, 2), (4, 8, 64, 33), (1, 8, 512, 132),
                                             (64, 8, 512, 3)])
def test_decode_splits_fill_the_card(b, hkv, maxp, want):
    """Small B * Hkv gets more page splits (at most one per page), so the
    pass-1 grid fills an H100's 132 SMs at 8 resident blocks each."""
    s = ops.decode_splits(b, hkv, maxp, 8 * 132)
    assert s == want and 1 <= s <= maxp


# --------------------------------------------------------------------------
# flash decode over a contiguous cache (cases of tests/test_kernels.py)
# --------------------------------------------------------------------------
def _fd_inputs(b, s, hq, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, hd)).astype(np.float32),
            rng.normal(size=(b, s, hkv, hd)).astype(np.float32),
            rng.normal(size=(b, s, hkv, hd)).astype(np.float32))


def _fd_pair(mode, q, k, v, lengths, dtype="float32", block_s=128):
    """(port's plain version, reference ops.flash_decode) on the same
    inputs; the reference repeats the kv heads itself."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    lengths = np.asarray(lengths, np.int32)
    want = jops.flash_decode(*[jnp.asarray(a, jdt) for a in (q, k, v)], jnp.asarray(lengths),
                             mode=mode, block_s=block_s)
    got = ops.flash_decode(*[_t(a).to(tdt) for a in (q, k, v)], _t(lengths))
    assert got.dtype == torch.float32 and got.shape == q.shape
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,s,h,hd", [(2, 512, 4, 64), (1, 256, 2, 128), (3, 1024, 8, 64)])
def test_flash_decode_matches_reference(mode, b, s, h, hd):
    q, k, v = _fd_inputs(b, s, h, h, hd, seed=b * 100 + s)
    lengths = np.random.default_rng(b * 100 + s).integers(1, s + 1, (b,))
    got, want = _fd_pair(mode, q, k, v, lengths)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_dtypes(mode, dtype):
    q, k, v = _fd_inputs(2, 512, 4, 4, 64, seed=42)
    got, want = _fd_pair(mode, q, k, v, [100, 512], dtype=dtype)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", MODES)
def test_flash_decode_gqa_and_ragged_cache(mode):
    """GQA (8 and 12 query heads on 2 kv heads: g = 4 and g = 6, as
    Nemotron's 48/8) and S = 300 off the 128-row block."""
    for hq in (8, 12):
        q, k, v = _fd_inputs(2, 300, hq, 2, 64, seed=7)
        got, want = _fd_pair(mode, q, k, v, [300, 17])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_flash_decode_length_one_in_a_long_cache(mode):
    q, k, v = _fd_inputs(1, 512, 2, 2, 64, seed=9)
    got, want = _fd_pair(mode, q, k, v, [1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0], v[0, 0], rtol=1e-6, atol=1e-6)   # g = 1


@pytest.mark.parametrize("s", [256, 300])
def test_flash_decode_length_zero_is_the_mean_of_v(s):
    """Length 0 masks every row: the JAX oracle's softmax weighs all S rows
    alike, and the port follows it (the Pallas kernel averages over S padded
    to its block instead, which differs when S = 300)."""
    q, k, v = _fd_inputs(2, s, 4, 2, 64, seed=11)
    got, want = _fd_pair("xla", q, k, v, [0, 5])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0], np.repeat(v[0].mean(0), 2, axis=0), atol=1e-5)
    want_ref = jref.flash_decode_ref(*[jnp.asarray(a) for a in
                                       (q, np.repeat(k, 2, 2), np.repeat(v, 2, 2))],
                                     jnp.asarray([0, 5], jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want_ref), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the Hopper flash-decode kernels' numeric scheme (csrc/flash_decode.cuh)
# --------------------------------------------------------------------------
RING_TILE, RING_WARPS = 64, 4          # tokens per ring stage, consumer warps
RING_TOL = dict(rtol=1e-4, atol=1e-4)  # the card's tolerance for both kernels


def _bf16_split(x):
    """x = hi + lo with hi = bf16(x), lo = bf16(x - hi), as float32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _ring_decode_emulation(q, k, v, lengths, *, unit, splits, softcap=0.0,
                           uniform_empty=False, p_lo=True):
    """The bf16 ring kernel's arithmetic in plain torch, on a slot-contiguous
    logical view k, v (B, T, Hkv, hd) of bf16 values: q split hi/lo to bf16
    (lo = 0 for a bf16 q), float32 dot products; per split (`unit`-token
    pieces, as the kernel's page split), 64-token tiles in which warp w owns
    tokens [16w, 16w + 16) and keeps its own online softmax (log2 domain, P
    split hi/lo to bf16, l summing hi + lo); warps merged in warp order,
    then the splits with weights from their maximum, o / max(l, 1e-30).
    With p_lo=False, P is bf16 alone and l sums the float32 p (what a kernel
    without the split does).
    A length <= 0 gives zeros, or with uniform_empty every one of the T rows
    at logit 0 (the contiguous kernel)."""
    b, hq, hd = q.shape
    t_all, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qh, ql = _bf16_split(q.float())
    qh, ql = qh.reshape(b, hkv, g, hd), ql.reshape(b, hkv, g, hd)
    kf, vf = k.float(), v.float()
    scale = 1.0 / hd ** 0.5
    out = torch.zeros((b, hkv, g, hd))
    neg = -1e30
    for s in range(b):
        n = int(lengths[s])
        uniform = n <= 0 and uniform_empty
        n = t_all if uniform else max(0, min(n, t_all))
        chunk = -(-(-(-n // unit)) // splits) * unit
        parts = []
        for sp in range(splits):
            t0, t1 = min(sp * chunk, n), min((sp + 1) * chunk, n)
            m = torch.full((RING_WARPS, hkv, g), neg)
            lsum = torch.zeros((RING_WARPS, hkv, g))
            o = torch.zeros((RING_WARPS, hkv, g, hd))
            for tt in range(t0, t1, RING_TILE):
                for w in range(RING_WARPS):
                    r0 = tt + 16 * w
                    if r0 >= t1:
                        continue
                    rows = torch.arange(r0, r0 + 16).clamp(max=t1 - 1)
                    valid = torch.arange(r0, r0 + 16) < t1
                    kt = kf[s, rows].permute(1, 0, 2)                 # (hkv, 16, hd)
                    vt = vf[s, rows].permute(1, 0, 2)
                    x = (torch.einsum("hgd,htd->hgt", qh[s], kt)
                         + torch.einsum("hgd,htd->hgt", ql[s], kt)) * scale
                    if softcap > 0:
                        x = torch.tanh(x / softcap) * softcap
                    x = torch.zeros_like(x) if uniform else x * 1.4426950408889634
                    x = torch.where(valid, x, torch.full_like(x, neg))
                    mn = torch.maximum(m[w], x.amax(-1))
                    corr = torch.exp2(m[w] - mn)
                    p = torch.where(valid, torch.exp2(x - mn[..., None]), torch.zeros_like(x))
                    ph, pl = _bf16_split(p)
                    if not p_lo:
                        pl = torch.zeros_like(pl)
                    lsum[w] = lsum[w] * corr + ((ph + pl).sum(-1) if p_lo else p.sum(-1))
                    m[w] = mn
                    o[w] = (o[w] * corr[..., None] + torch.einsum("hgt,htd->hgd", ph, vt)
                            + torch.einsum("hgt,htd->hgd", pl, vt))
            mx = m.amax(0)
            c = torch.exp2(m - mx)
            acc, tot = torch.zeros((hkv, g, hd)), torch.zeros((hkv, g))
            for w in range(RING_WARPS):
                acc = acc + o[w] * c[w][..., None]
                tot = tot + lsum[w] * c[w]
            parts.append((mx, tot, acc))
        if splits == 1:
            mx, tot, acc = parts[0]
            out[s] = acc / tot.clamp(min=1e-30)[..., None]
            continue
        big = torch.stack([p[0] for p in parts]).amax(0)
        acc, tot = torch.zeros((hkv, g, hd)), torch.zeros((hkv, g))
        for mx, lt, ot in parts:              # in split order
            c = torch.exp2(mx - big)
            acc = acc + ot * c[..., None]
            tot = tot + lt * c
        out[s] = acc / tot.clamp(min=1e-30)[..., None]
    return out.reshape(b, hq, hd)


def _ring_inputs(length, g, q_dtype, seed, psz=16, hkv=2, hd=64):
    """Two slots (lengths `length` and length // 2) of bf16 K/V pages in a
    permuted table, and the same tokens as a contiguous cache."""
    rng = np.random.default_rng(seed)
    lengths = [length, length // 2]
    maxp = -(-length // psz)
    num_pages = 2 * maxp
    bf = lambda a: _t(a.astype(np.float32)).to(torch.bfloat16)   # noqa: E731
    q = _t(rng.normal(size=(2, g * hkv, hd)).astype(np.float32))
    q = q.to(torch.bfloat16) if q_dtype == "bfloat16" else q
    pk = bf(rng.normal(size=(num_pages, psz, hkv, hd)))
    pv = bf(rng.normal(size=(num_pages, psz, hkv, hd)))
    table = _t(rng.permutation(num_pages).reshape(2, maxp).astype(np.int32))
    k = pk[table.long()].reshape(2, maxp * psz, hkv, hd)
    v = pv[table.long()].reshape(2, maxp * psz, hkv, hd)
    return q, pk, pv, table, k, v, torch.tensor(lengths, dtype=torch.int32)


RING_CASES = ([("paged", n, cap, qd, g) for n in (1, 37, 64, 65, 4096) for cap in (0.0, 5.0)
               for qd in ("bfloat16", "float32") for g in (1, 4)]
              + [("contiguous", n, 0.0, qd, g) for n in (1, 37, 64, 65, 4096)
                 for qd in ("bfloat16", "float32") for g in (1, 4)]
              # g = 6 (Nemotron, InternVL2): two of the 8 P.V columns dead
              + [("paged", n, cap, qd, 6) for n in (1, 37, 65, 4096) for cap in (0.0, 5.0)
                 for qd in ("bfloat16", "float32")]
              + [("contiguous", n, 0.0, qd, 6) for n in (1, 65, 4096)
                 for qd in ("bfloat16", "float32")])


@pytest.mark.parametrize("kind,length,softcap,q_dtype,g", RING_CASES)
def test_ring_decode_numeric_scheme_meets_card_tolerance(kind, length, softcap, q_dtype, g):
    """The bf16 kernels' arithmetic (hi/lo bf16 P and q, per-warp online
    softmax over 16-token subsets of 64-token tiles, warps then splits merged
    in order) against the plain versions at the card's rtol/atol 1e-4, with
    the split the card would pick at 2 blocks per SM on 132 SMs."""
    q, pk, pv, table, k, v, lengths = _ring_inputs(length, g, q_dtype, seed=length + 7 * g)
    units = table.shape[1]
    splits = ops.decode_splits(2, 2, units, 2 * 132)
    if kind == "paged":
        want = ref.paged_flash_decode_ref(q, pk, pv, table, lengths, softcap=softcap)
    else:
        want = ref.flash_decode_ref(q, k.repeat_interleave(g, dim=2),
                                    v.repeat_interleave(g, dim=2), lengths)
    got = _ring_decode_emulation(q, k, v, lengths, unit=16, splits=splits, softcap=softcap,
                                 uniform_empty=kind == "contiguous")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **RING_TOL)


@pytest.mark.parametrize("g", [1, 4])
def test_ring_decode_bf16_p_alone_misses_card_tolerance(g):
    """Without the lo part, P rounded to bf16 (2^-9) breaks rtol/atol 1e-4 at
    a short length, where |o| is ~0.1-0.2: the hi/lo split is needed."""
    q, pk, pv, table, k, v, lengths = _ring_inputs(37, g, "bfloat16", seed=37 + 7 * g)
    want = ref.paged_flash_decode_ref(q, pk, pv, table, lengths)
    got = _ring_decode_emulation(q, k, v, lengths, unit=16, splits=1, p_lo=False)
    err = (got - want).abs()
    assert bool((err > RING_TOL["atol"] + RING_TOL["rtol"] * want.abs()).any())
    split = _ring_decode_emulation(q, k, v, lengths, unit=16, splits=1)
    np.testing.assert_allclose(split.numpy(), want.numpy(), **RING_TOL)


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------
def test_dispatch_counts_and_device_routing():
    ops.reset_dispatch_counts()
    x = torch.randn(2, 64)
    g = torch.randn(1, 64, 8)
    ops.gating_topk(x, g, top_k=2)
    ops.stacked_gating(x, g)
    assert ops.dispatch_counts() == {"gating_topk.torch": 1, "stacked_gating.torch": 1}
    with pytest.raises(ValueError, match="no implementation"):
        ops.gating_topk(x.to("meta"), g.to("meta"), top_k=2)
    with pytest.raises(ValueError, match="different devices"):
        ops.stacked_gating(x, g.to("meta"))
    assert ops.dispatch_counts() == {"gating_topk.torch": 1, "stacked_gating.torch": 1}
    ops.reset_dispatch_counts()
    assert ops.dispatch_counts() == {}


@pytest.mark.parametrize("k,gs,pack,want", [(4096, 64, 2, 512), (14336, 64, 2, 512),
                                            (6400, 64, 2, 320), (128, 64, 4, 128),
                                            (192, 64, 1, 192)])
def test_k_chunk_tiles_whole_groups(k, gs, pack, want):
    c = ops.k_chunk(k, gs, pack)
    assert c == want and k % c == 0 and c % gs == 0 and c % pack == 0


@pytest.mark.parametrize("p,k,n,want", [(8, 4096, 28672, 512), (2, 4096, 28672, 128),
                                        (8, 14336, 4096, 256), (2, 14336, 4096, 64)])
def test_dequant_chunk_fills_the_card(p, k, n, want):
    """Few pairs get shorter K-chunks, so the pass-1 grid keeps several
    blocks on each of an H100's 132 SMs."""
    c = ops.dequant_chunk(p, k, n, 64, 2, 132)
    assert c == want and k % c == 0 and c % 64 == 0
    tiles = -(-n // ops.DEQUANT_TILE_N)
    assert p * tiles * (k // c) >= ops.DEQUANT_BLOCKS_PER_SM * 132
