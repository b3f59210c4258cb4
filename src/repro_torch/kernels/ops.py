"""Dispatch for the hand-written kernels of the serving path.

The device of the tensors decides the implementation, and nothing else does:

    CPU tensors   -> the plain PyTorch version in ``ref.py``
    CUDA tensors  -> the Hopper kernel in ``csrc/`` (built on first use)
    anything else -> ValueError

There is no fallback: on CUDA tensors a wrapper launches its kernel or
raises (a bad shape, dtype or layout, a failed build, or a launch error
returned by ``cudaGetLastError``).  No environment variable switches the
card to the plain version.

Every call records which implementation ran in a per-op counter keyed
``"<op>.cuda"`` or ``"<op>.torch"`` (``dispatch_counts()``); the engine
surfaces it as ``stats()["kernel_dispatch"]`` so a run can show that the
serving path really went through the kernels.  A wrapper counts a launch
exactly where it launches, and the CPU path counts one call of the plain
version.  ``capture.CapturedStep`` records its routes in the same counters
(``"<step>.graph"``, ``".eager"``, ``".capture"``) and, since a graph
replay calls no wrapper, adds the captured step's launches to them on every
replay.  Wrappers allocate their outputs with ``torch.empty`` on the
current stream and never synchronise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.quant.quantize import PACK_FACTOR, QTensor

_DISPATCH_COUNTS: Dict[str, int] = {}
_DEQUANT_MM_LAUNCHES: Dict[str, int] = {}
_GROUPED_LAUNCHES: Dict[str, int] = {}

# widest router a gating kernel takes (Phi-MoE has 16 experts, DeepSeek 160)
MAX_EXPERTS = 256
# columns a dequant-kernel thread reads with one 16-byte load
DEQUANT_COL_ALIGN = 16
# largest K-chunk a dequant block stages in shared memory (floats)
DEQUANT_MAX_CHUNK = 512
# output columns of one pass-1 dequant block (kThreads * kCols in dequant.cu)
DEQUANT_TILE_N = 2048
# pass-1 blocks per SM the chunk choice aims for (enough bytes in flight)
DEQUANT_BLOCKS_PER_SM = 6


def _record(op: str, impl: str) -> None:
    key = f"{op}.{impl}"
    _DISPATCH_COUNTS[key] = _DISPATCH_COUNTS.get(key, 0) + 1


def _counters() -> Tuple[Dict[str, int], Dict[str, int], Dict[str, int]]:
    """The three live launch counters (per op, per dequant-matmul kernel, per
    grouped kernel), which ``capture.CapturedStep`` advances on a replay."""
    return _DISPATCH_COUNTS, _DEQUANT_MM_LAUNCHES, _GROUPED_LAUNCHES


def dispatch_counts() -> Dict[str, int]:
    """Copy of the per-op counters, keyed ``"<op>.<cuda|torch>"``."""
    return dict(_DISPATCH_COUNTS)


def reset_dispatch_counts() -> None:
    _DISPATCH_COUNTS.clear()
    _DEQUANT_MM_LAUNCHES.clear()
    _GROUPED_LAUNCHES.clear()


def dequant_mm_launches() -> Dict[str, int]:
    """Launches of each dequant-matmul kernel ("gemv", "mma", "mmv") since
    the last ``reset_dispatch_counts``; they add up to
    ``"dequant_matmul.cuda"``."""
    return dict(_DEQUANT_MM_LAUNCHES)


def grouped_launches() -> Dict[str, int]:
    """Launches of each grouped dequant kernel since the last
    ``reset_dispatch_counts``, keyed ``"<op>.<mmv|two_pass>"``; per op they
    add up to ``"<op>.cuda"``."""
    return dict(_GROUPED_LAUNCHES)


def _route(op: str, *tensors: torch.Tensor) -> str:
    """"torch" when every tensor lies on the CPU, "cuda" when every tensor
    lies on one CUDA device; raise otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{op}: tensors on different devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return "torch"
    if dev.type == "cuda":
        return "cuda"
    raise ValueError(f"{op}: no implementation for device {dev}")


def _check(op: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{op}: {msg}")


def _check_contig(op: str, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        _check(op, t.is_contiguous(), f"{name} must be contiguous")


def _x_flag(op: str, x: torch.Tensor) -> int:
    _check(op, x.dtype in (torch.bfloat16, torch.float32),
           f"x must be bfloat16 or float32, got {x.dtype}")
    return int(x.dtype == torch.bfloat16)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(op: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{op}: CUDA launch failed with cudaError {err}")


def k_chunk(k: int, group_size: int, pack: int, cap: int = DEQUANT_MAX_CHUNK) -> int:
    """Largest K-chunk <= cap that divides K and covers whole quant groups
    (and therefore whole packed bytes): the shared-memory x stage of one
    dequant block."""
    best, m = group_size, group_size
    while m <= min(cap, k):
        if k % m == 0:
            best = m
        m += group_size
    return best


def dequant_chunk(p: int, k: int, n: int, group_size: int, pack: int,
                  sm_count: int) -> int:
    """K-chunk of the dequant kernels' pass 1: the longest legal chunk
    (``k_chunk``) whose grid of (N-tiles x K-chunks x pairs) blocks still
    puts DEQUANT_BLOCKS_PER_SM blocks on every SM, so a handful of pairs
    keeps enough loads in flight to stream from device memory."""
    tiles = -(-n // DEQUANT_TILE_N)
    chunk = k_chunk(k, group_size, pack)
    while (chunk > group_size
           and p * tiles * (k // chunk) < DEQUANT_BLOCKS_PER_SM * sm_count):
        chunk = k_chunk(k, group_size, pack, cap=chunk - group_size)
    return chunk


_SM_COUNT: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


# --------------------------------------------------------------------------
# gating
# --------------------------------------------------------------------------

# threads of one cluster-kernel block, gate loads each thread keeps in
# flight per tile, token rows per pass, the floats of the block's shared x
# tile / partial buffer and the largest cluster (kThreads, kLoads,
# kMaxRows, kBufFloats and kMaxCluster in gating.cu; ``gating_layout``
# reads them from the built kernel)
GATING_THREADS = 256
GATING_LOADS = 4
GATING_ROWS = 8
GATING_BUF_FLOATS = 8192
GATING_MAX_CLUSTER = 8
_GATING_REGS: Dict[tuple, int] = {}


class GatingPlan(NamedTuple):
    """How the cluster kernel cuts one router (``gating_plan``)."""
    vec: int        # gate floats per load: 4 (16-byte loads) or 1
    groups: int     # column groups of `vec` experts (E / vec)
    lanes: int      # groups padded to a power of two
    rows: int       # D rows one pass of a block covers (threads / lanes)
    tile: int       # D rows of one tile (rows * GATING_LOADS)
    ranks: int      # blocks of the cluster, one slice of D each
    slice: int      # D rows of one rank's slice (the last may be shorter)
    row_pass: int   # token rows per pass: 1, 2, 4 or 8
    passes: int     # passes over the token rows
    slots: int      # partials a block adds in order: warps, or rows of groups

    def slices(self, d: int):
        """[d0, d1) of each rank, in rank order."""
        return [(min(d, c * self.slice), min(d, c * self.slice + self.slice))
                for c in range(self.ranks)]


def gating_plan(d: int, e: int, b: int, *, vec: bool = True,
                ranks: Optional[int] = None) -> GatingPlan:
    """The cluster kernel's cut of a (D, E) router for B token rows, as
    gating.cu computes it.  16-byte gate loads when `vec` (the gates are
    16-byte aligned) and E % 4 == 0, else 4-byte ones.  The cluster has
    enough ranks that each reads at most one tile (every thread's loads in
    flight at once), up to GATING_MAX_CLUSTER; `ranks` forces the size.  At
    Mixtral's router (D 4096, E 8) that is 8 ranks of 512 rows."""
    v = 4 if vec and e % 4 == 0 else 1
    groups = e // v
    lanes = 1
    while lanes < groups:
        lanes *= 2
    rows = GATING_THREADS // lanes
    tile = rows * GATING_LOADS
    if ranks is None:
        ranks = max(1, min(GATING_MAX_CLUSTER, -(-d // tile)))
    row_pass = next(c for c in (1, 2, 4, GATING_ROWS) if c >= min(b, GATING_ROWS))
    slots = GATING_THREADS // 32 if lanes <= 32 else rows
    return GatingPlan(vec=v, groups=groups, lanes=lanes, rows=rows, tile=tile, ranks=ranks,
                      slice=-(-d // ranks), row_pass=row_pass, passes=-(-b // row_pass),
                      slots=slots)


@functools.lru_cache(maxsize=256)
def _gating_cut(d: int, e: int, aligned: bool) -> Tuple[int, int]:
    """(16-byte gate loads, cluster size) of ``gating_plan``, which do not
    depend on the batch: what each launch passes, cached per router shape."""
    plan = gating_plan(d, e, 1, vec=aligned)
    return int(plan.vec == 4), plan.ranks


def _check_gating(op: str, x: torch.Tensor, gates: torch.Tensor):
    _check(op, x.dim() == 2 and gates.dim() == 3, "want x (B, D) and gates (P, D, E)")
    b, d = x.shape
    p, dg, e = gates.shape
    _check(op, dg == d, f"x has D={d}, gates have D={dg}")
    _check(op, gates.dtype == torch.float32, "gates must be float32")
    _check(op, 0 < e <= MAX_EXPERTS, f"E={e} outside 1..{MAX_EXPERTS}")
    _check(op, b > 0 and p > 0, "empty batch or router stack")
    _check_contig(op, x=x, gates=gates)
    return p, b, d, e


def _launch_gating(op: str, x: torch.Tensor, gates: torch.Tensor, top_k: Optional[int],
                   ranks: Optional[int] = None):
    """Launch the cluster kernel on CUDA tensors (`ranks` forces its cluster
    size): logits, plus vals and idx when `top_k` is given."""
    p, b, d, e = _check_gating(op, x, gates)
    if top_k is not None:
        _check(op, 0 < top_k <= e, f"top_k={top_k} outside 1..{e}")
    xb = _x_flag(op, x)
    vec, planned = _gating_cut(d, e, gates.data_ptr() % 16 == 0)
    ranks = planned if ranks is None else ranks
    _check(op, 1 <= ranks <= GATING_MAX_CLUSTER,
           f"cluster of {ranks} outside 1..{GATING_MAX_CLUSTER}")
    lib = build.library("gating")
    logits = torch.empty((p, b, e), dtype=torch.float32, device=x.device)
    _record(op, "cuda")
    if top_k is None:
        _raise_on(op, lib.stacked_gating_launch(
            x.data_ptr(), xb, gates.data_ptr(), logits.data_ptr(), p, b, d, e, vec, ranks,
            _stream()))
        return logits
    vals = torch.empty((p, b, top_k), dtype=torch.float32, device=x.device)
    idx = torch.empty((p, b, top_k), dtype=torch.int32, device=x.device)
    _raise_on(op, lib.gating_topk_launch(
        x.data_ptr(), xb, gates.data_ptr(), logits.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), p, b, d, e, top_k, vec, ranks, _stream()))
    return logits, vals, idx


def gating_topk(x: torch.Tensor, gates: torch.Tensor, *, top_k: int):
    """Fused router: stacked gate matmul + softmax + top-k in one launch.

        x      (B, D)      activations (bf16 or f32)
        gates  (P, D, E)   stacked router weights (f32)
        ->     logits (P, B, E) f32, vals (P, B, K) f32 softmax probabilities
               of the selected experts, idx (P, B, K) int32

    Ties select the lowest expert index on both paths.  On the card: one
    thread-block cluster per router (``gating_plan``)."""
    op = "gating_topk"
    if _route(op, x, gates) == "torch":
        _record(op, "torch")
        return ref.gating_topk_ref(x, gates, top_k=top_k)
    return _launch_gating(op, x, gates, top_k)


def stacked_gating(x: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """logits (P, B, E) f32 = x @ gates[p] for the next P layers' routers
    (the adaptive predictor's "Stacking Computer")."""
    op = "stacked_gating"
    if _route(op, x, gates) == "torch":
        _record(op, "torch")
        return ref.stacked_gating_ref(x, gates)
    return _launch_gating(op, x, gates, None)


def _gating_at(ranks: int, x: torch.Tensor, gates: torch.Tensor, *,
               top_k: Optional[int] = None):
    """``gating_topk`` (with `top_k`) or ``stacked_gating`` (without) on CUDA
    tensors with the cluster size forced to `ranks` (1 to
    GATING_MAX_CLUSTER); ``chip_smoke.py`` sweeps the size with it."""
    op = "stacked_gating" if top_k is None else "gating_topk"
    _check(op, _route(op, x, gates) == "cuda", "a kernel needs CUDA tensors")
    return _launch_gating(op, x, gates, top_k, ranks)


def gating_regs(x_bf16: int, select: bool, vec: int, b: int) -> int:
    """Registers per thread of the cluster kernel's instantiation for bf16
    or float32 x, with or without the top-k, `vec` gate floats per load and
    a batch of `b` rows; cached per card."""
    key = (torch.cuda.current_device(), x_bf16, select, vec, min(b, GATING_ROWS))
    if key not in _GATING_REGS:
        regs = ctypes.c_int(0)
        _raise_on("gating", build.library("gating").gating_regs(
            x_bf16, int(select), int(vec == 4), b, ctypes.byref(regs)))
        _GATING_REGS[key] = regs.value
    return _GATING_REGS[key]


def gating_layout() -> Dict[str, int]:
    """The built kernel's layout constants, by the names this module
    mirrors them under (GATING_THREADS, ...), for holding the mirror to
    the kernel."""
    out = (ctypes.c_int * 5)()
    _raise_on("gating", build.library("gating").gating_layout(out))
    names = ("GATING_THREADS", "GATING_LOADS", "GATING_ROWS", "GATING_BUF_FLOATS",
             "GATING_MAX_CLUSTER")
    return dict(zip(names, out))


# --------------------------------------------------------------------------
# dense dequant-matmul
# --------------------------------------------------------------------------

# output columns of one dequant-matmul block, every kernel (kTileN,
# kMmaCols, kMmvCols in dequant_matmul.cu)
DEQUANT_MM_TILE_N = 128
# rows of one block: gemv kernel (kGemvRows), tensor-core prefill kernel
# (kMmaRows); the most rows the tensor-core decode kernel takes (kMmvRows)
DEQUANT_MM_GEMV_ROWS = 4
DEQUANT_MM_MMA_ROWS = 64
DEQUANT_MM_MMV_ROWS = 4
# largest quant group the gemv kernel stages at once (kStageK), and the
# largest the tensor-core kernels take (kMmaMaxGroup: one group per stage)
DEQUANT_MM_MAX_GROUP = 512
DEQUANT_MM_MMA_MAX_GROUP = 256
# blocks per SM the gemv kernel's K-split aims for when the row and column
# tiles leave the card idle (bytes in flight)
DEQUANT_MM_BLOCKS_PER_SM = 8
# the largest cluster the decode kernel splits K over (the portable size)
DEQUANT_MM_MAX_CLUSTER = 8
_DEQUANT_MM_KERNELS = {"gemv": 0, "mma": 1, "mmv": 2}
_DEQUANT_MM_OCCUPANCY: Dict[tuple, tuple] = {}
_DEQUANT_MMV_FIT: Dict[tuple, Dict[int, int]] = {}


def dequant_mm_kernel(m: int, n: int, x_dtype: torch.dtype, group_size: int,
                      x_aligned: bool, codes_aligned: bool) -> str:
    """Which dequant-matmul kernel serves M rows and N columns.  16-byte
    aligned bf16 x (the tensor-core kernels copy it in 16- and 8-byte
    pieces) with quant groups of a multiple of 16 up to
    DEQUANT_MM_MMA_MAX_GROUP goes to tensor cores: "mma" (64-row tiles) for
    chunked prefill, M > 4, and "mmv" (swapped operands, one block per
    column tile) for decode, M <= 4, when its TMA tensor maps take the codes
    (N % 16 == 0 and `codes_aligned`: 16-byte aligned).  "gemv" (4-row
    tiles, float32 FMAs, correct at any M and alignment) serves all else."""
    if not (x_dtype == torch.bfloat16 and x_aligned and group_size % 16 == 0
            and group_size <= DEQUANT_MM_MMA_MAX_GROUP):
        return "gemv"
    if m > DEQUANT_MM_MMV_ROWS:
        return "mma"
    return "mmv" if n % 16 == 0 and codes_aligned else "gemv"


def dequant_mm_splits(m: int, k: int, n: int, bits: int, group_size: int,
                      sm_count: int, kernel: str, blocks_per_sm: int,
                      clusters: Optional[Dict[int, int]] = None) -> int:
    """K-splits of the dequant-matmul grid, each split whole quant groups.
    mmv: the blocks of one cluster (1 to 8) that share a column tile, grown
    by one while the grid's blocks stay under three quarters of the
    `sm_count` SMs and every tile's cluster still runs at once with one
    block per SM (`clusters`: size -> clusters the card holds that way,
    ``dequant_mmv_fit``; ``sm_count // size`` when not given).  On the H100
    Granite's wi (128 column tiles) is not split and its wo (16 tiles) is
    split 6 ways: only 15 clusters of 7 or 8 fit (``chip_smoke.py`` phase
    3c times wo and wi at every cluster size beside this choice).  gemv:
    enough (row tile x column tile x split) blocks for `blocks_per_sm` per
    SM (DEQUANT_MM_BLOCKS_PER_SM: bytes in flight), with the float32 partials
    (written once, read once) kept under a quarter of the codes' bytes.
    mma: as many splits as keep the grid within one wave of the
    `blocks_per_sm` that the occupancy calculator reports
    (``dequant_mm_occupancy``; Granite's wo at M = 64 has 16 blocks).  No
    synchronisation."""
    groups = k // group_size
    tiles = -(-n // DEQUANT_MM_TILE_N)
    if kernel == "mmv":
        def fit(size):
            return clusters[size] if clusters else sm_count // size
        ranks = 1
        while (ranks < DEQUANT_MM_MAX_CLUSTER and ranks < groups
               and 4 * tiles * ranks < 3 * sm_count and tiles <= fit(ranks + 1)):
            ranks += 1
        return ranks
    if kernel == "mma":
        blocks = -(-m // DEQUANT_MM_MMA_ROWS) * tiles
        want = blocks_per_sm * sm_count // blocks
    else:
        blocks = -(-m // DEQUANT_MM_GEMV_ROWS) * tiles
        want = -(-blocks_per_sm * sm_count // blocks)
        cap = k * bits // 8 // (4 * 2 * 4 * m)    # partial bytes <= code bytes / 4
        want = min(want, cap)
    want = max(1, min(groups, want))
    per = -(-groups // want)
    return -(-groups // per)


def dequant_mm_occupancy(kernel: str, bits: int, x_bf16: int, group_size: int):
    """(blocks per SM, registers per thread) of the dequant-matmul kernel
    instantiation on the current card, from the CUDA runtime's occupancy
    calculator; cached per card."""
    key = (torch.cuda.current_device(), kernel, bits, x_bf16, group_size)
    if key not in _DEQUANT_MM_OCCUPANCY:
        op = "dequant_matmul"
        lib = build.library("dequant_matmul")
        blocks, regs = ctypes.c_int(0), ctypes.c_int(0)
        _raise_on(op, lib.dequant_matmul_occupancy(_DEQUANT_MM_KERNELS[kernel], bits, x_bf16,
                                                   group_size, ctypes.byref(blocks),
                                                   ctypes.byref(regs)))
        _DEQUANT_MM_OCCUPANCY[key] = (max(1, blocks.value), regs.value)
    return _DEQUANT_MM_OCCUPANCY[key]


def dequant_mmv_fit(bits: int) -> Dict[int, int]:
    """Cluster size (1 to DEQUANT_MM_MAX_CLUSTER) -> clusters of the decode
    kernel that the current card runs at once with one block per SM
    (cudaOccupancyMaxActiveClusters); cached per card."""
    key = (torch.cuda.current_device(), bits)
    if key not in _DEQUANT_MMV_FIT:
        lib = build.library("dequant_matmul")
        fit = {}
        for size in range(1, DEQUANT_MM_MAX_CLUSTER + 1):
            n = ctypes.c_int(0)
            _raise_on("dequant_matmul", lib.dequant_mmv_clusters(bits, size, ctypes.byref(n)))
            fit[size] = n.value
        _DEQUANT_MMV_FIT[key] = fit
    return _DEQUANT_MMV_FIT[key]


def _check_dequant_mm(op: str, x: torch.Tensor, q: QTensor):
    """x as (M, K) and N, after checking what every kernel needs."""
    _check(op, q.bits in PACK_FACTOR, f"bits={q.bits} not in {sorted(PACK_FACTOR)}")
    pack = PACK_FACTOR[q.bits]
    _check(op, q.data.dim() == 2 and q.scale.dim() == 2,
           "want a 2-D QTensor: data (K//pack, N), scale (K//group, N)")
    k = x.shape[-1]
    kp, n = q.data.shape
    gs = q.group_size
    _check(op, kp * pack == k and q.orig_k == k, f"q holds K={kp * pack}, x has K={k}")
    _check(op, 0 < gs <= DEQUANT_MM_MAX_GROUP and k % gs == 0 and gs % pack == 0,
           f"group_size={gs} does not tile K={k} in packed bytes (at most "
           f"{DEQUANT_MM_MAX_GROUP})")
    _check(op, tuple(q.scale.shape) == (k // gs, n),
           f"scale shape {tuple(q.scale.shape)} != {(k // gs, n)}")
    _check(op, q.data.dtype == torch.int8, "data must be int8")
    _check(op, q.scale.dtype == torch.float32, "scale must be float32")
    _check(op, n % 4 == 0, f"N={n} must be a multiple of 4 (4-byte code loads)")
    x2 = x.reshape(-1, k)
    _check_contig(op, x=x2, data=q.data, scale=q.scale)
    _x_flag(op, x2)
    _check(op, q.data.data_ptr() % 4 == 0 and q.scale.data_ptr() % 16 == 0,
           "data must be 4-byte and scale 16-byte aligned")
    return x2, n


def _dequant_mm_splits_for(kernel: str, x2: torch.Tensor, q: QTensor) -> int:
    """The wrapper's K-split (mmv: cluster size) for `kernel` on these inputs."""
    m, k = x2.shape
    n, gs = q.data.shape[1], q.group_size
    blocks = (dequant_mm_occupancy(kernel, q.bits, 1, gs)[0] if kernel == "mma"
              else DEQUANT_MM_BLOCKS_PER_SM)
    fit = dequant_mmv_fit(q.bits) if kernel == "mmv" else None
    return dequant_mm_splits(m, k, n, q.bits, gs, _sm_count(x2.device), kernel, blocks, fit)


def _kernel_for(x2: torch.Tensor, q: QTensor, n: int) -> str:
    return dequant_mm_kernel(x2.shape[0], n, x2.dtype, q.group_size, x2.data_ptr() % 16 == 0,
                             q.data.data_ptr() % 16 == 0)


def _launch_dequant_mm(op: str, x2: torch.Tensor, q: QTensor, n: int, kernel: str,
                       splits: Optional[int] = None):
    m, k = x2.shape
    lib = build.library("dequant_matmul")
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if m == 0:
        return out
    if splits is None:
        splits = _dequant_mm_splits_for(kernel, x2, q)
    part = None
    if splits > 1 and kernel != "mmv":
        part = torch.empty((splits, m, n), dtype=torch.float32, device=x2.device)
    _record(op, "cuda")
    _DEQUANT_MM_LAUNCHES[kernel] = _DEQUANT_MM_LAUNCHES.get(kernel, 0) + 1
    _raise_on(op, lib.dequant_matmul_launch(
        x2.data_ptr(), int(x2.dtype == torch.bfloat16), q.data.data_ptr(),
        q.scale.data_ptr(), part.data_ptr() if part is not None else None, out.data_ptr(),
        m, k, n, q.bits, q.group_size, _DEQUANT_MM_KERNELS[kernel], splits, _stream()))
    return out


def dequant_matmul(x: torch.Tensor, q: QTensor) -> torch.Tensor:
    """y = x @ dequant(q), float32.

        x  (..., K)   activations (bf16 or f32), any leading dims
        q  QTensor    data (K//pack, N) int8, scale (K//group, N) f32
        -> (..., N) float32

    The kernels mask ragged M and N (N a multiple of 4 on the card) where
    the JAX package pads; K is a multiple of the group by the layout.  On
    the card ``dequant_mm_kernel`` picks the kernel from the shapes."""
    op = "dequant_matmul"
    if _route(op, x, q.data, q.scale) == "torch":
        _record(op, "torch")
        return ref.dequant_matmul_ref(x, q)
    x2, n = _check_dequant_mm(op, x, q)
    return _launch_dequant_mm(op, x2, q, n, _kernel_for(x2, q, n)).reshape(*x.shape[:-1], n)


def _dequant_matmul_on(kernel: str, x: torch.Tensor, q: QTensor,
                       splits: Optional[int] = None) -> torch.Tensor:
    """``dequant_matmul`` on CUDA tensors through the named kernel, which
    must take the shapes, with K cut into `splits` (the decode kernel's
    cluster size) when given; ``chip_smoke.py`` times the gemv kernel with
    it beside the one the wrapper picks, and the decode kernel at every
    cluster size.  Serving code calls ``dequant_matmul``."""
    op = "dequant_matmul"
    _check(op, _route(op, x, q.data, q.scale) == "cuda", "a kernel needs CUDA tensors")
    x2, n = _check_dequant_mm(op, x, q)
    if kernel != "gemv":
        _check(op, _kernel_for(x2, q, n) == kernel,
               f"the {kernel} kernel does not take these shapes")
    return _launch_dequant_mm(op, x2, q, n, kernel, splits).reshape(*x.shape[:-1], n)


# --------------------------------------------------------------------------
# grouped dequant GEMV (+ gated combine)
# --------------------------------------------------------------------------

# the tensor-core grouped kernel's column tile, pairs per pass, largest
# cluster, warps per block and packed rows per ring stage (kMmvCols,
# kPairs, kMmvMaxCluster, kMmvWarps, kMmvStageRows in dequant.cu and
# dequant_mmv.cuh; ``grouped_layout`` reads them from the built kernel)
GROUPED_TILE_N = 128
GROUPED_PAIRS = 8
GROUPED_MAX_CLUSTER = 8
GROUPED_WARPS = 8
GROUPED_STAGE_ROWS = 32
_GROUPED_INFO: Dict[tuple, "GroupedInfo"] = {}


def grouped_dequant_kernel(x_dtype: torch.dtype, group_size: int, x_aligned: bool) -> str:
    """Which grouped dequant kernel serves a launch (both need N % 16 == 0
    and 16-byte aligned codes and scales).  16-byte aligned bf16 x with
    quant groups of a multiple of 16 up to DEQUANT_MM_MMA_MAX_GROUP goes to
    "mmv", the tensor-core kernel (TMA copies of x, k16 steps within a
    group); "two_pass", the float32 kernel with its partials pass,
    serves all else (float32 x, unaligned x, other groups)."""
    if (x_dtype == torch.bfloat16 and x_aligned and group_size % 16 == 0
            and group_size <= DEQUANT_MM_MMA_MAX_GROUP):
        return "mmv"
    return "two_pass"


class GroupedPlan(NamedTuple):
    """How the tensor-core grouped kernel cuts one launch (``grouped_plan``)."""
    ranks: int          # blocks of a column tile's cluster, each whole groups of K
    blocks_per_sm: int  # blocks of the kernel an SM holds at once

    def slices(self, groups: int):
        """[g0, g1) quant groups of each rank, in rank order."""
        return [(r * groups // self.ranks, (r + 1) * groups // self.ranks)
                for r in range(self.ranks)]


def grouped_plan(k: int, n: int, group_size: int, sm_count: int, clusters: Dict[int, int],
                 *, ranks: Optional[int] = None) -> GroupedPlan:
    """The tensor-core grouped kernel's cluster for a K x N expert matrix,
    from shapes and the card's cluster fit only (no synchronisation).
    `clusters`: size -> clusters of that size the card runs at once
    (``grouped_info``); at size 1 that is blocks, so ``clusters[1] //
    sm_count`` blocks share an SM (two at the kernel's 2-stage rings: a
    warp's decode and MMAs then hide behind 15 others).  The cluster grows
    by one from 1 while the grid's blocks stay within those per SM, there
    are groups to share, and every tile's cluster still runs at once.
    Mixtral's wi (224 column tiles) is not split; its wo (32 tiles) splits
    7 ways on the H100.  `ranks` forces the size (``chip_smoke.py`` sweeps
    it)."""
    groups = k // group_size
    tiles = -(-n // GROUPED_TILE_N)
    per_sm = max(1, clusters[1] // sm_count)
    if ranks is None:
        ranks = 1
        while (ranks < GROUPED_MAX_CLUSTER and ranks < groups
               and tiles * (ranks + 1) <= per_sm * sm_count and tiles <= clusters[ranks + 1]):
            ranks += 1
    return GroupedPlan(ranks=ranks, blocks_per_sm=per_sm)


class GroupedInfo(NamedTuple):
    """What the card reports for one instantiation of the tensor-core
    grouped kernel (``grouped_info``)."""
    clusters: Dict[int, int]  # cluster size -> clusters the card runs at once
    regs: int                 # registers per thread
    local_bytes: int          # local memory per thread (spills)
    smem: int                 # dynamic shared memory of a block


def grouped_info(bits: int, combine: bool, group_size: int) -> GroupedInfo:
    """The card's report on the tensor-core grouped kernel at `bits` and
    `group_size` (the combine's instantiation when `combine`); cached per
    card."""
    key = (torch.cuda.current_device(), bits, combine, group_size)
    if key not in _GROUPED_INFO:
        lib = build.library("dequant")
        fit = {}
        regs, local, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        for size in range(1, GROUPED_MAX_CLUSTER + 1):
            c = ctypes.c_int(0)
            _raise_on("grouped_dequant", lib.grouped_mmv_info(
                bits, int(combine), group_size, size, ctypes.byref(c), ctypes.byref(regs),
                ctypes.byref(local), ctypes.byref(smem)))
            fit[size] = c.value
        _GROUPED_INFO[key] = GroupedInfo(fit, regs.value, local.value, smem.value)
    return _GROUPED_INFO[key]


def _grouped_plan_for(k: int, n: int, group_size: int, bits: int, combine: bool,
                      device: torch.device, ranks: Optional[int] = None) -> GroupedPlan:
    """``grouped_plan`` with the card's SM count and cluster fit."""
    return grouped_plan(k, n, group_size, _sm_count(device),
                        grouped_info(bits, combine, group_size).clusters, ranks=ranks)


def grouped_layout() -> Dict[str, int]:
    """The built kernel's layout constants, by the names this module
    mirrors them under (GROUPED_TILE_N, ...)."""
    names = ("GROUPED_TILE_N", "GROUPED_PAIRS", "GROUPED_MAX_CLUSTER", "GROUPED_WARPS",
             "GROUPED_STAGE_ROWS")
    out = (ctypes.c_int * len(names))()
    _raise_on("grouped_dequant", build.library("dequant").grouped_mmv_layout(out))
    return dict(zip(names, out))


@functools.lru_cache(maxsize=256)
def _tensor_map(device: int, kind: int, ptr: int, rows: int, cols: int, bits: int):
    """The 128-byte TMA tensor map of the tensor-core kernel over the codes
    (kind 0, rows S * K / pack) or x (kind 1, P x K bf16) at `ptr`.  A map
    depends only on these arguments, so it is built once per pool tensor
    (and per recurring x buffer) rather than on every call."""
    buf = ctypes.create_string_buffer(128)
    _raise_on("grouped_dequant", build.library("dequant").grouped_mmv_tensor_map(
        ptr, kind, rows, cols, bits, buf))
    return buf


def _check_dequant(op: str, x, data, scale, slot, bits: int, group_size: int):
    _check(op, bits in PACK_FACTOR, f"bits={bits} not in {sorted(PACK_FACTOR)}")
    pack = PACK_FACTOR[bits]
    _check(op, x.dim() == 2 and data.dim() == 3 and scale.dim() == 3 and slot.dim() == 1,
           "want x (P, K), data (S, K//pack, N), scale (S, K//group, N), slot (P,)")
    p, k = x.shape
    s, kp, n = data.shape
    _check(op, slot.shape[0] == p, f"slot has {slot.shape[0]} entries for {p} pairs")
    _check(op, kp * pack == k, f"data holds K={kp * pack} codes, x has K={k}")
    _check(op, group_size > 0 and k % group_size == 0 and group_size % pack == 0,
           f"group_size={group_size} does not tile K={k} in packed bytes")
    _check(op, tuple(scale.shape) == (s, k // group_size, n),
           f"scale shape {tuple(scale.shape)} != {(s, k // group_size, n)}")
    _check(op, data.dtype == torch.int8, "data must be int8")
    _check(op, scale.dtype == torch.float32, "scale must be float32")
    _check(op, slot.dtype == torch.int32, "slot must be int32")
    _check_contig(op, x=x, data=data, scale=scale, slot=slot)
    return p, k, n, s, pack


def _check_dequant_cuda(op: str, data, scale, n: int):
    _check(op, n % DEQUANT_COL_ALIGN == 0,
           f"N={n} must be a multiple of {DEQUANT_COL_ALIGN} (16-byte code loads)")
    _check(op, data.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0,
           "data and scale must be 16-byte aligned")


def _count_grouped(op: str, kernel: str) -> None:
    _record(op, "cuda")
    key = f"{op}.{kernel}"
    _GROUPED_LAUNCHES[key] = _GROUPED_LAUNCHES.get(key, 0) + 1


def _launch_grouped(op: str, x, data, scale, slot, rows, weights, *, bits: int,
                    group_size: int, num_rows: Optional[int] = None,
                    ranks: Optional[int] = None):
    """Check the inputs and launch the kernel ``grouped_dequant_kernel``
    picks on CUDA tensors; the combine when `rows` is given.  `ranks`
    forces the tensor-core kernel's cluster size."""
    combine = rows is not None
    p, k, n, s, pack = _check_dequant(op, x, data, scale, slot, bits, group_size)
    if combine:
        _check(op, tuple(rows.shape) == (p,) and tuple(weights.shape) == (p,),
               "rows and weights must be (P,)")
        _check(op, rows.dtype == torch.int32, "rows must be int32")
        _check(op, weights.dtype == torch.float32, "weights must be float32")
        _check(op, num_rows > 0, f"num_rows={num_rows} must be positive")
        _check_contig(op, rows=rows, weights=weights)
    xb = _x_flag(op, x)
    lib = build.library("dequant")
    _check_dequant_cuda(op, data, scale, n)
    kernel = grouped_dequant_kernel(x.dtype, group_size, x.data_ptr() % 16 == 0)
    _check(op, kernel == "mmv" or ranks is None,
           "the tensor-core kernel does not take these inputs")
    out_rows = num_rows if combine else p
    if p == 0:
        return torch.zeros((out_rows, n), dtype=torch.float32, device=x.device)
    out = torch.empty((out_rows, n), dtype=torch.float32, device=x.device)
    if kernel == "mmv":
        dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
        plan = _grouped_plan_for(k, n, group_size, bits, combine, x.device, ranks)
        code_map = _tensor_map(dev, 0, data.data_ptr(), s * (k // pack), n, bits)
        x_map = _tensor_map(dev, 1, x.data_ptr(), p, k, bits)
        _count_grouped(op, kernel)
        _raise_on(op, lib.grouped_mmv_launch(
            code_map, x_map, scale.data_ptr(), slot.data_ptr(),
            rows.data_ptr() if combine else None, weights.data_ptr() if combine else None,
            out.data_ptr(), p, k, n, s, num_rows if combine else p, bits, group_size,
            int(combine), plan.ranks, _stream()))
        return out
    chunk = dequant_chunk(p, k, n, group_size, pack, _sm_count(x.device))
    part = torch.empty((p, k // chunk, n), dtype=torch.float32, device=x.device)
    _count_grouped(op, kernel)
    if combine:
        _raise_on(op, lib.grouped_dequant_combine_launch(
            x.data_ptr(), xb, data.data_ptr(), scale.data_ptr(), slot.data_ptr(),
            rows.data_ptr(), weights.data_ptr(), part.data_ptr(), out.data_ptr(),
            p, k, n, s, num_rows, bits, group_size, chunk, _stream()))
    else:
        _raise_on(op, lib.grouped_dequant_matmul_launch(
            x.data_ptr(), xb, data.data_ptr(), scale.data_ptr(), slot.data_ptr(),
            part.data_ptr(), out.data_ptr(), p, k, n, s, bits, group_size, chunk,
            _stream()))
    return out


def grouped_dequant_matmul(x, data, scale, slot, *, bits: int,
                           group_size: int) -> torch.Tensor:
    """y[p] = x[p] @ dequant(data[slot[p]], scale[slot[p]]), float32.

        x      (P, K)             activations, one row per (token, expert) pair
        data   (S, K//pack, N)    packed codes of the S pool slots
        scale  (S, K//group, N)   groupwise scales
        slot   (P,) int32         pool slot each pair reads
        ->     (P, N) float32

    The kernel reads each pair's expert in place in the pool, each distinct
    slot once per launch on the tensor-core kernel
    (``grouped_dequant_kernel`` picks the kernel).  A slot outside 0..S-1
    aborts the kernel (the next synchronisation raises); the plain version
    raises IndexError."""
    op = "grouped_dequant_matmul"
    if _route(op, x, data, scale, slot) == "torch":
        _record(op, "torch")
        return ref.grouped_dequant_matmul_ref(x, data, scale, slot, bits=bits,
                                              group_size=group_size)
    return _launch_grouped(op, x, data, scale, slot, None, None, bits=bits,
                           group_size=group_size)


def grouped_dequant_combine(x, data, scale, slot, rows, weights, *, bits: int,
                            group_size: int, num_rows: int) -> torch.Tensor:
    """Grouped dequant GEMV + gated combine:
    out[rows[p]] += weights[p] * (x[p] @ dequant(data[slot[p]], scale[slot[p]])).

        x        (P, K)             per-pair activations
        data     (S, K//pack, N)    packed codes of the pool slots
        scale    (S, K//group, N)   groupwise scales
        slot     (P,) int32         pool slot each pair reads
        rows     (P,) int32         destination token row, non-decreasing;
                                    pad pairs carry num_rows
        weights  (P,) float32       gate weight per pair (0 for pads)
        ->       (num_rows, N) float32; rows no pair visits are 0

    Each output row adds its pairs in pair order, with no atomics, so the
    result is the same on every run.  A slot outside 0..S-1, a pad's too,
    fails as in ``grouped_dequant_matmul``."""
    op = "grouped_dequant_combine"
    if _route(op, x, data, scale, slot, rows, weights) == "torch":
        _record(op, "torch")
        return ref.grouped_dequant_combine_ref(
            x, data, scale, slot, rows, weights, bits=bits, group_size=group_size,
            num_rows=num_rows)
    return _launch_grouped(op, x, data, scale, slot, rows, weights, bits=bits,
                           group_size=group_size, num_rows=num_rows)


def _grouped_at(ranks: int, x, data, scale, slot, rows=None, weights=None, *, bits: int,
                group_size: int, num_rows: Optional[int] = None) -> torch.Tensor:
    """``grouped_dequant_combine`` (with `rows`) or ``grouped_dequant_matmul``
    on CUDA tensors through the tensor-core kernel at a cluster of `ranks`
    blocks; ``chip_smoke.py`` sweeps the size with it.  Serving code calls
    the two ops."""
    op = "grouped_dequant_matmul" if rows is None else "grouped_dequant_combine"
    tensors = (x, data, scale, slot) + (() if rows is None else (rows, weights))
    _check(op, _route(op, *tensors) == "cuda", "a kernel needs CUDA tensors")
    return _launch_grouped(op, x, data, scale, slot, rows, weights, bits=bits,
                           group_size=group_size, num_rows=num_rows, ranks=ranks)


# --------------------------------------------------------------------------
# grouped GEMV over the hi-expert pool (bf16 or float32 weights)
# --------------------------------------------------------------------------

# pairs one pass over a slot serves, columns of a tile, rows of a TMA box
# (a ring stage), ring stages, most tiles a block streams side by side, the
# most ranks of a cluster and the most pairs of a launch (kGroup, kTileN,
# kBoxRows, kStages, kSweep, kMaxCluster, kMaxPairs in grouped_matmul.cu;
# ``grouped_matmul_layout`` reads them from the built kernel)
GMM_GROUP = 8
GMM_TILE_N = 64
GMM_BOX_ROWS = 128
GMM_STAGES = 8
GMM_SWEEP = 8
GMM_MAX_CLUSTER = 2
GMM_MAX_PAIRS = 1024
# cluster sizes the bf16 kernel launches at
GMM_RANKS = tuple(range(1, GMM_MAX_CLUSTER + 1))
_GMM_INFO: Dict[tuple, "GroupedMatmulInfo"] = {}
_GMM_PLANS: Dict[tuple, "GroupedMatmulPlan"] = {}


class GroupedMatmulPlan(NamedTuple):
    """How the bf16 grouped GEMV cuts one launch (``grouped_matmul_plan``):
    a persistent grid of `clusters` thread-block clusters of `ranks` blocks,
    one block per SM.  The launch's tiles are (group of up to GMM_GROUP pairs
    on a slot, GMM_TILE_N columns), group-major; cluster c takes a
    contiguous range of them and rank r streams rows [r * rows, (r + 1) *
    rows) of K of each, up to GMM_SWEEP tiles side by side
    (``grouped_matmul_schedule``)."""
    ranks: int      # blocks of a cluster, each one K range of every tile
    clusters: int   # clusters of the grid
    tiles: int      # column tiles of N
    rows: int       # rows of K a rank streams (whole GMM_BOX_ROWS)

    def ranges(self, k: int):
        """[k0, k1) rows of K of each rank, in rank order; the last may be
        empty (its rows past K read as zeros)."""
        return [(min(k, r * self.rows), min(k, (r + 1) * self.rows))
                for r in range(self.ranks)]


def _even_share(tiles: int, k: int, ranks: int, clusters: int, sm_count: int) -> float:
    """The busiest block's rows x tiles against an even split of all
    `tiles` tiles' K rows over the card's SMs (1.0: every SM streams the
    same bytes)."""
    units = -(-k // GMM_BOX_ROWS)
    return tiles * units / sm_count / (-(-tiles // clusters) * -(-units // ranks))


def grouped_matmul_plan(k: int, n: int, pairs: int, sm_count: int,
                        clusters: Dict[int, int]) -> GroupedMatmulPlan:
    """The bf16 grouped GEMV's grid for `pairs` pairs against K x N expert
    matrices, from shapes and the card's cluster fit only (the kernel groups
    the pairs by slot on the card, so the plan cannot know the group count).
    `clusters`: ranks -> clusters of that size the card runs at once
    (``grouped_matmul_info``).  For each size in GMM_RANKS the grid is as
    many clusters as run at once and fit the SMs, and its worth is the
    busiest block's share of an even split at the worst group count (1 to
    `pairs`); the best size wins, a smaller one on a tie.  Mixtral's hi
    shapes on the H100 (132 SMs, 66 clusters of 2): wi (4096 x 28672, 448
    tiles) and wo (14336 x 4096, 64 tiles) both take 2 ranks, 97% of an
    even split (one rank alone: 85% and 48%)."""
    tiles = -(-n // GMM_TILE_N)
    units = -(-k // GMM_BOX_ROWS)
    best, best_share = None, -1.0
    for ranks in GMM_RANKS:
        grid = min(clusters.get(ranks, 0), sm_count // ranks)
        if ranks > units or grid < 1:
            continue
        share = min(_even_share(g * tiles, k, ranks, grid, sm_count)
                    for g in range(1, pairs + 1))
        if share > best_share + 1e-9:
            best = GroupedMatmulPlan(ranks, grid, tiles, -(-units // ranks) * GMM_BOX_ROWS)
            best_share = share
    if best is None:
        raise ValueError(f"grouped_matmul: no cluster size fits the card ({clusters})")
    return best


def grouped_matmul_groups(slots) -> list:
    """The kernel's grouping of a launch's pairs (``group_pairs`` in
    grouped_matmul.cu): (slot, pairs) per group, slots in order of their
    first pair, each slot's pairs in pair order, GMM_GROUP a group."""
    by_slot: Dict[int, list] = {}
    for p, s in enumerate(slots):
        by_slot.setdefault(int(s), []).append(p)
    return [(s, ps[i:i + GMM_GROUP]) for s, ps in by_slot.items()
            for i in range(0, len(ps), GMM_GROUP)]


def grouped_matmul_schedule(plan: GroupedMatmulPlan, groups: int) -> list:
    """Each block's sweeps in the order it streams them, as the kernel walks
    them (``Sweeps`` in grouped_matmul.cu): block c * ranks + r (cluster c,
    rank r) gets (group, first tile, tiles, row0, row1) for its cluster's
    range [c T // clusters, (c + 1) T // clusters) of the T = `groups` *
    tiles tiles (group-major), cut into runs of at most GMM_SWEEP tiles of
    one group."""
    total = groups * plan.tiles
    out = []
    for c in range(plan.clusters):
        t, t1 = c * total // plan.clusters, (c + 1) * total // plan.clusters
        sweeps = []
        while t < t1:
            g, tile0 = divmod(t, plan.tiles)
            w = min(GMM_SWEEP, t1 - t, plan.tiles - tile0)
            sweeps.append((g, tile0, w))
            t += w
        out += [[(g, tile0, w, r * plan.rows, (r + 1) * plan.rows) for g, tile0, w in sweeps]
                for r in range(plan.ranks)]
    return out


class GroupedMatmulInfo(NamedTuple):
    """What the card reports for one instantiation of the grouped GEMV
    (``grouped_matmul_info``)."""
    regs: int                 # registers per thread
    local_bytes: int          # local memory per thread (spills)
    blocks_per_sm: int        # blocks an SM holds at once
    smem: int                 # dynamic shared memory of a block
    clusters: Dict[int, int]  # bf16: ranks -> clusters the card runs at once


def grouped_matmul_info(w_bf16: bool, pairs: int) -> GroupedMatmulInfo:
    """The card's report on the grouped GEMV's bf16 or float32 kernel at
    `pairs` pairs; cached per card."""
    key = (torch.cuda.current_device(), bool(w_bf16), pairs)
    if key not in _GMM_INFO:
        lib = build.library("grouped_matmul")
        regs, local, blocks, smem = (ctypes.c_int(0) for _ in range(4))
        fit = {}
        for ranks in GMM_RANKS if w_bf16 else (1,):
            c = ctypes.c_int(0)
            _raise_on("grouped_matmul", lib.grouped_matmul_info(
                int(w_bf16), pairs, ranks, ctypes.byref(regs), ctypes.byref(local),
                ctypes.byref(blocks), ctypes.byref(smem), ctypes.byref(c)))
            if w_bf16:
                fit[ranks] = c.value
        _GMM_INFO[key] = GroupedMatmulInfo(regs.value, local.value, blocks.value, smem.value,
                                           fit)
    return _GMM_INFO[key]


def grouped_matmul_layout() -> Dict[str, int]:
    """The built kernel's layout constants, by the names this module
    mirrors them under (GMM_GROUP, ...)."""
    names = ("GMM_GROUP", "GMM_TILE_N", "GMM_BOX_ROWS", "GMM_STAGES", "GMM_SWEEP",
             "GMM_MAX_CLUSTER", "GMM_MAX_PAIRS")
    out = (ctypes.c_int * len(names))()
    _raise_on("grouped_matmul", build.library("grouped_matmul").grouped_matmul_layout(out))
    return dict(zip(names, out))


def _grouped_matmul_plan_for(k: int, n: int, pairs: int,
                             device: torch.device) -> GroupedMatmulPlan:
    """``grouped_matmul_plan`` with the card's SM count and cluster fit
    (asked at the most pairs' shared memory); cached per card and shape."""
    key = (device.index, k, n, pairs)
    if key not in _GMM_PLANS:
        fit = grouped_matmul_info(True, GMM_MAX_PAIRS).clusters
        _GMM_PLANS[key] = grouped_matmul_plan(k, n, pairs, _sm_count(device), fit)
    return _GMM_PLANS[key]


@functools.lru_cache(maxsize=64)
def _gmm_tensor_map(device: int, ptr: int, s: int, k: int, n: int):
    """The 128-byte TMA tensor map of the bf16 kernel over the pool (S, K, N)
    at `ptr`; it depends only on these arguments, so it is built once per
    pool tensor rather than on every call."""
    buf = ctypes.create_string_buffer(128)
    _raise_on("grouped_matmul", build.library("grouped_matmul").grouped_matmul_tensor_map(
        ptr, s, k, n, buf))
    return buf


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """y[p] = x[p] @ w[slot[p]], float32: the hi experts' grouped product.

        x     (P, K)      one activation row per (token, expert) pair
        w     (S, K, N)   the pool of S expert matrices (x's dtype: bf16 or
                          float32)
        slot  (P,) int32  pool slot each pair reads
        ->    (P, N) float32

    The kernel reads each pair's expert in place in the pool and streams
    each distinct slot once per launch for up to GMM_GROUP pairs on it
    (pads that repeat a real pair's slot add no weight bytes).  bf16 needs
    K % 8 == 0 and 16-byte aligned x and w (TMA and 16-byte copies).  A slot
    outside 0..S-1 aborts the kernel (the next synchronisation raises); the
    plain version raises IndexError."""
    op = "grouped_matmul"
    if _route(op, x, w, slot) == "torch":
        _record(op, "torch")
        return ref.grouped_matmul_ref(x, w, slot)
    _check(op, x.dim() == 2 and w.dim() == 3 and slot.dim() == 1,
           "want x (P, K), w (S, K, N), slot (P,)")
    p, k = x.shape
    s, kw, n = w.shape
    _check(op, kw == k, f"w has K={kw}, x has K={k}")
    _check(op, slot.shape[0] == p, f"slot has {slot.shape[0]} entries for {p} pairs")
    _check(op, x.dtype == w.dtype and w.dtype in (torch.bfloat16, torch.float32),
           f"x and w must both be bfloat16 or both float32, got {x.dtype} and {w.dtype}")
    _check(op, slot.dtype == torch.int32, "slot must be int32")
    _check(op, p <= GMM_MAX_PAIRS, f"P={p} above {GMM_MAX_PAIRS} pairs")
    _check(op, s > 0 and n * w.element_size() % 16 == 0,
           f"N={n} must fill whole 16-byte loads")
    bf16 = w.dtype == torch.bfloat16
    _check(op, not bf16 or k % 8 == 0, f"K={k} must be a multiple of 8 (16-byte rows of x)")
    _check_contig(op, x=x, w=w, slot=slot)
    lib = build.library("grouped_matmul")
    _check(op, w.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0,
           "x and w must be 16-byte aligned")
    out = torch.empty((p, n), dtype=torch.float32, device=x.device)
    if p == 0:
        return out
    plan, w_map = None, None
    if bf16:
        plan = _grouped_matmul_plan_for(k, n, p, x.device)
        w_map = _gmm_tensor_map(x.device.index, w.data_ptr(), s, k, n)
    _record(op, "cuda")
    _raise_on(op, lib.grouped_matmul_launch(
        x.data_ptr(), w.data_ptr(), w_map, slot.data_ptr(), out.data_ptr(), p, k, n, s,
        int(bf16), plan.ranks if plan else 1, plan.clusters if plan else 1,
        plan.rows if plan else GMM_BOX_ROWS, _stream()))
    return out


# --------------------------------------------------------------------------
# paged flash decode
# --------------------------------------------------------------------------

# head dims and GQA group sizes the kernels are instantiated for: those of
# the ported configs (g 4 with hd 128 and 64: Mixtral, Phi-MoE, Granite; g 6
# with hd 128: Nemotron-4-15B and InternVL2-26B, 48 query heads on 8 kv
# heads) and of their smoke variants (g 1)
FLASH_DECODE_HEAD_DIMS = (64, 128)
FLASH_DECODE_GROUPS = (1, 4, 6)
# the most splits the combine pass takes (kMaxSplits in flash_decode.cu)
FLASH_DECODE_MAX_SPLITS = 4096


def _check_decode_heads(op: str, hq: int, hkv: int, hd: int, k, v) -> None:
    _check(op, hq % hkv == 0 and hq // hkv in FLASH_DECODE_GROUPS,
           f"Hq/Hkv = {hq}/{hkv} must be one of {FLASH_DECODE_GROUPS}")
    _check(op, hd in FLASH_DECODE_HEAD_DIMS, f"hd={hd} not in {FLASH_DECODE_HEAD_DIMS}")
    _check(op, k.dtype == v.dtype and k.dtype in (torch.bfloat16, torch.float32),
           "K and V must both be bfloat16 or both float32")


def decode_splits(b: int, hkv: int, maxp: int, slots: int) -> int:
    """Page splits per (slot, kv head): enough pass-1 blocks to fill the
    card's `slots` resident blocks (blocks per SM x SMs) in one wave, at
    most one split per page of the table.  Chosen from shapes only, so it
    costs no synchronisation."""
    want = -(-slots // (b * hkv))
    return max(1, min(maxp, want, FLASH_DECODE_MAX_SPLITS))


_DECODE_BLOCKS: Dict[tuple, int] = {}


def _blocks_per_sm(op: str, query, *args) -> int:
    """Pass-1 blocks one SM holds, as `query(*args, &n)` (the CUDA runtime's
    occupancy calculator for one instantiation) reports; cached."""
    key = (op, id(query), *args)
    if key not in _DECODE_BLOCKS:
        n = ctypes.c_int(0)
        _raise_on(op, query(*args, ctypes.byref(n)))
        _DECODE_BLOCKS[key] = max(1, n.value)
    return _DECODE_BLOCKS[key]


def _decode_blocks_per_sm(lib, kv_bf16: int, g: int, hd: int, maxp: int) -> int:
    """Paged pass-1 blocks per SM for this instantiation and table width."""
    return _blocks_per_sm("paged_flash_decode", lib.paged_flash_decode_blocks_per_sm,
                          kv_bf16, g, hd, maxp)


def decode_kernel_regs(kv_bf16: int, g: int, hd: int, paged: bool = True) -> Dict[str, int]:
    """Registers and local-memory bytes (spills and stack) per thread of the
    pass-1 kernel instantiated for (kv_bf16, g, hd), paged or contiguous,
    as the CUDA runtime reports them (cudaFuncGetAttributes)."""
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    if paged:
        fn = build.library("flash_decode").paged_flash_decode_regs
    else:
        fn = build.library("flash_decode_contig").flash_decode_regs
    _raise_on("flash_decode_regs", fn(kv_bf16, g, hd, ctypes.byref(regs), ctypes.byref(local)))
    return {"regs": regs.value, "local_bytes": local.value}


def decode_stages(kv_bf16: int, hd: int) -> int:
    """Ring stages of the flash-decode pass-1 kernel for bf16 (or float32)
    K/V at head dim `hd`, shared by the paged and the contiguous kernels; 1
    for float32 K/V (a single tile buffer)."""
    n = ctypes.c_int(0)
    _raise_on("flash_decode_stages",
              build.library("flash_decode").flash_decode_stages(kv_bf16, hd, ctypes.byref(n)))
    return n.value


def paged_flash_decode(q: torch.Tensor, pages_k: torch.Tensor, pages_v: torch.Tensor,
                       table: torch.Tensor, lengths: torch.Tensor, *, scale=None,
                       softcap: float = 0.0) -> torch.Tensor:
    """Decode attention straight out of the paged KV pool.

        q        (B, Hq, hd)        current-token queries (bf16 or f32)
        pages_k  (P, psz, Hkv, hd)  shared page pool (bf16 or f32; pages_v alike)
        table    (B, maxp) int32    physical page per logical page
        lengths  (B,) int32         valid cache tokens per slot
        ->       (B, Hq, hd) float32; zeros where lengths == 0

    The kernel reads only the pages below ceil(length / psz) and each K/V
    row once for its whole GQA group.  A page id outside 0..P-1 in the
    table aborts the kernel (the next synchronisation raises); the plain
    version raises IndexError."""
    op = "paged_flash_decode"
    if _route(op, q, pages_k, pages_v, table, lengths) == "torch":
        _record(op, "torch")
        return ref.paged_flash_decode_ref(q, pages_k, pages_v, table, lengths,
                                          scale=scale, softcap=softcap)
    _check(op, q.dim() == 3 and pages_k.dim() == 4 and table.dim() == 2
           and lengths.dim() == 1,
           "want q (B, Hq, hd), pages (P, psz, Hkv, hd), table (B, maxp), lengths (B,)")
    b, hq, hd = q.shape
    num_pages, psz, hkv, hd2 = pages_k.shape
    maxp = table.shape[1]
    _check(op, tuple(pages_v.shape) == tuple(pages_k.shape), "pages_k and pages_v differ")
    _check(op, hd2 == hd, f"pages have hd={hd2}, q has hd={hd}")
    _check(op, table.shape[0] == b and lengths.shape[0] == b,
           f"table and lengths must have B={b} rows")
    _check_decode_heads(op, hq, hkv, hd, pages_k, pages_v)
    _check(op, table.dtype == torch.int32 and lengths.dtype == torch.int32,
           "table and lengths must be int32")
    _check(op, b > 0 and num_pages > 0 and maxp > 0, "empty batch, pool or table")
    _check_contig(op, q=q, pages_k=pages_k, pages_v=pages_v, table=table,
                  lengths=lengths)
    qb = _x_flag(op, q)
    lib = build.library("flash_decode")
    _check(op, all(t.data_ptr() % 16 == 0 for t in (q, pages_k, pages_v)),
           "q and pages must be 16-byte aligned")
    scale = float(scale) if scale is not None else 1.0 / (hd ** 0.5)
    out = torch.empty((b, hq, hd), dtype=torch.float32, device=q.device)
    kvb = int(pages_k.dtype == torch.bfloat16)
    blocks = _decode_blocks_per_sm(lib, kvb, hq // hkv, hd, maxp)
    splits = decode_splits(b, hkv, maxp, blocks * _sm_count(q.device))
    o_part = ml_part = None
    if splits > 1:
        o_part = torch.empty((b * hq, splits, hd), dtype=torch.float32, device=q.device)
        ml_part = torch.empty((b * hq, splits, 2), dtype=torch.float32, device=q.device)
    _record(op, "cuda")
    _raise_on(op, lib.paged_flash_decode_launch(
        q.data_ptr(), qb, pages_k.data_ptr(), pages_v.data_ptr(), kvb,
        table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), o_part.data_ptr() if o_part is not None else None,
        ml_part.data_ptr() if ml_part is not None else None,
        b, hq, hkv, hd, num_pages, psz, maxp, splits, scale, float(softcap), _stream()))
    return out


# --------------------------------------------------------------------------
# flash decode over a contiguous cache
# --------------------------------------------------------------------------

# tokens of one split unit of the contiguous kernel (the paged kernel's page)
FLASH_DECODE_UNIT = 64


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention over a contiguous cache.

        q        (B, Hq, hd)       current-token queries (bf16 or f32)
        k, v     (B, S, Hkv, hd)   cache (bf16 or f32); query head h reads
                                   kv head h // (Hq // Hkv)
        lengths  (B,) int32        valid cache rows per slot
        ->       (B, Hq, hd) float32

    A length <= 0 masks every row, and the JAX oracle's softmax then weighs
    all S rows alike: the result is the mean of V over S (the Pallas kernel
    takes that mean over S padded to its block instead).  The plain version
    repeats the kv heads, as the JAX package's wrapper does; the kernel reads
    each K/V row in place, once for its GQA group, only below the length."""
    op = "flash_decode"
    if _route(op, q, k, v, lengths) == "torch":
        _record(op, "torch")
        hq, hkv = q.shape[1], k.shape[2]
        if hkv != hq:
            k = k.repeat_interleave(hq // hkv, dim=2)
            v = v.repeat_interleave(hq // hkv, dim=2)
        return ref.flash_decode_ref(q, k, v, lengths)
    _check(op, q.dim() == 3 and k.dim() == 4 and lengths.dim() == 1,
           "want q (B, Hq, hd), k and v (B, S, Hkv, hd), lengths (B,)")
    b, hq, hd = q.shape
    bk, s, hkv, hd2 = k.shape
    _check(op, tuple(v.shape) == tuple(k.shape), "k and v differ")
    _check(op, bk == b and lengths.shape[0] == b and hd2 == hd,
           f"k/v {tuple(k.shape)} and lengths do not fit q {tuple(q.shape)}")
    _check_decode_heads(op, hq, hkv, hd, k, v)
    _check(op, lengths.dtype == torch.int32, "lengths must be int32")
    _check(op, b > 0 and s > 0, "empty batch or cache")
    _check_contig(op, q=q, k=k, v=v, lengths=lengths)
    qb = _x_flag(op, q)
    lib = build.library("flash_decode_contig")
    _check(op, all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
           "q, k and v must be 16-byte aligned")
    out = torch.empty((b, hq, hd), dtype=torch.float32, device=q.device)
    kvb = int(k.dtype == torch.bfloat16)
    blocks = _blocks_per_sm(op, lib.flash_decode_blocks_per_sm, kvb, hq // hkv, hd)
    units = -(-s // FLASH_DECODE_UNIT)
    splits = decode_splits(b, hkv, units, blocks * _sm_count(q.device))
    o_part = ml_part = None
    if splits > 1:
        o_part = torch.empty((b * hq, splits, hd), dtype=torch.float32, device=q.device)
        ml_part = torch.empty((b * hq, splits, 2), dtype=torch.float32, device=q.device)
    _record(op, "cuda")
    _raise_on(op, lib.flash_decode_launch(
        q.data_ptr(), qb, k.data_ptr(), v.data_ptr(), kvb, lengths.data_ptr(),
        out.data_ptr(), o_part.data_ptr() if o_part is not None else None,
        ml_part.data_ptr() if ml_part is not None else None,
        b, s, hq, hkv, hd, FLASH_DECODE_UNIT, splits, 1.0 / (hd ** 0.5), _stream()))
    return out
