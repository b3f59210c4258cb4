"""HOBBIT OffloadEngine on PyTorch: serve a MoE model whose experts live in
host memory, through a device-resident mixed-precision expert cache, the
dynamic loader, the adaptive predictor and the multidimensional cache
manager (Fig. 4), with the decode paths of the JAX reference
(``src/repro/core/engine.py``) and the same cache/loader decisions.

Two decode paths share one contract (``decode_step_batch``): the grouped
path (the default, the serving hot path: one fused gating kernel, one
grouped lo launch pair per MoE layer, asynchronous staging) and the
per-expert reference path (``grouped=False``, or ``compute_mode="host"``),
which gates on the host in numpy, loads synchronously and computes expert
by expert, the numerics baseline the grouped path is held to.  With
``compute_mode="host"`` (the paper's §4 CPU-helper mode) each expert runs on
the CPU in float32 from host storage; loading still runs as on the device.
The single-sequence API (``start_sequence``, ``decode_token``, ``generate``,
``score_nll``) drives either path at batch 1.

What changes on a card:

* Host storage is pinned.  Hi experts keep the model dtype (the reference's
  float32 host copy is an exact upcast of bf16 weights); lo experts are
  quantized on the device, expert by expert, from the same float32 upcast,
  so their codes equal the reference's.
* Expert copies are real.  ``_stage`` copies an expert's host bytes into
  fresh device staging buffers on its thread's own CUDA stream and waits
  for them (so the staging engine's futures and stall accounting measure
  the real link); ``_commit_staged`` makes the compute stream wait on the
  copy's event and then copies staging -> pool slot.  A copy never writes
  a pool slot from a copy stream, so a kernel still reading the slot for an
  earlier layer cannot race it.
* On the grouped path the union-overflow experts (a layer's union demand
  larger than the pool) live in extra rows of the same pool tensors
  (``hi_slots + B*top_k`` and ``lo_slots + B*top_k`` rows; the reference's
  ``_overflow_buffers`` host buffers have no counterpart), and the lo
  kernels read every expert in place through a per-pair slot index.  The
  per-expert path admits an overflow expert into the cache instead, as the
  reference does, and its pools have no extra rows.
* On the grouped path the hi half is the grouped bf16 GEMV
  (``kops.grouped_matmul``) and the lo half the two grouped dequant
  kernels, all reading experts in place in the pools by a per-pair slot.
  The per-expert path runs one ``torch.matmul`` pair per hi expert on pool
  views and the dense dequant-matmul kernel, one call per product, per lo
  expert.  Neither path materialises a float32 weight on the card.
* The host blocks on the card where the reference does.  Per MoE layer it
  synchronises once after the layer's captured segment (the scheduler
  runs on the host).  On the grouped path that one readback brings the
  router's top-k and, with prefetch on and on every MoE layer but the
  last, the adaptive predictor's (P, B, E) probabilities, which the
  segment computes for every row with one stacked-gating launch on the
  float32 normed hidden state; the adaptive walk and its one-layer
  fallback read each row's slice of them, with no call of their own
  (``segment_predictions``).  The per-expert path reads back the normed
  hidden state, gates on the host and, with prefetch on, makes one or two
  predictor calls per active row on every MoE layer but the last (the
  walk, then a one-layer prediction when the walk did not reach the next
  layer), each an H2D copy, a launch and a readback
  (``predictor_host_calls``).  A union-overflow miss waits for its staged
  copy (a wait that ``load_stall_s`` does not count); host compute mode
  reads each (token, expert) pair's hidden row back; each step ends with
  one logits readback.
  The paged KV layout adds none: its step prologue reads positions that
  already live on the host, and each chunked-prefill call reads back its
  logits as the reference does.
* While a ``torch.profiler`` session is active the step records spans
  (``repro_torch.spans``): ``engine.step``, and on the grouped path under
  it ``engine.prologue``, each MoE layer's ``engine.segment``, ``.route``,
  ``.predict``, ``.load``, ``.pairs`` (an ``engine.reload`` under it for
  each union-overflow copy), ``.ffn`` and ``.retire``, then
  ``engine.logits``; the per-expert path records each layer's
  ``engine.predict`` with a ``predictor.gating`` under it for each host
  call (docs/TORCH_METRICS.md).
* Paged KV (``paged_kv=True``) shares ``models.kv_pages`` with the dense
  backend: a page pool with a radix prefix trie and copy-on-write, chunked
  prefill, and decode attention through the paged flash-decode kernel.
* The grouped path's device work is captured (``capture.CapturedStep``,
  the counterpart of the reference's ``_jit``, always on as there): the
  step's embedding, each MoE layer's segment — attention on either KV
  layout, the FFN norm, the gating kernel and the predictor's stacked
  gating on the float32 copy of the normed hidden state — each MoE
  layer's grouped FFN, and the step's logits.  On the card each is a CUDA
  graph per batch shape, replayed every step ("engine_embed",
  "engine_layer<i>", "engine_ffn", "engine_logits" counters); on the CPU
  each runs eagerly.  The segments
  read positions, the page table and the active mask from step-state
  buffers that ``_step_prologue`` fills once per step.  The FFN
  (``grouped_ffn``) runs at the reference's fixed pair count P = B * top_k,
  one graph for every layer: the host keeps every decision (cache lookups,
  downgrades, union-overflow commits before the replay, the stats) and
  writes the layer's pairs into a pinned table, copied to the card with
  one H2D copy per layer.  Paged admission captures each prefill chunk
  (``ChunkedPrefill``, "prefill_chunk"); the one-shot dense-KV prefill and
  joins capture the forward of a prompt shape that comes back and lay its
  entries out in the KV cache eagerly (``models.prefill.DenseKVPrefill``,
  "prefill": keyed by the prompt's shape alone, so its graphs outlive
  ``start_batch``; a few graphs at most, a shape's first call eager).
* The per-expert path captures what the reference jits there
  (``engine.py:991-993``): the step's embedding and logits, each MoE
  layer's attention, FFN norm and float32 copy of the normed hidden state
  as one segment without the gating kernel ("engine_attn<i>": this path
  gates on the host in numpy), and each hi and lo expert as a graph per
  (precision, pool slot), its weights fixed addresses in the graph
  ("engine_hi", "engine_lo"; the expert graphs share one memory pool and
  live until ``_ensure_pools`` reallocates the pools, which it never does
  on this path after the first; ``start_batch`` drops the segments, which
  read the KV cache it replaces).  The host loop stays
  eager, as in the reference: decisions, loads, union-overflow reloads,
  the float32 combine and the renormalisation; so do host compute mode's
  experts, which run on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.capture import CapturedStep, GraphPool, addresses
from repro_torch.core.cache import MultidimensionalCache
from repro_torch.core.fleet_heat import FleetHeat
from repro_torch.core.loader import (ON_DEMAND, DynamicExpertLoader, LoadTask,
                                     StagingEngine, measure_link_bps)
from repro_torch.core.policies import MULTIDIM, PolicyWeights
from repro_torch.core.predictor import AdaptiveExpertPredictor
from repro_torch.core.scoring import (PREC_HI, PREC_LO, PREC_SKIP, Thresholds,
                                      precision_decisions)
from repro_torch.core.simulator import TraceLayer
from repro_torch.device import to_device, to_host
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.kv_pages import ChunkedPrefill, PagedKVPool
from repro_torch.models.model import Model, unstack_layers
from repro_torch.models.prefill import DenseKVPrefill
from repro_torch.quant.quantize import (PACK_FACTOR, QTensor, dequantize, expert_nbytes,
                                        quantize)
from repro_torch.spans import span

HI_NAMES = ("wi", "wo")
LO_NAMES = ("wi_data", "wi_scale", "wo_data", "wo_scale")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    hi_slots: int = 16
    lo_slots: int = 8
    thresholds: Thresholds = Thresholds(0.6, 0.9)
    policy: PolicyWeights = MULTIDIM
    prefetch_p: int = 2
    lo_bits: int = 4
    group_size: int = 64
    dynamic_loading: bool = True     # ablation switch (Fig. 16)
    prefetch: bool = True            # ablation switch (Fig. 17)
    # device | host: host runs each expert on the CPU in float32 from host
    # storage (the paper's CPU-helper mode, §4), on the per-expert path
    compute_mode: str = "device"
    # grouped decode: one fused gating kernel and one grouped lo launch pair
    # per MoE layer.  False selects the per-expert reference path (host
    # gating, synchronous loading, one expert at a time), the parity
    # baseline; host compute mode always takes it
    grouped: bool = True
    # stage prefetch copies on background streams so they overlap compute;
    # False drains them synchronously (the deterministic parity setting)
    async_prefetch: bool = True
    streams: int = 2
    ordered: bool = False
    upgrade: bool = True
    # link bandwidth in GB/s.  None measures the pinned host -> device rate
    # at startup (budget accounting only); a value also emulates the link
    # (each staged copy occupies its stream for bytes/link seconds)
    link_gbps: Optional[float] = None
    # paged KV cache: slots draw kv_page_size-token pages from a shared pool
    # of kv_pages pages (None = the dense equivalent, batch*ceil(max_len/
    # page)); prompts prefill in prefill_chunk-token chunks, and with
    # prefix_sharing admissions alias trie-matched prompt prefix pages
    # (copy-on-write on divergence) — see models/kv_pages.py
    paged_kv: bool = False
    kv_page_size: int = 64
    kv_pages: Optional[int] = None
    prefill_chunk: int = 64
    prefix_sharing: bool = True


def _spread(hist: Dict[int, int]) -> Dict:
    """launches, min, median and max of a {value: count} histogram (zeros
    when it is empty) and the histogram itself."""
    vals = sorted(v for v, c in hist.items() for _ in range(c))
    if not vals:
        return {"launches": 0, "min": 0, "median": 0, "max": 0, "hist": {}}
    return {"launches": len(vals), "min": vals[0], "median": float(np.median(vals)),
            "max": vals[-1], "hist": dict(sorted(hist.items()))}


def pair_table_words(batch: int, top_k: int) -> int:
    """int32 words of the grouped FFN's pair table: six (P,) index rows (hi
    rows, ranks, slots; lo rows, ranks, slots) then the (B, k) float32 hi and
    lo gate weights, P = batch * top_k."""
    return 8 * batch * top_k


def pack_pair_table(table: np.ndarray, hi_pairs, lo_pairs, w_hi: np.ndarray,
                    w_lo: np.ndarray) -> None:
    """Write one layer's pairs into `table`, a flat int32 array of
    ``pair_table_words(B, k)`` words, in ``grouped_ffn``'s layout.
    hi_pairs / lo_pairs: [(row, rank, pool slot)] in row order; w_hi / w_lo
    (B, k) float32.  Pads: row B, rank 0, weight 0 and the slot of the
    precision's last real pair (slot 0 when it has none), so a pad adds no
    weight bytes to a kernel that streams each distinct slot once."""
    b, k = w_hi.shape
    p = b * k
    idx = table[:6 * p].reshape(6, p)
    for base, pairs in ((0, hi_pairs), (3, lo_pairs)):
        idx[base] = b
        idx[base + 1] = 0
        idx[base + 2] = pairs[-1][2] if pairs else 0
        if pairs:
            idx[base:base + 3, :len(pairs)] = np.asarray(pairs, np.int32).T
    w = table[6 * p:].view(np.float32).reshape(2, b, k)
    w[0] = w_hi
    w[1] = w_lo


def grouped_ffn(hs: torch.Tensor, x: torch.Tensor, table: torch.Tensor, pool_hi, pool_lo,
                cfg, *, top_k: int, lo_bits: int, group_size: int) -> torch.Tensor:
    """All (row, expert) pairs of one MoE layer at the fixed pair count P =
    B * top_k, the reference's ``OffloadEngine._grouped_ffn`` body
    (``src/repro/core/engine.py:430-462``): one grouped hi product pair over
    the hi pool (``kops.grouped_matmul``, rounded to the model dtype after
    each product) and the grouped lo dequant pair over the lo pool, every
    expert read in place by its pool slot.

        hs     (B, D)   the normed hidden state
        x      (B, 1, D) the residual stream
        table  (pair_table_words(B, k),) int32: hi_rows, hi_ranks, hi_slots,
               lo_rows, lo_ranks, lo_slots (each (P,)), then w_hi, w_lo
               ((B, k) float32, bit for bit)
        ->     x + y (B, 1, D), y each row's pairs combined in float32 and
               divided by its kept gate mass (0 where none is kept)

    Pad pairs carry row == B: their activations gather row B - 1 (as the
    reference clips), the hi grid drops them and the combine kernel skips
    them.  Hi outputs land in a (B, k, D) grid at their (row, rank) cells,
    weighted and summed over the rank axis in order, as the reference's.
    Fixed shapes and no host read: the engine captures it."""
    b, d = hs.shape
    p = b * top_k
    idx = table[:6 * p].view(6, p)
    hi_rows, hi_ranks, hi_slots, lo_rows, lo_ranks, lo_slots = idx
    w_hi, w_lo = table[6 * p:].view(torch.float32).view(2, b, top_k)
    # ---- hi: one grouped product pair ----
    xh = hs.index_select(0, hi_rows.clamp(max=b - 1))
    z = kops.grouped_matmul(xh, pool_hi["wi"], hi_slots).to(hs.dtype)
    out_hi = kops.grouped_matmul(L.activate(z, cfg), pool_hi["wo"], hi_slots).to(hs.dtype)
    # ---- lo: the grouped dequant GEMV, then GEMV + gated combine ----
    lo_c = lo_rows.clamp(max=b - 1)
    zl = kops.grouped_dequant_matmul(
        hs.index_select(0, lo_c), pool_lo["wi_data"], pool_lo["wi_scale"], lo_slots,
        bits=lo_bits, group_size=group_size).to(hs.dtype)
    lo_w = torch.where(lo_rows < b, w_lo[lo_c.long(), lo_ranks.long()], 0.0)
    # pairs arrive in row order, pads last: the combine's non-decreasing rows
    y_lo = kops.grouped_dequant_combine(
        L.activate(zl, cfg), pool_lo["wo_data"], pool_lo["wo_scale"], lo_slots, lo_rows,
        lo_w, bits=lo_bits, group_size=group_size, num_rows=b)
    # ---- hi combine: unique (row, rank) cells, pads to a dropped cell ----
    cell = torch.where(hi_rows < b, hi_rows * top_k + hi_ranks, p).long()
    grid = torch.zeros((p + 1, d), dtype=torch.float32, device=hs.device)
    grid.index_copy_(0, cell, out_hi.to(torch.float32))
    y = (grid[:p].view(b, top_k, d) * w_hi[..., None]).sum(dim=1) + y_lo
    wsum = (w_hi + w_lo).sum(dim=1, keepdim=True)              # disjoint weights
    y = torch.where(wsum > 0, y / torch.where(wsum > 0, wsum, 1.0), 0.0)
    return x + y[:, None, :].to(x.dtype)


class OffloadEngine:
    def __init__(self, model: Model, params, ecfg: EngineConfig):
        if ecfg.compute_mode not in ("device", "host"):
            raise ValueError(f"compute_mode={ecfg.compute_mode!r}: want 'device' or 'host'")
        cfg = model.cfg
        if cfg.moe is None:
            raise ValueError(f"OffloadEngine requires a MoE model; {cfg.name} has "
                             f"{'dense FFN layers' if cfg.d_ff else 'no FFN layers'} (serve "
                             "it with DenseBackend)")
        # the HOBBIT model class: MoE behind full-window "attn" layers in every
        # layer (the reference asserts these layer kinds), no MLA, no shared
        # experts and no sandwich norms, which the engine's layer step does
        # not apply (its attention reads "wk" / "wv" and a {"k", "v"} cache)
        kinds = sorted(set(cfg.layer_kinds()) - {"attn"})
        why = [f"{'/'.join(kinds)} layers"] if kinds else []
        if cfg.mla is not None:
            why.append("MLA attention")
        if not all(cfg.layer_is_moe()):
            why.append("dense FFN layers")
        if cfg.moe.num_shared_experts:
            why.append(f"{cfg.moe.num_shared_experts} shared expert(s)")
        if cfg.sandwich_norm:
            why.append("sandwich norms")
        if why:
            raise ValueError(f"OffloadEngine serves MoE models of full-window 'attn' "
                             f"layers only; {cfg.name} has {', '.join(why)} (serve it "
                             "with DenseBackend)")
        self.model = model
        self.cfg = cfg
        self.ecfg = ecfg
        self.params = params
        self.device = params["embed"].device
        self.grouped = ecfg.grouped and ecfg.compute_mode == "device"
        self.layer_params = unstack_layers(cfg, params)
        self.moe_layers = [i for i, m in enumerate(cfg.layer_is_moe()) if m]
        self.num_moe_layers = len(self.moe_layers)
        mc = cfg.moe
        d, f = cfg.d_model, mc.d_ff_expert

        # ---- host storage: hi (model dtype) + lo (quantized), pinned ----
        self._pin = self.device.type == "cuda"
        self.storage_hi: List[Dict[str, torch.Tensor]] = []
        self.storage_lo: List[Dict[str, torch.Tensor]] = []
        self.routers: List[torch.Tensor] = []
        for li in self.moe_layers:
            ffn = self.layer_params[li]["ffn"]
            self.storage_hi.append({n: self._host_copy(ffn["experts"][n])
                                    for n in HI_NAMES})
            self.storage_lo.append(self._quantize_layer(ffn["experts"]))
            self.routers.append(ffn["router"].to(torch.float32))
        # routers stacked on device for the per-layer gating kernel, and a
        # float32 host copy for the per-expert path's numpy gating
        self.routers_dev = torch.stack(self.routers).contiguous()   # (L, D, E)
        self.routers_host: List[np.ndarray] = to_host(*self.routers)

        # ---- device pools (grouped path: overflow rows from _ensure_pools) ----
        self.pool_hi: Dict[str, torch.Tensor] = {}
        self.pool_lo: Dict[str, torch.Tensor] = {}
        self._ovf_rows = 0
        self._ensure_pools(mc.top_k)

        # ---- manager / loader / predictor ----
        # owner: main-thread
        self.fleet = FleetHeat()
        self.cache = MultidimensionalCache(self.num_moe_layers, ecfg.hi_slots,
                                           ecfg.lo_slots, ecfg.policy,
                                           fleet=self.fleet)
        hi_b = expert_nbytes(d, f, 16)
        lo_b = expert_nbytes(d, f, ecfg.lo_bits, group_size=ecfg.group_size)
        self.expert_bytes = {PREC_HI: hi_b, PREC_LO: lo_b}
        one = {n: t[0].nbytes for n, t in (*self.storage_hi[0].items(),
                                          *self.storage_lo[0].items())}
        # one expert's bytes as the grouped FFN kernels read them
        # (kops.grouped_ffn_weight_bytes)
        self._matrix_bytes = dict(hi_bytes=one["wi"] + one["wo"],
                                  lo_wi_bytes=one["wi_data"] + one["wi_scale"],
                                  lo_wo_bytes=one["wo_data"] + one["wo_scale"])
        self.loader = DynamicExpertLoader(
            self.cache, ecfg.thresholds if ecfg.dynamic_loading
            else Thresholds(1.0, 1.0),
            self._fetch, lambda prec: self.expert_bytes[prec])
        link_bps = (ecfg.link_gbps * 1e9 if ecfg.link_gbps
                    else measure_link_bps(device=self.device))
        self.scheduler = StagingEngine(
            self.loader, self._stage, self._commit_staged,
            streams=ecfg.streams, ordered=ecfg.ordered, link_bps=link_bps,
            emulate_link=ecfg.link_gbps is not None, upgrade=ecfg.upgrade)
        self.predictor = AdaptiveExpertPredictor(
            self.routers, mc.top_k, p=ecfg.prefetch_p, fleet=self.fleet,
            device=self.device)

        self._copy_streams = threading.local()   # one CUDA stream per thread
        self._pending_preds: List = []
        self.trace: List[List[TraceLayer]] = []
        self._gating_s = 0.0
        self._hi_pairs: Dict[int, int] = {}     # hi pairs per grouped launch -> launches
        self._lo_pairs: Dict[int, int] = {}     # lo pairs per grouped launch -> launches
        self._lo_slots: Dict[int, int] = {}     # distinct lo slots per grouped launch -> launches
        self._hi_slots: Dict[int, int] = {}     # distinct hi slots per grouped launch -> launches
        self._expert_dispatches = 0
        self._union_reloads = 0
        self._segment_predictions = 0   # row-layer predictions from segment readbacks
        self._layer_s_ema = 0.0
        self._layer_period_ema = 0.0
        self._closed = False
        self.batch = 1
        self.max_len = 0
        self.active = np.ones((1,), bool)
        self.positions = np.zeros((1,), np.int64)
        self.kv_cache: Optional[List[Dict[str, torch.Tensor]]] = None
        self.kv_pool: Optional[PagedKVPool] = None     # when ecfg.paged_kv
        self._admission: Optional[ChunkedPrefill] = None
        self._pending_joins: Dict[int, np.ndarray] = {}
        self._unclaimed_joins: Dict[int, np.ndarray] = {}
        # the grouped path's captured steps and the step state they share
        # (positions, page table, active mask; start_batch allocates it)
        self._step_state: Optional[Tuple] = None
        self._embed_step = CapturedStep(self._embed, "engine_embed")
        self._layer_steps = [CapturedStep(functools.partial(self._layer_segment, mi),
                                          f"engine_layer{mi}")
                             for mi in range(self.num_moe_layers)]
        self._logits_step = CapturedStep(self._logits, "engine_logits")
        # the grouped FFN, one graph shared by every MoE layer (the pools are
        # shared), reading the pair table that each layer's host work fills
        # in pinned memory and copies over (start_batch allocates both)
        self._ffn_step = CapturedStep(self._ffn, "engine_ffn")
        self._ffn_table: Optional[torch.Tensor] = None
        self._table_host: Optional[torch.Tensor] = None
        # the per-expert path's segments (attention and FFN norm, no gating);
        # its single experts' steps (_expert_step) come with the pools
        self._attn_steps = [CapturedStep(functools.partial(self._attn_segment, mi),
                                         f"engine_attn{mi}")
                            for mi in range(self.num_moe_layers)]
        # the one-shot dense-KV prefill, captured per repeated prompt shape
        self._prefill = DenseKVPrefill(model, params)

    # ------------------------------------------------------------------
    # host storage and device pools
    # ------------------------------------------------------------------
    def _host_copy(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=self._pin)
        out.copy_(t)
        return out

    def _quantize_layer(self, experts) -> Dict[str, torch.Tensor]:
        """Quantize one layer's experts on their device, one expert at a
        time, into (pinned) host code/scale tensors."""
        ecfg = self.ecfg
        out: Dict[str, torch.Tensor] = {}
        for n in HI_NAMES:
            w = experts[n]
            num, k, cols = w.shape
            kp = k // PACK_FACTOR[ecfg.lo_bits]
            data = torch.empty((num, kp, cols), dtype=torch.int8, pin_memory=self._pin)
            scale = torch.empty((num, k // ecfg.group_size, cols), dtype=torch.float32,
                                pin_memory=self._pin)
            for e in range(num):
                q = quantize(w[e].to(torch.float32), bits=ecfg.lo_bits,
                             group_size=ecfg.group_size)
                data[e].copy_(q.data)
                scale[e].copy_(q.scale)
            out[f"{n}_data"], out[f"{n}_scale"] = data, scale
        return out

    def _ensure_pools(self, overflow_rows: int) -> None:
        """Pool tensors with `overflow_rows` extra rows after the cache slots
        (union-overflow experts of one layer; none on the per-expert path,
        which admits them into the cache).  Growing keeps the resident
        slots' contents."""
        if not self.grouped:
            overflow_rows = 0
        if self.pool_hi and overflow_rows <= self._ovf_rows:
            return
        ecfg = self.ecfg
        lo0 = self.storage_lo[0]
        hi0 = self.storage_hi[0]
        for pool, names, src, slots in ((self.pool_hi, HI_NAMES, hi0, ecfg.hi_slots),
                                        (self.pool_lo, LO_NAMES, lo0, ecfg.lo_slots)):
            for n in names:
                new = torch.zeros((slots + overflow_rows, *src[n].shape[1:]),
                                  dtype=src[n].dtype, device=self.device)
                if n in pool:
                    new[:slots].copy_(pool[n][:slots])
                pool[n] = new
        self._ovf_rows = overflow_rows
        # the expert graphs bake in the pools replaced here; their memory
        # pool goes with them, a new one for the next captures
        self._expert_steps: Dict[Tuple[int, int], CapturedStep] = {}
        self._expert_pool = GraphPool()

    # ------------------------------------------------------------------
    # device transfer
    # ------------------------------------------------------------------
    def _copy_stream(self) -> torch.cuda.Stream:
        s = getattr(self._copy_streams, "stream", None)
        if s is None:
            s = torch.cuda.Stream(device=self.device)
            self._copy_streams.stream = s
        return s

    def _stage(self, moe_idx: int, expert: int, precision: int) -> dict:
        """Bring one expert's bytes onto the device (the host half of the
        transfer).  CUDA: pinned host -> fresh staging buffers on this
        thread's copy stream, returning once the bytes have landed (the
        staging engine's futures then time the real link).  CPU: views of
        host storage.  Touches no pool, so background threads may run it."""
        names = HI_NAMES if precision == PREC_HI else LO_NAMES
        src = (self.storage_hi if precision == PREC_HI else self.storage_lo)[moe_idx]
        if self.device.type != "cuda":
            return {"tensors": {n: src[n][expert] for n in names}, "event": None}
        stream = self._copy_stream()
        with torch.cuda.stream(stream):
            bufs = {n: src[n][expert].to(self.device, non_blocking=True) for n in names}
            ev = torch.cuda.Event()
            ev.record(stream)
        ev.synchronize()
        return {"tensors": bufs, "event": ev}

    def _commit_one(self, precision: int, slot: int, staged: dict) -> None:
        """Copy staged buffers into pool slot `slot` on the compute stream."""
        pool = self.pool_hi if precision == PREC_HI else self.pool_lo
        ev = staged["event"]
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
        for n, t in staged["tensors"].items():
            pool[n][slot].copy_(t, non_blocking=True)
            if ev is not None:
                t.record_stream(cur)     # freed buffers wait for this copy

    def _commit_staged(self, entries) -> None:
        """Write staged buffers into the device pools (main thread only).
        entries: [(task_like_with_precision, slot, staged)]."""
        for t, slot, staged in entries:
            self._commit_one(PREC_HI if t.precision == PREC_HI else PREC_LO, slot, staged)

    def _fetch(self, moe_idx: int, expert: int, precision: int, slot: int):
        """Blocking load of one expert into a pool slot (the synchronous
        loader's 'cudaMemcpy')."""
        self._commit_one(precision, slot, self._stage(moe_idx, expert, precision))

    def _fetch_many(self, items: List[Tuple[int, int, int, int]]) -> None:
        """Blocking batched fetch into admitted pool slots: items =
        [(moe_idx, expert, precision, slot)], staged one by one, committed
        together and counted as loader traffic.  The decode paths stage and
        commit through the loader and the staging engine; this is the
        standalone entry point for warm-up, pre-population and tests."""
        entries = []
        for mi, e, prec, slot in items:
            t = LoadTask(mi, e, int(prec), ON_DEMAND, self.expert_bytes[int(prec)])
            entries.append((t, slot, self._stage(mi, e, int(prec))))
            self.loader.loaded_bytes += t.bytes
            self.loader.n_loads[t.precision] += 1
        self._commit_staged(entries)

    # ------------------------------------------------------------------
    # serving state
    # ------------------------------------------------------------------
    def start_batch(self, batch: int, max_len: int):
        """Allocate per-slot KV caches and reset serving state for a new
        batch; all slots start active."""
        self._check_open()
        self.batch = batch
        self.max_len = max_len
        self.scheduler.flush()          # land any cross-batch in-flight loads
        self.cache.new_sequence()
        self._ensure_pools(batch * self.cfg.moe.top_k)
        if self.ecfg.paged_kv:
            self.kv_cache = None
            self.kv_pool = self.model.init_cache(
                batch, max_len, self.device, paged=True,
                page_size=self.ecfg.kv_page_size, num_pages=self.ecfg.kv_pages,
                prefix_sharing=self.ecfg.prefix_sharing)
            self._admission = ChunkedPrefill(self.model, self.params, self.kv_pool,
                                             chunk=self.ecfg.prefill_chunk)
            table = torch.zeros(self.kv_pool.table.shape, dtype=torch.int32,
                                device=self.device)
            active = torch.ones((batch,), dtype=torch.bool, device=self.device)
        else:
            self.kv_cache = self.model.init_cache(batch, max_len, self.device)
            table = active = None
        self._step_state = (torch.zeros((batch,), dtype=torch.int64, device=self.device),
                            table, active)
        words = pair_table_words(batch, self.cfg.moe.top_k)
        self._ffn_table = torch.zeros((words,), dtype=torch.int32, device=self.device)
        self._table_host = torch.zeros((words,), dtype=torch.int32, pin_memory=self._pin)
        for captured in (self._embed_step, *self._layer_steps, self._ffn_step,
                         self._logits_step, *self._attn_steps):
            captured.reset()            # the graphs bake in the buffers replaced here
        self.positions = np.zeros((batch,), np.int64)
        self.active = np.ones((batch,), bool)
        self.trace = []
        self._pending_preds = []
        self._pending_joins = {}
        self._unclaimed_joins = {}

    def start_sequence(self, max_len: int, batch: int = 1):
        """``start_batch`` under the single-sequence API's argument order."""
        self.start_batch(batch, max_len)

    def prefill_batch(self, prompts) -> np.ndarray:
        """Prefill the whole prompt batch through the dense model (prefill
        touches every expert anyway; the offload cache serves decode) and
        adopt its KV cache; paged KV prefills in chunks through the pool,
        every row reserving max_len.  Returns last-token logits (B, V)."""
        self._check_open()
        prompts = np.asarray(prompts, np.int64)
        b, s = prompts.shape
        if b != self.batch:
            raise ValueError(f"prefill of {b} prompts into a batch of {self.batch}")
        if self.ecfg.paged_kv:
            logits = self._admission.run_batch(prompts, self.max_len)
            self.positions = np.full((b,), s, np.int64)
            self.active[:] = True
            return logits
        logits = self._prefill(self.kv_cache, prompts, self.max_len)  # in place
        self.positions = np.full((b,), s, np.int64)
        self.active[:] = True
        return logits

    def join(self, slot: int, prompt) -> np.ndarray:
        """Blocking admission of one request into `slot` (the shared
        ``serving.api._blocking_join`` loop).  Returns logits (V,)."""
        self._check_open()
        if not 0 <= slot < self.batch:
            raise ValueError(f"slot {slot} outside batch {self.batch}")
        from repro_torch.serving.api import _blocking_join
        return _blocking_join(self, slot, prompt)

    def _join_dense(self, slot: int, prompt) -> np.ndarray:
        prompt = np.asarray(prompt, np.int64).reshape(1, -1)
        logits = self._prefill(self.kv_cache, prompt, self.max_len, slot)
        self.positions[slot] = prompt.shape[1]
        self.active[slot] = True
        self._pending_preds = [pp for pp in self._pending_preds if pp[2] != slot]
        return logits[0]

    def join_begin(self, slot: int, prompt, reserve_tokens=None):
        """Start an incremental admission.  Paged KV: reserve pages for
        `reserve_tokens` (default max_len) and queue the prompt for chunked
        prefill.  Dense KV: stash the prompt; join_step runs its one-shot
        prefill."""
        self._check_open()
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if self.ecfg.paged_kv:
            self._admission.begin(slot, prompt,
                                  reserve_tokens=reserve_tokens or self.max_len)
        else:
            self._pending_joins[slot] = prompt

    def join_step(self) -> Dict[int, np.ndarray]:
        """Advance every pending admission (one prefill chunk under paged
        KV); completed slots become active.  Returns {slot: last-token
        logits}, including logits an earlier blocking join finished but did
        not claim."""
        done: Dict[int, np.ndarray] = dict(self._unclaimed_joins)
        self._unclaimed_joins = {}
        if self.ecfg.paged_kv:
            done.update(self._admission.step())
            for slot in done:
                self.positions[slot] = int(self.kv_pool.lens[slot])
                self.active[slot] = True
                self._pending_preds = [pp for pp in self._pending_preds if pp[2] != slot]
            return done
        for slot, prompt in list(self._pending_joins.items()):
            del self._pending_joins[slot]
            done[slot] = self._join_dense(slot, prompt)
        return done

    def can_admit(self, tokens: int, *, prompt=None) -> bool:
        """KV-capacity admission gate: paged KV checks unreserved pages
        (with `prompt`, net of the best prefix-sharing plan); dense KV
        always admits (slots are pre-allocated to max_len)."""
        if self.ecfg.paged_kv and self.kv_pool is not None:
            return self.kv_pool.can_reserve(tokens, prompt=prompt)
        return True

    def release(self, slot: int):
        """Free a slot (paged KV returns its pages to the pool); retires the
        request from the fleet heat map."""
        self.active[slot] = False
        self._pending_preds = [pp for pp in self._pending_preds if pp[2] != slot]
        if self.ecfg.paged_kv and self.kv_pool is not None:
            self.kv_pool.release(slot)
        self.fleet.retire_request()

    def pause(self, slot: int) -> Dict:
        """Preempt `slot`: snapshot its KV state to host and free the slot
        (paged KV: the snapshot is taken before the release, so pages
        aliased by other slots keep their sharers).  The expert cache is
        shared and left as is."""
        self._check_open()
        pos = int(self.positions[slot])
        self._pending_preds = [pp for pp in self._pending_preds if pp[2] != slot]
        if self.ecfg.paged_kv and self.kv_pool is not None:
            snap = self.kv_pool.snapshot_slot(slot)
            self.kv_pool.release(slot)
            self.active[slot] = False
            return {"layout": "paged", "position": pos, "kv": snap}
        rows = [{"k": c["k"][slot].to("cpu", copy=True),
                 "v": c["v"][slot].to("cpu", copy=True)}
                for c in self.kv_cache]
        self.active[slot] = False
        return {"layout": "dense", "position": pos, "cache": rows}

    def resume(self, slot: int, snapshot: Dict) -> None:
        """Reinstate a paused request into (a possibly different) `slot`;
        decode continues logits-identically.  Paged KV raises
        PagePoolExhausted when the pool cannot host the snapshot now."""
        self._check_open()
        if snapshot["layout"] == "paged":
            self.kv_pool.restore_slot(slot, snapshot["kv"])
        else:
            for c, row in zip(self.kv_cache, snapshot["cache"]):
                c["k"][slot].copy_(row["k"])
                c["v"][slot].copy_(row["v"])
        self.positions[slot] = int(snapshot["position"])
        self.active[slot] = True

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def decode_step_batch(self, tokens) -> np.ndarray:
        """One batched HOBBIT decode step.  tokens: (B,) int; returns logits
        (B, V).  Inactive slots ride through attention but take no part in
        gating, loading, expert compute, the trace or position advance.
        The grouped path serves ``grouped=True`` in device compute mode; the
        per-expert reference path serves the rest."""
        self._check_open()
        with span("engine.step") as sp:
            if sp.on:
                sp.attrs.update(step=self.cache.records.t,
                                rows=int(np.count_nonzero(self.active)))
            if self.grouped:
                return self._decode_step_batch_grouped(tokens)
            return self._decode_step_batch_reference(tokens)

    def decode_token(self, token: int) -> np.ndarray:
        """One decode step at batch 1 (the single-sequence API).  Returns
        logits (V,)."""
        if self.batch != 1:
            raise ValueError(f"decode_token is batch 1 (batch is {self.batch}); "
                             "use decode_step_batch")
        return self.decode_step_batch(np.asarray([int(token)], np.int64))[0]

    def _step_tokens(self, tokens) -> np.ndarray:
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        if tokens.shape[0] != self.batch:
            raise ValueError(f"{tokens.shape[0]} tokens for a batch of {self.batch}")
        return tokens

    def _step_prologue(self, rows) -> Tuple:
        """Per-step attention state, written into the step-state buffers
        that every layer reads (the captured segments' shared static
        inputs): positions and, under paged KV, each active slot's page
        chain grown for this step's token (COW off shared pages first), the
        table exported once and the active mask."""
        positions, table, active = self._step_state
        positions.copy_(to_device(self.positions, self.device))
        if self.ecfg.paged_kv:
            table.copy_(self.kv_pool.prepare_decode(rows, self.positions))
            active.copy_(to_device(self.active, self.device))
        return self._step_state

    def _segment_key(self, li: int) -> tuple:
        """The buffers layer li's captured segment reads or writes in place:
        the step state and the layer's KV."""
        if self.ecfg.paged_kv:
            kv = (self.kv_pool.k[li], self.kv_pool.v[li])
        else:
            kv = (self.kv_cache[li]["k"], self.kv_cache[li]["v"])
        return addresses(t for t in (*self._step_state, *kv) if t is not None)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.model.embed(self.params, tokens)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.model.logits(self.params, x)[:, 0]

    def _layer_segment(self, mi: int, x: torch.Tensor):
        """MoE layer mi's fixed-shape segment on the grouped path: attention,
        the FFN norm, the gating kernel and, with prefetch on, the adaptive
        predictor's stacked gating for every row on the float32 normed
        hidden state (``AdaptiveExpertPredictor.layer_probs``).  Returns the
        residual stream, the normed hidden state hs (B, D), the router's
        top-k probabilities and experts (B, k) and the predictor's
        probabilities (P, B, E) for MoE layers mi+1..mi+P (None on the last
        MoE layer or with prefetch off)."""
        x, h, h32 = self._attn_segment(mi, x)
        hs = h[:, 0]
        _, vals, idx = kops.gating_topk(hs, self.routers_dev[mi:mi + 1],
                                        top_k=self.cfg.moe.top_k)
        probs = self.predictor.layer_probs(h32, mi) if self.ecfg.prefetch else None
        return x, hs, vals[0], idx[0], probs

    def _attn_segment(self, mi: int, x: torch.Tensor):
        """MoE layer mi's attention and FFN norm (the per-expert path's
        captured segment: it gates on the host).  Returns the residual
        stream, the normed hidden state h (B, 1, D) and its float32 copy
        (B, D), what the host reads."""
        li = self.moe_layers[mi]
        x = self._attn_layer(li, x, self._step_state)
        h = L.apply_norm(self.layer_params[li]["ffn_norm"], x, self.cfg)
        return x, h, h[:, 0].to(torch.float32)

    def _attn_layer(self, li: int, x: torch.Tensor, step: Tuple) -> torch.Tensor:
        """Layer li's attention against whichever KV layout is active (its
        state updated in place); returns the residual stream."""
        positions, table, active_dev = step
        p = self.layer_params[li]
        h = L.apply_norm(p["pre_norm"], x, self.cfg)
        if self.ecfg.paged_kv:
            return x + L.paged_attn_decode(p["attn"], h, self.kv_pool.k[li],
                                           self.kv_pool.v[li], table, positions,
                                           active_dev, self.cfg)
        return x + L.attn_decode(p["attn"], h, self.kv_cache[li], positions, self.cfg)

    def _score_pending_preds(self, mi: int, tops: Dict[int, np.ndarray]):
        still_pending = []
        for pred, made_at, r in self._pending_preds:
            if pred.layer == mi:
                if r in tops:
                    self.predictor.record_accuracy(pred, tops[r].tolist(),
                                                   mi - made_at)
            elif pred.layer > mi:
                still_pending.append((pred, made_at, r))
        self._pending_preds = still_pending

    def _push_pending(self, pr, mi: int, r: int):
        """Keep at most one pending prediction per (layer, slot)."""
        self._pending_preds = [
            (p, m, rr) for p, m, rr in self._pending_preds
            if not (p.layer == pr.layer and rr == r)]
        self._pending_preds.append((pr, mi, r))

    def _prefetch_predictions(self, mi: int, rows, *, use_async: bool, h_host=None,
                              probs: Optional[np.ndarray] = None) -> Dict[int, object]:
        """Adaptive prefetch for subsequent layers (§3.3): one merged job per
        target layer, each (expert, precision) keeping the largest gate any
        row gave it.  Each row predicts from `probs`, the segment's (P, B, E)
        predictor probabilities (grouped path), or else from its hidden
        state in `h_host` (B, D) through the predictor's own calls."""
        pred_entry: Dict[int, object] = {}
        merged: Dict[int, List[Tuple[int, int]]] = {}
        gmax: Dict[Tuple[int, int, int], float] = {}
        for r in rows:
            hid = None if h_host is None else h_host[r]
            row_probs = None if probs is None else probs[:, r]
            if row_probs is not None:
                self._segment_predictions += 1
            walk = self.predictor.adaptive_walk(hid, mi, self.cache, self.loader.th,
                                                probs=row_probs)
            walk_layers = set()
            for pr, dec in walk:
                pairs = merged.setdefault(pr.layer, [])
                for e, d, g in zip(pr.experts, dec, pr.gate_vals):
                    if (int(e), int(d)) not in pairs:
                        pairs.append((int(e), int(d)))
                    gk = (pr.layer, int(e), int(d))
                    gmax[gk] = max(gmax.get(gk, 0.0), float(g))
                self._push_pending(pr, mi, r)
                walk_layers.add(pr.layer)
                if pr.layer == mi + 1:
                    pred_entry[r] = pr
            if mi + 1 not in walk_layers:
                nxt = self.predictor.predict_layers(hid, mi, 1, probs=row_probs)
                if nxt:
                    self._push_pending(nxt[0], mi, r)
                    pred_entry[r] = nxt[0]
        for layer, pairs in merged.items():
            experts = [e for e, _ in pairs]
            dec = np.asarray([d for _, d in pairs])
            gates = np.asarray([gmax[(layer, e, d)] for e, d in pairs])
            if use_async:
                self.scheduler.submit_prefetch(layer, experts, dec,
                                               current_layer=mi, gates=gates)
            else:
                self.loader.enqueue_prefetch(layer, experts, dec)
        return pred_entry

    def _trace_entry(self, mi, r, tops, gates, pred_entry) -> TraceLayer:
        pe = pred_entry.get(r)
        return TraceLayer(
            experts=tops[r].tolist(), gate_vals=gates[r],
            pred_experts=pe.experts if (pe and pe.layer == mi + 1) else None,
            pred_gate_vals=pe.gate_vals if (pe and pe.layer == mi + 1) else None)

    def _ffn(self, hs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The layer's grouped FFN on the pair table this layer's host work
        filled (``grouped_ffn``); returns the residual stream x + y."""
        mc = self.cfg.moe
        return grouped_ffn(hs, x, self._ffn_table, self.pool_hi, self.pool_lo, self.cfg,
                           top_k=mc.top_k, lo_bits=self.ecfg.lo_bits,
                           group_size=self.ecfg.group_size)

    def _ffn_key(self) -> tuple:
        """The buffers the captured FFN reads in place: every pool tensor
        (``_ensure_pools`` reallocates them) and the pair table."""
        return addresses((*self.pool_hi.values(), *self.pool_lo.values(), self._ffn_table))

    def _decode_step_batch_grouped(self, tokens) -> np.ndarray:
        ecfg = self.ecfg
        tokens = self._step_tokens(tokens)
        rows = [r for r in range(self.batch) if self.active[r]]
        with span("engine.prologue"):
            self.cache.advance_token()
            x = self._embed_step(to_device(tokens[:, None], self.device))
            self._step_prologue(rows)

        row_trace = {r: [] for r in rows}
        for mi, li in enumerate(self.moe_layers):
            t_layer0 = time.perf_counter()
            self.scheduler.set_deadline_clock(mi, self._layer_s_ema,
                                              self._layer_period_ema)
            # ---- the captured segment (attention, norm, gating, the
            # predictor's gating), then one host sync for the router result
            # and the predictor's probabilities ----
            with span("engine.segment", mi):
                tg0 = time.perf_counter()
                x, hs, vals_g, idx_g, probs_g = self._layer_steps[mi](
                    x, key=self._segment_key(li))
                vals_np, idx_np, *probs_np = to_host(
                    *(t for t in (vals_g, idx_g, probs_g) if t is not None))
                self._gating_s += time.perf_counter() - tg0

            with span("engine.route", mi):
                tops: Dict[int, np.ndarray] = {}
                gates: Dict[int, np.ndarray] = {}
                for r in rows:
                    tops[r] = idx_np[r]
                    gates[r] = vals_np[r]
                    for e, g in zip(tops[r], gates[r]):
                        self.fleet.observe((mi, int(e)), float(g))

                self._score_pending_preds(mi, tops)

                # ---- on-demand scoring (union over slots); pins first ----
                self.loader.new_layer()
                for r in rows:
                    self.loader.score_and_enqueue(mi, tops[r].tolist(), gates[r],
                                                  clear_pins=False)

            pred_entry = {}
            if ecfg.prefetch:
                with span("engine.predict", mi):
                    pred_entry = self._prefetch_predictions(
                        mi, rows, use_async=ecfg.async_prefetch,
                        probs=probs_np[0] if probs_np else None)

            # ---- loading ----
            with span("engine.load", mi):
                t_load0 = time.perf_counter()
                if ecfg.async_prefetch:
                    self.scheduler.wait(mi)
                    self.scheduler.drain_on_demand(self.loader.take_queued(), mi)
                else:
                    self.loader.drain(mi)
                t_load = time.perf_counter() - t_load0

            with span("engine.pairs", mi):
                hi_pairs, lo_pairs, w_hi, w_lo = self._layer_pairs(mi, rows, tops, gates)
                n_hs = len({s_ for _, _, s_ in hi_pairs})
                n_ls = len({s_ for _, _, s_ in lo_pairs})
                for hist, n in ((self._hi_pairs, len(hi_pairs)),
                                (self._lo_pairs, len(lo_pairs)),
                                (self._hi_slots, n_hs), (self._lo_slots, n_ls)):
                    hist[n] = hist.get(n, 0) + 1

            with span("engine.ffn", mi) as sp:
                # the pinned table is rewritten only after this layer's
                # readback synchronised the stream that copied it for the
                # layer before
                table = self._table_host.numpy()
                pack_pair_table(table, hi_pairs, lo_pairs, w_hi, w_lo)
                self._ffn_table.copy_(self._table_host, non_blocking=True)
                x = self._ffn_step(hs, x, key=self._ffn_key())
                self._expert_dispatches += 1
            if sp.on:                   # outside the span: its time is the FFN's
                p = self.batch * self.cfg.moe.top_k   # pack_pair_table's index rows
                idx = table[:6 * p].reshape(6, p)
                sp.attrs.update(hi_pairs=len(hi_pairs), lo_pairs=len(lo_pairs),
                                hi_slots=n_hs, lo_slots=n_ls,
                                weight_bytes=kops.grouped_ffn_weight_bytes(
                                    idx[2], idx[5], idx[3] < self.batch, **self._matrix_bytes))

            with span("engine.retire", mi):
                for r in rows:
                    row_trace[r].append(self._trace_entry(mi, r, tops, gates,
                                                          pred_entry))
                self.scheduler.retire_layer(mi)
                dt_full = time.perf_counter() - t_layer0
                dt = dt_full - t_load
                self._layer_s_ema = (dt if self._layer_s_ema == 0.0
                                     else 0.8 * self._layer_s_ema + 0.2 * dt)
                self._layer_period_ema = (
                    dt_full if self._layer_period_ema == 0.0
                    else 0.8 * self._layer_period_ema + 0.2 * dt_full)

        with span("engine.logits"):
            return self._step_epilogue(self._logits_step(x), rows, row_trace)

    def _layer_pairs(self, mi: int, rows, tops, gates):
        """MoE layer mi's (row, rank, pool slot) hi and lo pairs and their
        (B, k) gate weights: each row's precision decisions and cache
        lookups, union-overflow experts staged and committed into the extra
        pool rows (``engine.reload``: the wait for the copy, which
        ``load_stall_s`` does not count)."""
        ecfg = self.ecfg
        b, k = self.batch, self.cfg.moe.top_k
        hi_pairs, lo_pairs = [], []
        w_hi = np.zeros((b, k), np.float32)
        w_lo = np.zeros((b, k), np.float32)
        n_ovf_hi = n_ovf_lo = 0
        for r in rows:
            dec = precision_decisions(gates[r], self.loader.th)
            for j in range(k):
                d_ = int(dec[j])
                if d_ == PREC_SKIP:
                    continue
                e = int(tops[r][j])
                is_hi = d_ == PREC_HI
                slot = self.cache.lookup((mi, e), is_hi)
                if (slot is not None and is_hi
                        and self.cache.is_inflight((mi, e), True)):
                    # an upgrade re-copy owns the slot but its bytes are
                    # still landing; the slot holds no hi weights yet
                    slot = None
                if (slot is None and is_hi and ecfg.async_prefetch
                        and self.scheduler.serves_lo_downgrade(mi, e)):
                    # issue-time downgrade: serve the lo copy
                    is_hi = False
                    slot = self.cache.lookup((mi, e), False)
                    self.scheduler.served_lo_expert_steps += 1
                if slot is None:
                    if is_hi:
                        self.cache.stats.misses_hi += 1
                        slot = ecfg.hi_slots + n_ovf_hi
                        n_ovf_hi += 1
                    else:
                        self.cache.stats.misses_lo += 1
                        slot = ecfg.lo_slots + n_ovf_lo
                        n_ovf_lo += 1
                    with span("engine.reload", mi, e, d_, self.expert_bytes[d_]):
                        self._commit_one(d_, slot, self._stage(mi, e, d_))
                    self.loader.loaded_bytes += self.expert_bytes[d_]
                    self.loader.n_loads[d_] += 1
                    self._union_reloads += 1
                if is_hi:
                    hi_pairs.append((r, j, slot))
                    w_hi[r, j] = gates[r][j]
                else:
                    lo_pairs.append((r, j, slot))
                    w_lo[r, j] = gates[r][j]
        return hi_pairs, lo_pairs, w_hi, w_lo

    def _step_epilogue(self, lg: torch.Tensor, rows, row_trace) -> np.ndarray:
        """Advance the active slots, keep their trace rows and read the
        step's logits (B, V) back."""
        self.positions = self.positions + self.active.astype(np.int64)
        for r in rows:
            self.trace.append(row_trace[r])
        return to_host(lg)[0]

    # ---- per-expert reference path (the parity baseline) ----
    def _decode_step_batch_reference(self, tokens) -> np.ndarray:
        """The reference's per-expert step: gating on the host in numpy,
        synchronous loading (whatever ``async_prefetch`` says: the staging
        engine is not used), a union-overflow miss admitted into the cache
        and fetched into its slot, then each active row's experts one at a
        time, combined in float32 and renormalised by the kept gate mass."""
        cfg, ecfg, mc = self.cfg, self.ecfg, self.cfg.moe
        tokens = self._step_tokens(tokens)
        rows = [r for r in range(self.batch) if self.active[r]]
        self.cache.advance_token()
        x = self._embed_step(to_device(tokens[:, None], self.device))
        self._step_prologue(rows)

        row_trace = {r: [] for r in rows}
        for mi, li in enumerate(self.moe_layers):
            # attention and the FFN norm, h (B, 1, D), then one host sync
            x, h, h32 = self._attn_steps[mi](x, key=self._segment_key(li))
            (h_host,) = to_host(h32)

            # ---- gating on the host, per row, as the reference writes it ----
            tops: Dict[int, np.ndarray] = {}
            gates: Dict[int, np.ndarray] = {}
            for r in rows:
                logits = h_host[r] @ self.routers_host[mi]
                probs = np.exp(logits - logits.max())
                probs /= probs.sum()
                tops[r] = np.argsort(-probs)[: mc.top_k]
                gates[r] = probs[tops[r]]
                for e, g in zip(tops[r], gates[r]):
                    self.fleet.observe((mi, int(e)), float(g))

            self._score_pending_preds(mi, tops)
            pred_entry = {}
            if ecfg.prefetch:
                with span("engine.predict", mi):
                    pred_entry = self._prefetch_predictions(mi, rows, use_async=False,
                                                            h_host=h_host)

            # ---- on-demand scoring + synchronous loading (union over rows) ----
            self.loader.new_layer()
            for r in rows:
                self.loader.score_and_enqueue(mi, tops[r].tolist(), gates[r],
                                              clear_pins=False)
            self.loader.drain(mi)

            # ---- expert compute, row by row, expert by expert ----
            y = torch.zeros((self.batch, cfg.d_model), dtype=torch.float32,
                            device=self.device)
            for r in rows:
                hr = h[r:r + 1]                                     # (1, 1, D)
                dec = precision_decisions(gates[r], self.loader.th)
                wsum = 0.0
                for e, d_, w in zip(tops[r], dec, gates[r]):
                    if d_ == PREC_SKIP:
                        continue
                    e, d_ = int(e), int(d_)
                    is_hi = d_ == PREC_HI
                    slot = self.cache.lookup((mi, e), is_hi)
                    if slot is None:
                        # union-overflow reload: a neighbour row's admission
                        # evicted it this layer; the reference re-admits
                        if is_hi:
                            self.cache.stats.misses_hi += 1
                        else:
                            self.cache.stats.misses_lo += 1
                        slot, _ = self.cache.admit((mi, e), is_hi, mi)
                        self._fetch(mi, e, d_, slot)
                        self.loader.loaded_bytes += self.expert_bytes[d_]
                        self.loader.n_loads[d_] += 1
                        self._union_reloads += 1
                    if ecfg.compute_mode == "host":
                        out = self._host_expert(mi, e, d_, hr)
                    else:
                        pool = self.pool_hi if is_hi else self.pool_lo
                        out = self._expert_step(d_, slot)(hr, key=addresses(pool.values()))
                    y[r] += float(w) * out.reshape(-1).to(torch.float32)
                    wsum += float(w)
                if wsum > 0:
                    y[r] /= wsum                                    # renormalise (skips)
                row_trace[r].append(self._trace_entry(mi, r, tops, gates, pred_entry))
            x = x + y[:, None, :].to(x.dtype)

        return self._step_epilogue(self._logits_step(x), rows, row_trace)

    def _expert_step(self, precision: int, slot: int) -> CapturedStep:
        """The captured single expert on pool slot `slot` ("engine_hi" /
        "engine_lo"): one step per (precision, slot), keyed by the pool
        tensors' addresses, which its graph bakes in with the slot's
        weights; every such graph in one shared pool (each output is added
        into the layer's sum before the next expert replays).  The graphs
        live across ``start_batch`` until ``_ensure_pools`` reallocates
        the pools."""
        step = self._expert_steps.get((precision, slot))
        if step is None:
            hi = precision == PREC_HI
            step = CapturedStep(functools.partial(self._hi_expert if hi else self._lo_expert,
                                                  slot),
                                "engine_hi" if hi else "engine_lo", self._expert_pool)
            self._expert_steps[precision, slot] = step
        return step

    def _hi_expert(self, slot: int, h: torch.Tensor) -> torch.Tensor:
        """One hi expert on its pool slot: two products in the model dtype
        with the activation between them."""
        z = h @ self.pool_hi["wi"][slot]
        return L.activate(z, self.cfg) @ self.pool_hi["wo"][slot]

    def _lo_expert(self, slot: int, h: torch.Tensor) -> torch.Tensor:
        """One lo expert on its pool slot: each product through the dense
        dequant-matmul (the kernel on the card, the reference's
        ``h.astype(f32) @ dequantize(q)`` on the CPU), cast to the model
        dtype as the reference casts it."""
        ecfg, cfg = self.ecfg, self.cfg
        pool = self.pool_lo
        qi = QTensor(pool["wi_data"][slot], pool["wi_scale"][slot], ecfg.lo_bits,
                     ecfg.group_size, cfg.d_model)
        qo = QTensor(pool["wo_data"][slot], pool["wo_scale"][slot], ecfg.lo_bits,
                     ecfg.group_size, cfg.moe.d_ff_expert)
        z = L.activate(kops.dequant_matmul(h, qi).to(h.dtype), cfg)
        return kops.dequant_matmul(z, qo).to(h.dtype)

    def _host_expert(self, mi: int, e: int, d_: int, h: torch.Tensor) -> torch.Tensor:
        """CPU-helper mode (§4): expert e of MoE layer mi on the CPU in
        float32 from host storage (a hi expert's exact upcast; a lo
        expert's codes dequantized), with the reference's activation
        formulas.  Reads the hidden row back; returns it on h's device in
        h's dtype."""
        cfg, ecfg = self.cfg, self.ecfg
        if d_ == PREC_HI:
            src = self.storage_hi[mi]
            wi = src["wi"][e].to(torch.float32)
            wo = src["wo"][e].to(torch.float32)
        else:
            src = self.storage_lo[mi]
            wi = dequantize(QTensor(src["wi_data"][e], src["wi_scale"][e], ecfg.lo_bits,
                                    ecfg.group_size, cfg.d_model))
            wo = dequantize(QTensor(src["wo_data"][e], src["wo_scale"][e], ecfg.lo_bits,
                                    ecfg.group_size, cfg.moe.d_ff_expert))
        z = h.to("cpu", torch.float32) @ wi                        # host sync
        if cfg.ffn_activation == "swiglu":
            g, u = torch.chunk(z, 2, dim=-1)
            z = (g / (1 + torch.exp(-g))) * u
        else:
            z = 0.5 * z * (1 + torch.tanh(math.sqrt(2 / math.pi) * (z + 0.044715 * z ** 3)))
        return (z @ wo).to(h.device, h.dtype)

    # ------------------------------------------------------------------
    # evaluation helpers (the single-sequence API)
    # ------------------------------------------------------------------
    def generate(self, prompt: List[int], new_tokens: int,
                 max_len: Optional[int] = None) -> List[int]:
        """Greedy decode of one sequence, its prompt fed token by token
        through ``decode_token``.  Returns the new tokens."""
        max_len = max_len or (len(prompt) + new_tokens + 1)
        self.start_sequence(max_len)
        lg = None
        for t in prompt:
            lg = self.decode_token(int(t))
        out = []
        for _ in range(new_tokens):
            nxt = int(np.argmax(lg))
            out.append(nxt)
            lg = self.decode_token(nxt)
        return out

    def score_nll(self, tokens: List[int], max_len: Optional[int] = None) -> float:
        """Teacher-forced mean NLL of one sequence through the offload path
        (accuracy evaluations): the first token enters through
        ``decode_token``, as every later one does."""
        max_len = max_len or (len(tokens) + 1)
        self.start_sequence(max_len)
        nll, n = 0.0, 0
        lg = self.decode_token(int(tokens[0]))
        for t in tokens[1:]:
            p = lg - lg.max()
            p = p - np.log(np.exp(p).sum())
            nll -= p[int(t)]
            n += 1
            lg = self.decode_token(int(t))
        return float(nll / max(n, 1))

    # ------------------------------------------------------------------
    def close(self):
        """Release the staging engine's worker threads.  Idempotent; a
        closed engine raises RuntimeError on the serving entry points."""
        if self._closed:
            return
        self._closed = True
        self.scheduler.flush()
        self.scheduler.shutdown()

    def _check_open(self):
        if self._closed:
            raise RuntimeError("OffloadEngine is closed; create a new engine "
                               "(close() released its staging threads)")

    def stats(self) -> Dict:
        """JSON-serializable engine counters (cache, loader, predictor,
        staging, and which kernel implementation each op dispatched)."""
        s = {
            "cache": self.cache.stats.to_dict(),
            "loads_hi": self.loader.n_loads[PREC_HI],
            "loads_lo": self.loader.n_loads[PREC_LO],
            "skips": self.loader.n_skips,
            "loaded_bytes": self.loader.loaded_bytes,
            "pred_accuracy": {int(d): float(a)
                              for d, a in self.predictor.accuracy().items()},
            # host wall from each grouped layer segment's launch (attention,
            # norm, router, the predictor's stacked gating) to its routes and
            # predictor probabilities on the host; the readback also waits
            # for the device work still queued before the segment (the layer
            # before's grouped FFN)
            "gating_s": self._gating_s,
            # real (row, expert) pairs each grouped lo launch pair carried
            # (one launch pair per MoE layer and step, at P = B * top_k; 0
            # when it carries pads only), and the distinct pool slots among
            # them (each read once per launch on the card)
            "lo_pairs_per_launch": _spread(self._lo_pairs),
            # real pairs of each grouped hi launch pair: a launch of pads
            # only (0) still streams one hi expert, as the reference's
            # gather of P experts does
            "hi_pairs_per_launch": _spread(self._hi_pairs),
            "lo_slots_per_launch": _spread(self._lo_slots),
            # distinct hi slots of each grouped hi launch pair (several
            # pairs share a slot at batch > 1)
            "hi_slots_per_launch": _spread(self._hi_slots),
            "expert_dispatches": self._expert_dispatches,
            "union_reloads": self._union_reloads,
            # the adaptive predictor's stacked-gating calls issued from the
            # host (one H2D copy, launch and readback each: the per-expert
            # path's); 0 on the grouped path, whose captured segments gate
            # every row and whose readbacks serve segment_predictions
            # (row-layer predictions)
            "predictor_host_calls": self.predictor.host_calls,
            "segment_predictions": self._segment_predictions,
            # "<op>.<cuda|torch>" -> count: a card run showing .torch counts
            # would be timing the plain versions
            "kernel_dispatch": kops.dispatch_counts(),
            # KV page-pool pressure (zeros under the dense KV layout)
            "kv_pages_used": 0, "kv_pages_total": 0, "kv_page_fraction": 0.0,
        }
        if self.ecfg.paged_kv and self.kv_pool is not None:
            s.update(self.kv_pool.stats())
        s.update(self.scheduler.stats())
        return s
