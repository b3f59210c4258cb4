"""Trace-driven latency simulator for expert-offloading systems.

The decode timeline is modelled analytically, as in the paper's Fig. 9
analysis, and driven with *real routing traces* recorded by the engine
(``OffloadEngine.trace``).  The timeline semantics are the JAX reference's,
unchanged: on the same ``HardwareModel`` and trace, ``simulate_systems``,
``OffloadSimulator`` and ``ServingTimeline`` give the reference's results.

The cost model has three knobs:
    link_gbps      host->device expert-fetch bandwidth
    compute_s      per-MoE-layer compute time
    expert_bytes   per-precision expert size (from quant.expert_nbytes)

Presets (``HARDWARE``): the paper's two edge devices with its published
figures (``rtx4090``: PCIe 4.0 at 32 GB/s, ~3 ms/layer for Mixtral;
``jetson_orin``), and ``h100_host``, the card this port runs on, measured
there by ``core.host_model`` (chip_smoke.py's "simulator" phase):
``link_gbps`` is the pinned host -> device rate of one bf16 Mixtral expert
copy, ``compute_s_per_layer`` the engine's own per-MoE-layer wall at batch
1 with every expert resident (decode_token steps, logits read back), its
slope over depth.  What stays analytic: transfers serialise per stream at
the link rate, compute per layer is a constant whatever the precision mix
(``lo_compute_discount`` is not read by the timeline), a step's fixed work
has no term, and the host's own work between layers is the resident
step's: what the serve path adds (prefetch, staging, upgrades) is not in
the constant, so ``h100_host`` bounds the engine's tok/s from above.

Systems modeled (the paper's baselines):
    dense_layerwise   llama.cpp-style: stream every expert of every layer
    on_demand         MoE-Offloading-style: LRU cache, fetch fp16 on miss
    prefetch_lru      MoE-Infinity-style: LRU cache + next-layer prefetch
                      (fp16, non-interruptible mispredictions — Fig. 9c)
    hobbit            mixed-precision loading + adaptive prefetch +
                      multidimensional cache
Ablations are expressed by toggling HobbitSimConfig fields (Fig. 16/17/18).

A trace is a list of tokens; each token is a list over MoE layers of
  TraceLayer(experts, gate_vals, pred_experts, pred_gate_vals)
where pred_* come from the *previous* layer's adaptive predictor output.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cache import MultidimensionalCache
from repro_torch.core.policies import LRU, MULTIDIM, PolicyWeights
from repro_torch.core.scoring import (PREC_HI, PREC_LO, PREC_SKIP, Thresholds,
                                precision_decisions)


@dataclasses.dataclass
class TraceLayer:
    experts: List[int]                       # actual top-k (descending gate)
    gate_vals: np.ndarray                    # their gate magnitudes
    pred_experts: Optional[List[int]] = None # predictor output for THIS layer
    pred_gate_vals: Optional[np.ndarray] = None


Trace = List[List[TraceLayer]]  # [token][moe_layer]


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    name: str
    link_gbps: float = 32.0                   # PCIe 4.0 (RTX 4090 group)
    compute_s_per_layer: float = 3e-3         # paper §2.1: ~3ms/layer on 4090
    lo_compute_discount: float = 1.0          # fused dequant GEMM ~= same time

    def load_s(self, nbytes: int) -> float:
        return nbytes / (self.link_gbps * 1e9)


RTX4090 = HardwareModel("rtx4090", link_gbps=32.0, compute_s_per_layer=3e-3)
JETSON_ORIN = HardwareModel("jetson_orin", link_gbps=7.0,
                            compute_s_per_layer=9e-3)
# measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit by
# chip_smoke.py's phase 7f (core/host_model.py), the median of three runs
# in one call: the pinned copy of one 352.3 MB bf16 Mixtral-8x7B expert
# (45.28-48.98 GB/s), and the slope over depth of the median resident
# decode_token wall at batch 1 of Mixtral-8x7B cut to 2 and 4 layers
# (0.972-1.342 ms per MoE layer; the step's fixed work, -0.071-1.270 ms,
# has no term in the timeline).  A resident step's: the serve path's host
# work per layer is not in it, so tok/s simulated under it is a bound.
H100_HOST = HardwareModel("h100_host", link_gbps=48.88,
                          compute_s_per_layer=1.223e-3)

HARDWARE = {h.name: h for h in (RTX4090, JETSON_ORIN, H100_HOST)}


@dataclasses.dataclass(frozen=True)
class HobbitSimConfig:
    thresholds: Thresholds = Thresholds(0.6, 0.9)
    dynamic_loading: bool = True              # False -> always fp16 (ablation)
    prefetch: bool = True
    # beyond-paper: only issue a prefetch when the predictor's top-1
    # probability clears this bar (0 = paper-faithful, always prefetch).
    # Mispredicted transfers are non-interruptible (Fig. 9), so gating by
    # confidence removes most of the wrong-expert link occupancy.
    prefetch_conf: float = 0.0
    policy: PolicyWeights = MULTIDIM
    hi_slots: int = 64
    lo_slots: int = 32
    hi_bytes: int = 0                         # filled by caller
    lo_bytes: int = 0
    # multi-stream staging (mirrors core/loader.py StagingEngine so the
    # simulated overlap_fraction stays comparable to the wall-clock one):
    # streams=1 keeps the single-DMA-engine timeline of the paper's Fig. 9;
    # streams>=2 gives hi- and lo-precision transfers their own copy engine.
    streams: int = 1
    # ordered=True issues prefetch transfers in prediction order (paper
    # baseline); False issues biggest-gate-first and preempts a queued hi
    # transfer with a lo replacement when the link cannot move the hi bytes
    # before the target layer's compute starts (issue-time downgrade).
    ordered: bool = True
    # idle-link upgrade pass (mirrors StagingEngine._pump_upgrades so the
    # simulated upgrade behavior stays comparable to wall clock): with
    # ordered=False, a downgraded expert keeps serving its lo stand-in
    # (counted in served_lo_expert_steps) and hi re-copies are issued for
    # the hottest lo-substituted experts into hi-stream idle time that ends
    # before the layer's compute does — never delaying a deadline transfer.
    # False restores the per-token downgrade semantics (next hi use blocking-
    # loads hi on demand).
    upgrade: bool = True


class OffloadSimulator:
    """Simulates one system's decode timeline over a trace."""

    def __init__(self, system: str, num_layers: int, hw: HardwareModel,
                 cfg: HobbitSimConfig):
        self.system = system
        self.hw = hw
        self.cfg = cfg
        self.num_layers = num_layers
        weights = cfg.policy if system == "hobbit" else LRU
        self.cache = MultidimensionalCache(num_layers, cfg.hi_slots,
                                           cfg.lo_slots if system == "hobbit" else 0,
                                           weights)
        self.pending_prefetch_done_at = 0.0
        self._nstreams = max(1, int(cfg.streams))
        self._stall_s = 0.0
        self._transfer_s = 0.0
        self._per_stream_bytes = [0] * self._nstreams
        self._downgrades = 0
        self._reorders = 0
        # idle-link upgrade pass state (budgeted path only)
        self._upgrade = bool(cfg.upgrade) and not cfg.ordered
        self._lo_sub: set = set()       # downgraded keys served from lo
        self._upgrades = 0
        self._upgrade_bytes = 0
        self._served_lo = 0

    def _bytes(self, prec: int) -> int:
        return self.cfg.hi_bytes if prec == PREC_HI else self.cfg.lo_bytes

    def _stream_of(self, prec: int) -> int:
        """hi transfers ride stream 0, lo transfers the second stream (the
        StagingEngine's one-hi/one-lo split); streams=1 shares one engine."""
        return 0 if (prec == PREC_HI or self._nstreams == 1) else 1

    # ------------------------------------------------------------------
    def run(self, trace: Trace, *, reset_per_sequence: bool = True) -> Dict:
        t = 0.0
        per_token = []
        self.cache.new_sequence()
        self._stall_s = 0.0         # transfer time on the critical path
        self._transfer_s = 0.0      # total link-busy time issued
        self._per_stream_bytes = [0] * self._nstreams
        self._downgrades = 0
        self._reorders = 0
        self._lo_sub = set()
        self._upgrades = 0
        self._upgrade_bytes = 0
        self._served_lo = 0
        for token in trace:
            t0 = t
            self.cache.advance_token()
            t = self._run_token(token, t)
            per_token.append(t - t0)
        # same accounting the engine reports for the real wall clock:
        # overlap_fraction = share of transfer time hidden behind compute;
        # link_utilization = share of the timeline the modeled link was busy
        overlap = (max(0.0, 1.0 - self._stall_s / self._transfer_s)
                   if self._transfer_s > 0 else 0.0)
        return {
            "total_s": t,
            "tok_per_s": len(trace) / t if t > 0 else float("inf"),
            "per_token_s": per_token,
            "stats": self.cache.stats,
            "cache": self.cache.stats.to_dict(),
            "load_stall_s": self._stall_s,
            "overlap_fraction": overlap,
            "per_stream_bytes": list(self._per_stream_bytes),
            "issue_reorders": self._reorders,
            "precision_downgrades": self._downgrades,
            "upgrades": self._upgrades,
            "upgrade_bytes": self._upgrade_bytes,
            "served_lo_expert_steps": self._served_lo,
            "link_utilization": (min(1.0, self._transfer_s / t)
                                 if t > 0 else 0.0),
        }

    def _issue(self, link_free: List[float], t: float, prec: int) -> float:
        """Occupy `prec`'s stream for one transfer issued at `t`; returns the
        time the transfer lands."""
        s = self._stream_of(prec)
        dur = self.hw.load_s(self._bytes(prec))
        link_free[s] = max(link_free[s], t) + dur
        self._transfer_s += dur
        self._per_stream_bytes[s] += self._bytes(prec)
        return link_free[s]

    # ------------------------------------------------------------------
    def _run_token(self, token: List[TraceLayer], t: float) -> float:
        """Timeline semantics (Fig. 9, extended to N streams): each stream is
        one DMA engine serializing its own transfers (`link_free[s]`; hi
        transfers on stream 0, lo on stream 1 when streams >= 2); on-demand
        loads block the layer start; prefetch for layer l+1 is issued when
        layer l's compute *starts* and overlaps with it; in-flight (possibly
        wrong) prefetches are non-interruptible — layer l+1's on-demand loads
        queue behind them on their stream.  With ``ordered=False`` prefetch
        transfers issue biggest-gate-first and a queued hi transfer that
        cannot land before the target layer's compute begins is downgraded to
        its lo replacement (the StagingEngine's issue-time precision
        decision)."""
        link_free = [t] * self._nstreams
        for li, tl in enumerate(token):
            # -------- on-demand fetches (block the layer) --------
            if self.system == "dense_layerwise":
                need = self.hw.load_s(self.cfg.hi_bytes) * self._experts_per_layer(token)
                end = max(link_free[0], t) + need
                link_free[0] = end
                self._transfer_s += need
                self._per_stream_bytes[0] += (self.cfg.hi_bytes
                                              * self._experts_per_layer(token))
                self._stall_s += end - t
                t = end
            else:
                if self.system == "hobbit" and self.cfg.dynamic_loading:
                    dec = precision_decisions(tl.gate_vals, self.cfg.thresholds)
                else:
                    dec = np.full(len(tl.experts), PREC_HI)
                for e, d in zip(tl.experts, dec):
                    if d == PREC_SKIP:
                        continue
                    is_hi = d == PREC_HI
                    self.cache.pin((li, e), is_hi)
                    slot = self.cache.probe((li, e), is_hi)
                    if (slot is None and is_hi and self._upgrade
                            and (li, e) in self._lo_sub):
                        if self.cache.lookup((li, e), False) is not None:
                            # persistent downgrade substitution: serve the
                            # lo stand-in until an upgrade lands hi
                            self.cache.pin((li, e), False)
                            self.cache.records.on_use((li, e), False)
                            self._served_lo += 1
                            continue
                        self._lo_sub.discard((li, e))   # lo evicted: reload
                    if slot is None:
                        end = self._issue(link_free, t, int(d))
                        self._stall_s += end - t
                        t = end                    # on-demand load blocks
                        self.cache.admit((li, e), is_hi, li)

            # -------- compute; prefetch for the NEXT layer overlaps --------
            compute_end = t + self.hw.compute_s_per_layer
            prefetch_on = (self.system == "prefetch_lru"
                           or (self.system == "hobbit" and self.cfg.prefetch))
            nxt = token[li + 1] if li + 1 < len(token) else None
            if (prefetch_on and nxt is not None
                    and nxt.pred_experts is not None
                    and (self.cfg.prefetch_conf <= 0.0
                         or (nxt.pred_gate_vals is not None
                             and float(np.max(nxt.pred_gate_vals))
                             >= self.cfg.prefetch_conf))):
                if self.system == "hobbit" and self.cfg.dynamic_loading:
                    pdec = precision_decisions(nxt.pred_gate_vals,
                                               self.cfg.thresholds)
                else:
                    pdec = np.full(len(nxt.pred_experts), PREC_HI)
                gates = (np.asarray(nxt.pred_gate_vals, float)
                         if nxt.pred_gate_vals is not None
                         else np.zeros(len(nxt.pred_experts)))
                # only pairs that will actually issue a transfer take part
                # in the gate sort: counting inversions over skipped or
                # already-resident predictions would report phantom
                # issue_reorders the engine's metric never counts
                pairs = [(e, d, g, i) for i, (e, d, g) in
                         enumerate(zip(nxt.pred_experts, pdec, gates))
                         if d != PREC_SKIP
                         and self.cache.lookup((li + 1, e),
                                               d == PREC_HI) is None]
                if not self.cfg.ordered:
                    issue_order = sorted(pairs, key=lambda p: (-p[2], p[3]))
                    # inversions the gate sort introduced vs prediction order
                    self._reorders += sum(
                        1 for i, p in enumerate(issue_order)
                        if any(q[3] < p[3] for q in issue_order[i + 1:]))
                    pairs = issue_order
                for e, d, _g, _i in pairs:
                    if d == PREC_SKIP:
                        continue
                    is_hi = d == PREC_HI
                    if (not self.cfg.ordered and is_hi
                            and self.cache.lookup((li + 1, e), True) is None):
                        # issue-time budget check: can the hi bytes land
                        # before layer li+1's compute starts, given what is
                        # already queued on the hi stream?
                        s = self._stream_of(PREC_HI)
                        queue_s = max(0.0, link_free[s] - t)
                        if (queue_s + self.hw.load_s(self.cfg.hi_bytes)
                                > compute_end - t):
                            self._downgrades += 1
                            d, is_hi = PREC_LO, False
                            if self._upgrade:
                                self._lo_sub.add((li + 1, e))
                    if self.cache.lookup((li + 1, e), is_hi) is None:
                        # issued at compute start, overlapped; occupies its
                        # stream (no immediate stall — if it is still in
                        # flight when the next layer's on-demand loads queue
                        # behind it, the wait surfaces there as stall)
                        self._issue(link_free, t, int(d))
                        self.cache.admit((li + 1, e), is_hi, li)
                        self.cache.pin((li + 1, e), is_hi)
            if self._upgrade and self.system == "hobbit":
                self._issue_upgrades(link_free, t, compute_end, li)
            t = compute_end
        return t

    def _issue_upgrades(self, link_free: List[float], t: float,
                        compute_end: float, li: int):
        """Idle-link upgrade pass on the simulated timeline (the
        StagingEngine rule): ONE hi re-copy per idle window — the analogue
        of the engine's one-in-flight-per-stream cap — for the hottest
        lo-substituted expert, issued only into hi-stream idle time that
        ends before this layer's compute does, so a deadline transfer is
        never delayed."""
        s = self._stream_of(PREC_HI)
        dur = self.hw.load_s(self.cfg.hi_bytes)
        cands = []
        for key in list(self._lo_sub):
            if self.cache.lookup(key, False) is None:
                self._lo_sub.discard(key)       # lo stand-in evicted
                continue
            if self.cache.lookup(key, True) is not None:
                self._lo_sub.discard(key)       # hi already resident
                continue
            cands.append(key)
        # fleet-blended cache priority (cache.priority — identical to the
        # per-sequence Eq. 3 score when no fleet heat map is attached)
        prio = lambda k: self.cache.priority(k, li)  # noqa: E731
        cands.sort(key=lambda k: -prio(k))
        for key in cands:
            if max(link_free[s], t) + dur > compute_end:
                break                           # no idle budget left
            # never evict a hi resident at least as hot as the promoted
            # expert (same churn guard as StagingEngine._pump_upgrades,
            # compared against the real eviction policy)
            victim_p = self.cache.peek_victim_priority(True, li)
            if victim_p is not None and victim_p >= prio(key):
                break                           # candidates priority-sorted
            self._issue(link_free, t, PREC_HI)
            self.cache.admit(key, True, li)
            self.cache.pin(key, True)
            self._lo_sub.discard(key)
            self._upgrades += 1
            self._upgrade_bytes += self.cfg.hi_bytes
            break                               # one re-copy per idle window

    def _experts_per_layer(self, token) -> int:
        # dense_layerwise streams every expert; infer expert count from trace
        mx = 0
        for tl in token:
            mx = max(mx, max(tl.experts) + 1)
        return mx


def simulate_systems(trace: Trace, num_layers: int, hw: HardwareModel,
                     cfg: HobbitSimConfig,
                     systems: Sequence[str] = ("dense_layerwise", "on_demand",
                                               "prefetch_lru", "hobbit")) -> Dict[str, Dict]:
    out = {}
    for s in systems:
        out[s] = OffloadSimulator(s, num_layers, hw, cfg).run(trace)
    return out


# ----------------------------------------------------------------------
# serving timeline: SLO scheduling on a deterministic virtual clock
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TimelineConfig:
    """Virtual-clock serving model for `ServingTimeline` (the scheduling
    analogue of `HardwareModel`): slot and KV capacity plus throughput
    knobs, all deterministic, so scheduling policies are compared on an
    exactly reproducible timeline."""
    slots: int = 4                     # concurrent serving slots
    kv_tokens: int = 4096              # total KV token budget (page pool)
    prefill_tok_s: float = 4096.0      # prefill throughput, tokens/s
    decode_step_s: float = 0.05        # one decode step (= 1 token/request)
    policy: str = "slo"                # "fifo" | "slo"
    aging_s: float = 10.0              # starvation-bounding aging period
    preempt_margin: float = 1.0        # effective-priority gap to preempt


class ServingTimeline:
    """Deterministic virtual-clock replay of a `serving.workload` trace
    under one scheduling policy — the simulator half of the live
    `BatchingServer` (same admission ordering and preemption rule via the
    shared `serving.workload` policy helpers, same stats keys), used to
    search scheduling policies and to CI-gate SLO attainment.

    FIFO admits strictly in arrival order with head-of-line blocking (the
    original FIFO scheduler).  SLO admits in `slo_urgency` order and may
    preempt: when the most urgent queued request does not fit, the
    lowest-effective-priority decoding victim whose eviction makes it fit
    — and whose effective priority trails by more than `preempt_margin` —
    is paused and requeued (its prefill/decode progress is kept, like the
    live pause/resume snapshot path).  Aging (one priority level per
    `aging_s` waited) bounds starvation: a request of priority p waiting
    `(p_max - p + margin) * aging_s` outranks every fresh arrival, so
    `starved` counts requests whose admission wait exceeded that bound
    plus one aging period of slack."""

    def __init__(self, cfg: TimelineConfig):
        self.cfg = cfg

    def run(self, trace) -> Dict:
        from repro_torch.serving.workload import effective_priority, slo_urgency
        cfg = self.cfg
        reqs = [{
            "rid": w.rid, "arrival": float(w.arrival_s),
            "plen": int(len(w.prompt)), "new": int(w.max_new_tokens),
            "prio": int(w.priority), "ttft": w.ttft_slo_s,
            "tpot": w.tpot_slo_s,
            "kv": int(len(w.prompt)) + int(w.max_new_tokens) + 1,
            "state": "queued", "prefilled": 0, "decoded": 0,
            "admitted": None, "first": None, "done": None,
        } for w in trace]
        order = sorted(range(len(reqs)), key=lambda i: reqs[i]["arrival"])
        queue: List[int] = []
        running: List[int] = []
        kv_used = 0
        preemptions = 0
        t, ai, done_n = 0.0, 0, 0
        tick = cfg.decode_step_s

        def fits(r) -> bool:
            return (len(running) < cfg.slots
                    and kv_used + r["kv"] <= cfg.kv_tokens)

        def admit(i: int, now: float):
            nonlocal kv_used
            r = reqs[i]
            if r["admitted"] is None:
                r["admitted"] = now
            r["state"] = "decode" if r["prefilled"] >= r["plen"] else "prefill"
            kv_used += r["kv"]
            running.append(i)

        for _ in range(1_000_000):
            if done_n >= len(reqs):
                break
            while ai < len(order) and reqs[order[ai]]["arrival"] <= t:
                queue.append(order[ai])
                ai += 1
            if not running and not queue and ai < len(order):
                t = reqs[order[ai]]["arrival"]      # fast-forward idle time
                continue
            # ---- admission ----
            if cfg.policy == "fifo":
                queue.sort(key=lambda i: (reqs[i]["arrival"], i))
                while queue and fits(reqs[queue[0]]):
                    admit(queue.pop(0), t)          # head-of-line blocking
            else:
                queue.sort(key=lambda i: slo_urgency(
                    reqs[i]["prio"], reqs[i]["arrival"], reqs[i]["ttft"], t,
                    cfg.aging_s))
                rest = []
                for i in queue:
                    if fits(reqs[i]):
                        admit(i, t)
                    else:
                        rest.append(i)
                queue = rest
                if queue:
                    # preempt-and-requeue for the most urgent non-fitting
                    # request: lowest-effective-priority decoding victim
                    # whose slot+pages make it fit, margin-guarded
                    top = queue[0]
                    eff = lambda i: effective_priority(  # noqa: E731
                        reqs[i]["prio"], reqs[i]["arrival"], t, cfg.aging_s)
                    cands = [i for i in running if reqs[i]["state"] == "decode"]
                    if cands:
                        victim = min(cands, key=eff)
                        v = reqs[victim]
                        if (eff(victim) + cfg.preempt_margin < eff(top)
                                and kv_used - v["kv"] + reqs[top]["kv"]
                                <= cfg.kv_tokens):
                            running.remove(victim)
                            kv_used -= v["kv"]
                            v["state"] = "queued"   # progress kept (snapshot)
                            queue.append(victim)
                            preemptions += 1
                            admit(queue.pop(0), t)
            # ---- one tick of service ----
            t_end = t + tick
            budget = cfg.prefill_tok_s * tick       # prefill tokens this tick
            for i in list(running):
                r = reqs[i]
                if r["state"] == "prefill":
                    r["prefilled"] = min(r["plen"],
                                         r["prefilled"] + int(budget))
                    if r["prefilled"] >= r["plen"]:
                        # prefill's last-token logits ARE the first token
                        r["state"] = "decode"
                        r["first"] = t_end
                        r["decoded"] = 1
                elif r["state"] == "decode":
                    if r["first"] is None:
                        r["first"] = t_end
                    r["decoded"] += 1
                if r["decoded"] >= r["new"]:
                    r["state"] = "done"
                    r["done"] = t_end
                    running.remove(i)
                    kv_used -= r["kv"]
                    done_n += 1
            t = t_end

        # ---- metrics (same keys the live BatchingServer.stats() reports) --
        p_max = max((r["prio"] for r in reqs), default=0)
        ttfts, met, declared, starved = [], 0, 0, 0
        for r in reqs:
            ttft = (r["first"] - r["arrival"]) if r["first"] is not None \
                else float("inf")
            ttfts.append(ttft)
            wait = (r["admitted"] - r["arrival"]) if r["admitted"] is not None \
                else float("inf")
            bound = (p_max - r["prio"] + cfg.preempt_margin + 1) * cfg.aging_s
            if wait > bound:
                starved += 1
            if r["ttft"] is None and r["tpot"] is None:
                continue
            declared += 1
            ok = r["done"] is not None
            if ok and r["ttft"] is not None:
                ok = ttft <= r["ttft"]
            if ok and r["tpot"] is not None and r["decoded"] > 1:
                ok = ((r["done"] - r["first"]) / (r["decoded"] - 1)
                      <= r["tpot"])
            met += int(ok)
        return {
            "policy": cfg.policy,
            "completed": done_n,
            "slo_attainment": (met / declared) if declared else 1.0,
            "p99_ttft_s": float(np.percentile(ttfts, 99)) if ttfts else 0.0,
            "mean_ttft_s": (float(np.mean([x for x in ttfts
                                           if np.isfinite(x)]))
                            if any(np.isfinite(x) for x in ttfts) else 0.0),
            "preemptions": preemptions,
            "starved": starved,
            "requests": [{k: r[k] for k in
                          ("rid", "arrival", "admitted", "first", "done",
                           "prio", "decoded")} for r in reqs],
        }


def cache_policy_penalty(trace: Trace, num_layers: int, weights: PolicyWeights,
                         hi_slots: int, lo_slots: int, th: Thresholds,
                         lo_cost_ratio: float = 0.25,
                         sequence_level: bool = True,
                         sequence_breaks: Optional[List[int]] = None) -> float:
    """Replay a trace through the mixed-precision cache under a policy and
    return the paper's miss *penalty* metric (Fig. 18)."""
    cache = MultidimensionalCache(num_layers, hi_slots, lo_slots, weights)
    cache.new_sequence()
    breaks = set(sequence_breaks or [])
    for ti, token in enumerate(trace):
        if sequence_level and ti in breaks:
            cache.new_sequence()
        cache.advance_token()
        for li, tl in enumerate(token):
            dec = precision_decisions(tl.gate_vals, th)
            for e, d in zip(tl.experts, dec):
                if d == PREC_SKIP:
                    continue
                is_hi = d == PREC_HI
                if cache.probe((li, e), is_hi) is None:
                    cache.admit((li, e), is_hi, li)
    return cache.stats.miss_penalty(lo_cost_ratio)
