"""The simulator's host model measured on a CUDA card, and the simulator
set up as the engine it models.

``core.simulator.HardwareModel`` has two constants that the timeline reads:
``link_gbps`` (every transfer takes bytes / link) and
``compute_s_per_layer`` (every MoE layer's compute).  ``measure_hardware``
measures both on the card an engine runs on:

* ``link_gbps``: the pinned host -> device rate of one hi (bf16) expert
  copy, ``loader.measure_link_bps`` at the expert's bytes;
* ``compute_s_per_layer``: the engine's own wall per MoE layer at batch 1
  with no load on the path, every expert resident at full precision and no
  prefetch (``resident_config``).  ``resident_step`` decodes a sequence
  once to load its experts, then again token by token, each step's logits
  read back, and takes the median step that neither loaded nor captured;
  the constant is that median's slope over the MoE layers of one model cut
  to two depths, so the work a step does once (embedding, logits, the
  host's loop) is not multiplied by depth.  The simulator predicts the
  engine, so the preset takes the engine's wall (the per-layer host work
  included), not the device time alone.  It is the resident step's: what
  the serve path adds per layer (prefetch, staging, upgrades) is not in
  it, so a simulated tok/s under it is a bound, not a prediction.

A host clock on the CPU measures no card, so ``resident_step`` and
``measure_hardware`` refuse a CPU engine or device.

``sim_config`` carries an ``EngineConfig`` into the ``HobbitSimConfig`` of
the same thresholds, slots, streams, issue order, upgrade and prefetch.
The engine's cache keeps its residents across ``start_sequence`` (only the
per-sequence records and pins are reset), and so does one
``OffloadSimulator`` across its ``run`` calls; ``simulate_sequences``
replays the engine's sequences through one simulator so that both start
each sequence from the same residency.  ``sequence_counters`` gives the
engine's counters of one sequence under the names ``simulate_sequences``
reports.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core.engine import EngineConfig, OffloadEngine
from repro_torch.core.loader import measure_link_bps
from repro_torch.core.scoring import PREC_HI, PREC_LO, Thresholds
from repro_torch.core.simulator import (HardwareModel, HobbitSimConfig,
                                        OffloadSimulator, Trace)
from repro_torch.kernels import ops as kops


def resident_config(cfg) -> EngineConfig:
    """Every expert of `cfg` resident at full precision (thresholds (1, 1):
    no lo, no skip), no prefetch: the engine's step with no load on its
    path once each expert it routes to has been loaded."""
    n = sum(cfg.layer_is_moe()) * cfg.moe.num_experts
    return EngineConfig(hi_slots=n, lo_slots=1, thresholds=Thresholds(1.0, 1.0),
                        prefetch=False)


def sim_config(ecfg: EngineConfig, expert_bytes: Dict[int, int]) -> HobbitSimConfig:
    """The HobbitSimConfig of engine configuration `ecfg`, with the
    engine's per-precision expert bytes (``OffloadEngine.expert_bytes``)."""
    return HobbitSimConfig(
        thresholds=ecfg.thresholds, dynamic_loading=ecfg.dynamic_loading,
        prefetch=ecfg.prefetch, policy=ecfg.policy, hi_slots=ecfg.hi_slots,
        lo_slots=ecfg.lo_slots, hi_bytes=expert_bytes[PREC_HI],
        lo_bytes=expert_bytes[PREC_LO], streams=ecfg.streams, ordered=ecfg.ordered,
        upgrade=ecfg.upgrade)


def _captures() -> int:
    """Graphs captured so far (every ``"<step>.capture"`` count)."""
    return sum(n for k, n in kops.dispatch_counts().items() if k.endswith(".capture"))


def timed_generate(eng: OffloadEngine, prompt: Sequence[int],
                   new_tokens: int) -> Tuple[List[int], List[Dict]]:
    """``eng.generate(prompt, new_tokens)`` with each ``decode_token`` step
    timed on the host clock (the step returns its logits on the host, so
    the wall ends with the device's work).  Returns the new tokens and, per
    step, its seconds ``"s"``, the experts it loaded (``"loads"``), the
    graphs it captured (``"captures"``: ``start_sequence`` drops the
    engine's graphs, so its first step captures them again) and its load
    stall (``"stall_s"``)."""
    decode = eng.decode_token
    steps: List[Dict] = []

    def step(token: int):
        n, c, stall = sum(eng.loader.n_loads.values()), _captures(), eng.scheduler.stall_s
        t0 = time.perf_counter()
        lg = decode(token)
        steps.append({"s": time.perf_counter() - t0,
                      "loads": sum(eng.loader.n_loads.values()) - n,
                      "captures": _captures() - c, "stall_s": eng.scheduler.stall_s - stall})
        return lg

    eng.decode_token = step
    try:
        out = eng.generate([int(t) for t in prompt], new_tokens)
    finally:
        del eng.decode_token
    return out, steps


def resident_step(eng: OffloadEngine, prompt: Sequence[int], new_tokens: int) -> Dict:
    """The median ``decode_token`` wall of `eng` (built with
    ``resident_config``) over the steps that neither load nor capture: the
    sequence (`prompt`, then `new_tokens` greedy tokens) is decoded once to
    load its experts, then again, timed."""
    if eng.device.type != "cuda":
        raise ValueError(f"resident_step times a CUDA card; the engine is on {eng.device}")
    eng.generate([int(t) for t in prompt], new_tokens)
    _, steps = timed_generate(eng, prompt, new_tokens)
    quiet = [st["s"] for st in steps if not (st["loads"] or st["captures"])]
    if not quiet:
        raise RuntimeError("every timed step loaded an expert or captured a graph: "
                           "the engine is not resident (build it with resident_config)")
    return {"moe_layers": eng.num_moe_layers, "median_step_s": statistics.median(quiet),
            "step_s": [st["s"] for st in steps],
            "load_steps": sum(st["loads"] > 0 for st in steps),
            "capture_steps": sum(st["captures"] > 0 for st in steps)}


def measure_hardware(steps: Sequence[Dict], hi_bytes: int, device,
                     name: str = "measured") -> Tuple[HardwareModel, Dict]:
    """Both constants of the host model on `device`, a CUDA card.
    `steps`: ``resident_step`` of one model cut to two depths or more.
    ``compute_s_per_layer`` is the slope of the median step over the MoE
    layers (least squares), so work done once a step (embedding, logits
    and their read back, the host's loop) is not charged per layer: it is
    the intercept, ``"step_fixed_s"``, which the simulator's timeline has no
    term for.  ``link_gbps`` is the pinned copy rate of `hi_bytes`.
    Returns the model and the measurement behind it."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"measure_hardware times a CUDA card, not {device}")
    depths = [s["moe_layers"] for s in steps]
    if len(set(depths)) < 2:
        raise ValueError(f"the per-layer slope needs two depths or more, got {depths}")
    slope, fixed = statistics.linear_regression(depths, [s["median_step_s"] for s in steps])
    link_gbps = measure_link_bps(nbytes=hi_bytes, device=device) / 1e9
    hw = HardwareModel(name, link_gbps=link_gbps, compute_s_per_layer=slope)
    return hw, {"moe_layers": depths, "median_step_s": [s["median_step_s"] for s in steps],
                "step_fixed_s": fixed, "hi_bytes": hi_bytes}


def _counters(stats: Dict) -> Dict[str, float]:
    """The additive counters of an ``OffloadEngine.stats()``."""
    c = stats["cache"]
    return {"load_stall_s": stats["load_stall_s"], "copy_s": stats["copy_s"],
            "overlap_s": stats["overlap_s"], "hits": c["hits"], "misses": c["misses"],
            "loads_hi": stats["loads_hi"], "loads_lo": stats["loads_lo"],
            "skips": stats["skips"],
            "precision_downgrades": stats["precision_downgrades"],
            "upgrades": stats["upgrades"]}


def _ratio(a: float, b: float) -> float:
    return a / b if b > 0 else 0.0


def sequence_counters(before: Dict, after: Dict, walls: Sequence[float]) -> Dict:
    """One sequence's counters, from the engine's ``stats()`` taken before
    and after it, and its decode rate over the step walls `walls`."""
    b, a = _counters(before), _counters(after)
    d = {k: a[k] - b[k] for k in b}
    return {"tokens": len(walls), "tok_s": _ratio(len(walls), sum(walls)),
            "load_stall_s": d["load_stall_s"],
            "overlap_fraction": _ratio(d["overlap_s"], d["copy_s"]),
            "hit_ratio": _ratio(d["hits"], d["hits"] + d["misses"]),
            "hits": d["hits"], "misses": d["misses"], "loads_hi": d["loads_hi"],
            "loads_lo": d["loads_lo"], "skips": d["skips"],
            "precision_downgrades": d["precision_downgrades"], "upgrades": d["upgrades"]}


def simulate_sequences(traces: Sequence[Trace], num_layers: int, hw: HardwareModel,
                       cfg: HobbitSimConfig) -> List[Dict]:
    """`traces` (one per sequence, in the order the engine served them)
    through one hobbit simulator, its cache kept across sequences as the
    engine's is.  Each sequence's counters under ``sequence_counters``'
    names (loads from the bytes each stream moved: hi on stream 0, lo on
    stream 1, so ``cfg.streams`` must be at least 2), plus the simulator's
    result of that sequence under ``"result"`` (less ``"stats"``, the cache's
    live counters, which later sequences go on adding to; ``"cache"`` is
    their snapshot at the sequence's end)."""
    if cfg.streams < 2:
        raise ValueError("simulate_sequences tells hi from lo loads by stream: "
                         f"streams={cfg.streams}, want >= 2")
    sim = OffloadSimulator("hobbit", num_layers, hw, cfg)
    out, hits, misses = [], 0, 0
    for trace in traces:
        res = sim.run(trace)
        c = res["cache"]
        dh, dm = c["hits"] - hits, c["misses"] - misses
        hits, misses = c["hits"], c["misses"]
        out.append({
            "tokens": len(res["per_token_s"]), "tok_s": res["tok_per_s"],
            "load_stall_s": res["load_stall_s"],
            "overlap_fraction": res["overlap_fraction"],
            "hit_ratio": _ratio(dh, dh + dm), "hits": dh, "misses": dm,
            "loads_hi": res["per_stream_bytes"][0] // cfg.hi_bytes,
            "loads_lo": res["per_stream_bytes"][1] // cfg.lo_bytes,
            "precision_downgrades": res["precision_downgrades"],
            "upgrades": res["upgrades"],
            "result": {k: x for k, x in res.items() if k != "stats"}})
    return out
