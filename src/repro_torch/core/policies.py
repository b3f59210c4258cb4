"""Sequence-level multidimensional expert caching policy (HOBBIT §3.4).

Priority of expert t (higher = keep):

    p_t = w_lru * R_t/T + w_lfu * F_t/T + w_lhu * H_t/T + w_fld * fld_t   (Eq. 3)
    fld_t = 1 - ((l_t - l_i + L) % L) / L

R_t last-used token index, F_t sequence-level use count, H_t sequence-level
*high-precision* use count, T current token counter, l_i the layer currently
executing, L total layers.  LRU/LFU/LHU/FLD are the corner cases of the
weight vector; records reset at sequence boundaries (sequence-level policy).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

ExpertKey = Tuple[int, int]  # (layer, expert)


@dataclasses.dataclass(frozen=True)
class PolicyWeights:
    lru: float = 0.25
    lfu: float = 0.25
    lhu: float = 0.25
    fld: float = 0.25

    def __post_init__(self):
        tot = self.lru + self.lfu + self.lhu + self.fld
        assert abs(tot - 1.0) < 1e-6, f"weights must sum to 1, got {tot}"


LRU = PolicyWeights(1.0, 0.0, 0.0, 0.0)
LFU = PolicyWeights(0.0, 1.0, 0.0, 0.0)
LHU = PolicyWeights(0.0, 0.0, 1.0, 0.0)
FLD = PolicyWeights(0.0, 0.0, 0.0, 1.0)
# default blend; benchmarks/cache_policies.py tunes this on a calibration set
MULTIDIM = PolicyWeights(0.35, 0.25, 0.25, 0.15)

NAMED_POLICIES = {"lru": LRU, "lfu": LFU, "lhu": LHU, "fld": FLD,
                  "multidim": MULTIDIM}


class PolicyRecords:
    """Per-expert usage records for Eq. 3 (host-side, O(1) per event)."""

    def __init__(self, num_layers: int):
        self.num_layers = num_layers
        self.reset()

    def reset(self):
        """Called at each new sequence (sequence-level records)."""
        self.t = 1
        self.last_used: Dict[ExpertKey, int] = {}
        self.freq: Dict[ExpertKey, int] = {}
        self.hi_freq: Dict[ExpertKey, int] = {}

    def advance_token(self):
        self.t += 1

    def on_use(self, key: ExpertKey, high_precision: bool):
        self.last_used[key] = self.t
        self.freq[key] = self.freq.get(key, 0) + 1
        if high_precision:
            self.hi_freq[key] = self.hi_freq.get(key, 0) + 1

    def priority(self, key: ExpertKey, w: PolicyWeights, current_layer: int) -> float:
        t = max(self.t, 1)
        p_lru = self.last_used.get(key, 0) / t
        p_lfu = self.freq.get(key, 0) / t
        p_lhu = self.hi_freq.get(key, 0) / t
        l = self.num_layers
        p_fld = 1.0 - (((key[0] - current_layer + l) % l) / l)
        return w.lru * p_lru + w.lfu * p_lfu + w.lhu * p_lhu + w.fld * p_fld
