"""Fleet-wide decayed expert heat (cross-request caching prior).

HOBBIT's multidimensional cache (paper §3.4, Eq. 3) scores experts from a
purely per-sequence view: `PolicyRecords` resets at every `new_sequence()`,
so each newly admitted request rediscovers expert popularity from scratch.
Under multi-tenant traffic the routing distribution is heavily shared
across requests (the DyMoE cross-request orchestration observation), so
the *fleet* already knows which experts are hot before a request routes
its first token.

`FleetHeat` is that prior: an exponentially decayed heat map over
`(layer, expert)` keys, fed by every request's routing decisions
(`observe`, weighted by gate magnitude) and decayed once per retired
request (`retire_request`).  `MultidimensionalCache.priority()` blends the
normalized heat into the Eq. 3 priority with weight `fleet_weight`, so
eviction (`_select_victim`), the upgrade pass's churn guard
(`peek_victim_priority`) and the idle-link upgrade ordering all prefer
experts the fleet keeps using — and a freshly admitted request starts from
the fleet's working set instead of a cold cache.

The map is engine-lifetime state: it deliberately survives
`cache.new_sequence()` (which resets only the per-sequence records), which
is exactly what makes it a cross-request prior.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

ExpertKey = Tuple[int, int]  # (layer, expert) — matches core/policies.py


class FleetHeat:
    """Decayed cross-request expert popularity.

    decay   multiplier applied to every key's heat when a request retires
            (per-request half-life ~= ln(2)/ln(1/decay) requests)
    floor   heat below which a key is pruned from the map after decay
    """

    def __init__(self, decay: float = 0.9, floor: float = 1e-3):
        assert 0.0 < decay < 1.0, "decay must be in (0, 1)"
        self.decay = float(decay)
        self.floor = float(floor)
        self._heat: Dict[ExpertKey, float] = {}   # owner: main-thread
        self._max = 0.0                           # owner: main-thread
        self.requests_retired = 0                 # owner: main-thread
        self.observations = 0                     # owner: main-thread

    # ------------------------------------------------------------------
    # owner: main-thread
    def observe(self, key: ExpertKey, weight: float = 1.0) -> None:
        """Record one routing decision for `key` (weight = gate magnitude)."""
        h = self._heat.get(key, 0.0) + float(weight)
        self._heat[key] = h
        if h > self._max:
            self._max = h
        self.observations += 1

    # owner: main-thread
    def retire_request(self) -> None:
        """Decay every key once (called when a request retires/releases)."""
        self.requests_retired += 1
        if not self._heat:
            return
        d, floor = self.decay, self.floor
        self._heat = {k: v * d for k, v in self._heat.items() if v * d > floor}
        self._max = max(self._heat.values()) if self._heat else 0.0

    # ------------------------------------------------------------------
    def score(self, key: ExpertKey) -> float:
        """Normalized heat in [0, 1] (1 = the fleet's hottest expert)."""
        if self._max <= 0.0:
            return 0.0
        return self._heat.get(key, 0.0) / self._max

    def is_warm(self, key: ExpertKey) -> bool:
        """True when the fleet has live (un-decayed-away) heat for `key`."""
        return self._heat.get(key, 0.0) > 0.0

    def layer_prior(self, layer: int, num_experts: int) -> np.ndarray:
        """Per-expert prior for one layer, normalized to sum 1 (uniform when
        the fleet is cold) — the predictor-blend input."""
        p = np.array([self._heat.get((layer, e), 0.0)
                      for e in range(num_experts)], dtype=np.float64)
        s = p.sum()
        if s <= 0.0:
            return np.full(num_experts, 1.0 / num_experts)
        return p / s

    def __len__(self) -> int:
        return len(self._heat)
