"""Multidimensional Cache Manager (HOBBIT §3.4): two-pool (high/low precision)
slot-based expert cache with Eq. 3 eviction, prediction pinning, and
per-sequence record resets.

The manager tracks *metadata only* (slot table, usage records); the engine
owns the device buffers and writes weights into the slot the manager assigns.

In-flight reservation state machine (one (key, precision) entry)::

            admit()                  begin_inflight(key, slot)
    absent ────────▶ resident ─────────────────────▶ resident+IN-FLIGHT
       ▲                │  ▲                               │
       │   _select_victim  └── end_inflight(key) ◀─────────┘
       └── (eviction)      (bytes landed; entry is an ordinary resident)

  * RESIDENT — owns a slot; evictable by Eq. 3 priority unless pinned.
  * RESIDENT+IN-FLIGHT — owns a slot but its weight bytes are still being
    staged by the async scheduler: `_select_victim` NEVER picks it (a
    staged write must not land on a reassigned slot) and compute must
    `wait()` before reading the slot.
  * Soft pins (predicted experts) yield under slot pressure; hard pins
    (the experts of the layer currently executing) never do.  If every
    resident is in flight, admission raises `CacheStarvation` and the
    caller drains the scheduler (clearing reservations) and retries.
  * Reservations are keyed by (key, precision): the hi and lo copies of one
    expert reserve independently, so the StagingEngine can cancel a queued
    hi reservation (`cancel_inflight`, returning its slot to the free list)
    and admit a lo replacement — or later upgrade a landed lo copy in place
    by admitting the hi copy alongside it.

Lifecycle hooks: `new_sequence()` resets records and pins at batch
boundaries; `advance_token()` clears pins each decode step.  See
docs/ARCHITECTURE.md for where this sits in the decode loop and
core/loader.py for the scheduler half of the handshake.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set, Tuple

from repro_torch.core.policies import ExpertKey, PolicyRecords, PolicyWeights, MULTIDIM


class CacheStarvation(RuntimeError):
    """Raised when admission finds no evictable slot: every resident entry is
    either hard-pinned by the executing layer or has an async load in flight.
    Callers resolve it by draining in-flight loads (which clears reservations)
    and retrying."""


@dataclasses.dataclass
class CacheStats:
    hits_hi: int = 0
    hits_lo: int = 0
    misses_hi: int = 0
    misses_lo: int = 0
    evictions: int = 0
    # hits on experts this sequence had never touched but the fleet heat map
    # already knew were hot — the cross-request prior paying off
    fleet_heat_hits: int = 0

    @property
    def hits(self):
        return self.hits_hi + self.hits_lo

    @property
    def misses(self):
        return self.misses_hi + self.misses_lo

    def hit_ratio(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    def miss_penalty(self, lo_cost_ratio: float = 0.25) -> float:
        """Paper's mixed-precision penalty: hi miss costs 1, lo miss B_l/B_h."""
        return self.misses_hi + lo_cost_ratio * self.misses_lo

    def to_dict(self) -> Dict[str, float]:
        """JSON-serializable view (engine.stats() contract)."""
        return {
            "hits_hi": self.hits_hi, "hits_lo": self.hits_lo,
            "misses_hi": self.misses_hi, "misses_lo": self.misses_lo,
            "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions, "hit_ratio": self.hit_ratio(),
            "fleet_heat_hits": self.fleet_heat_hits,
        }


class PrecisionPool:
    """One fixed-capacity slot pool (hi or lo precision)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.slot_of: Dict[ExpertKey, int] = {}
        self.key_of: Dict[int, ExpertKey] = {}
        self.free = list(range(capacity))

    def lookup(self, key: ExpertKey) -> Optional[int]:
        return self.slot_of.get(key)

    def contains(self, key: ExpertKey) -> bool:
        return key in self.slot_of

    def insert(self, key: ExpertKey, slot: int):
        self.slot_of[key] = slot
        self.key_of[slot] = key

    def remove(self, key: ExpertKey) -> int:
        slot = self.slot_of.pop(key)
        del self.key_of[slot]
        return slot


class MultidimensionalCache:
    """Two pools + shared policy records + prediction pin set."""

    def __init__(self, num_layers: int, hi_slots: int, lo_slots: int,
                 weights: PolicyWeights = MULTIDIM, *, fleet=None,
                 fleet_weight: float = 0.25):
        """fleet: optional ``core.fleet_heat.FleetHeat`` — a cross-request
        expert heat prior blended into every Eq. 3 priority with weight
        `fleet_weight` (see ``priority``).  None reproduces the pure
        per-sequence policy bit-for-bit."""
        self.records = PolicyRecords(num_layers)
        self.hi = PrecisionPool(hi_slots)
        self.lo = PrecisionPool(lo_slots)
        self.weights = weights
        self.fleet = fleet
        self.fleet_weight = float(fleet_weight)
        self.pinned: Set[Tuple[ExpertKey, bool]] = set()  # (key, is_hi)
        self.hard_pinned: Set[Tuple[ExpertKey, bool]] = set()
        # async-load reservations: (key, is_hi) -> slot.  The entry already
        # owns its slot in the pool table, but the weight bytes are still in
        # flight; it must never be evicted (the staged write would land on a
        # reassigned slot) and compute must wait() before reading the slot.
        self.inflight: Dict[Tuple[ExpertKey, bool], int] = {}
        self.stats = CacheStats()          # owner: main-thread

    # ------------- sequence / token lifecycle -------------
    # owner: main-thread
    def new_sequence(self):
        self.records.reset()
        self.pinned.clear()
        self.hard_pinned.clear()

    # owner: main-thread
    def advance_token(self):
        self.records.advance_token()
        self.pinned.clear()
        self.hard_pinned.clear()

    # ------------- pinning (predicted experts; §3.3 "mask") -------------
    # owner: main-thread
    def pin(self, key: ExpertKey, high_precision: bool, hard: bool = False):
        """Soft pins (predicted experts) yield under slot pressure; hard pins
        (the experts of the layer currently executing) never do."""
        self.pinned.add((key, high_precision))
        if hard:
            self.hard_pinned.add((key, high_precision))

    # ------------- async-load reservations -------------
    # owner: main-thread
    def begin_inflight(self, key: ExpertKey, high_precision: bool, slot: int):
        self.inflight[(key, high_precision)] = slot

    # owner: main-thread
    def end_inflight(self, key: ExpertKey, high_precision: bool):
        self.inflight.pop((key, high_precision), None)

    # owner: main-thread
    def cancel_inflight(self, key: ExpertKey,
                        high_precision: bool) -> Optional[int]:
        """Abort an in-flight reservation whose copy has NOT been issued yet
        (StagingEngine precision downgrade): drop the reservation, remove the
        entry from its pool and return the freed slot (or None when no such
        reservation exists).  Reservations are keyed by (key, precision), so
        cancelling the hi entry leaves a resident or in-flight lo copy of the
        same expert untouched — a lo landing can later be upgraded in place
        by simply admitting the hi copy alongside it."""
        slot = self.inflight.pop((key, high_precision), None)
        if slot is None:
            return None
        pool = self.hi if high_precision else self.lo
        if pool.lookup(key) == slot:
            pool.remove(key)
            pool.free.append(slot)
        # a cancelled entry no longer exists — stale pins for it must not
        # keep constraining _select_victim until the next advance_token
        self.pinned.discard((key, high_precision))
        self.hard_pinned.discard((key, high_precision))
        return slot

    def is_inflight(self, key: ExpertKey, high_precision: bool) -> bool:
        return (key, high_precision) in self.inflight

    def can_admit(self, high_precision: bool) -> bool:
        """True iff admit() can find a slot without touching an in-flight
        reservation or a hard-pinned resident — used by the async scheduler
        to drop (rather than deadlock on) prefetches under slot pressure."""
        pool = self.hi if high_precision else self.lo
        if pool.free:
            return True
        return any((k, high_precision) not in self.inflight
                   and (k, high_precision) not in self.hard_pinned
                   for k in pool.slot_of)

    def peek_victim_priority(self, high_precision: bool,
                             current_layer: int) -> Optional[float]:
        """Eq. 3 priority of the resident the next admit() on a FULL pool
        would evict, or None when admission is free (free slots) or nothing
        is evictable.  Uses `_select_victim` itself (pure selection, no side
        effects), so callers vetoing an admission that would evict something
        hotter than what they admit — the StagingEngine upgrade pass — are
        always comparing against the real eviction policy."""
        pool = self.hi if high_precision else self.lo
        if pool.free:
            return None
        try:
            victim = self._select_victim(pool, high_precision, current_layer)
        except CacheStarvation:
            return None
        return self.priority(victim, current_layer)

    # ------------- priority (Eq. 3 + fleet prior) -------------
    def priority(self, key: ExpertKey, current_layer: int) -> float:
        """THE cache priority: the per-sequence Eq. 3 score, blended with
        the fleet-wide heat prior when one is attached::

            p = (1 - w) * eq3(key) + w * fleet.score(key)

        Every consumer — ``_select_victim``, ``peek_victim_priority`` and
        the upgrade passes in core/loader.py and core/simulator.py — ranks
        experts through this method, so a fleet-hot expert is harder to
        evict and upgraded sooner even before the current sequence touches
        it.  Without a fleet (fleet=None) this is exactly
        ``records.priority``."""
        p = self.records.priority(key, self.weights, current_layer)
        if self.fleet is None:
            return p
        w = self.fleet_weight
        return (1.0 - w) * p + w * self.fleet.score(key)

    # ------------- queries -------------
    def lookup(self, key: ExpertKey, high_precision: bool) -> Optional[int]:
        pool = self.hi if high_precision else self.lo
        return pool.lookup(key)

    # owner: main-thread
    def probe(self, key: ExpertKey, high_precision: bool, *,
              count_stats: bool = True) -> Optional[int]:
        """lookup + stats + usage record update on hit."""
        slot = self.lookup(key, high_precision)
        if count_stats:
            if slot is not None:
                if high_precision:
                    self.stats.hits_hi += 1
                else:
                    self.stats.hits_lo += 1
            else:
                if high_precision:
                    self.stats.misses_hi += 1
                else:
                    self.stats.misses_lo += 1
        if slot is not None:
            if (count_stats and self.fleet is not None
                    and self.records.freq.get(key, 0) == 0
                    and self.fleet.is_warm(key)):
                # first touch this sequence, but the fleet kept it resident
                self.stats.fleet_heat_hits += 1
            self.records.on_use(key, high_precision)
        return slot

    # ------------- admission / eviction -------------
    # owner: main-thread
    def admit(self, key: ExpertKey, high_precision: bool,
              current_layer: int) -> Tuple[int, Optional[ExpertKey]]:
        """Assign a slot for `key` (evicting the lowest-priority unpinned
        resident if full).  Returns (slot, evicted_key_or_None).  The caller
        must then write the weights into the returned slot."""
        pool = self.hi if high_precision else self.lo
        existing = pool.lookup(key)
        if existing is not None:
            self.records.on_use(key, high_precision)
            return existing, None
        evicted = None
        if pool.free:
            slot = pool.free.pop()
        else:
            victim = self._select_victim(pool, high_precision, current_layer)
            slot = pool.remove(victim)
            evicted = victim
            self.stats.evictions += 1
        pool.insert(key, slot)
        self.records.on_use(key, high_precision)
        return slot, evicted

    def _select_victim(self, pool: PrecisionPool, is_hi: bool,
                       current_layer: int) -> ExpertKey:
        best_key, best_p = None, float("inf")
        for key in pool.slot_of:
            if (key, is_hi) in self.pinned or (key, is_hi) in self.inflight:
                continue
            p = self.priority(key, current_layer)
            if p < best_p:
                best_key, best_p = key, p
        if best_key is None:
            # everything soft-pinned: sacrifice a predicted expert, but never
            # one the currently-executing layer needs (hard pin) or one whose
            # weight bytes are still landing (in flight)
            cands = [k for k in pool.slot_of
                     if (k, is_hi) not in self.hard_pinned
                     and (k, is_hi) not in self.inflight]
            if not cands:
                # pathological: cache < top_k.  Hard-pinned entries of the
                # executing layer may be sacrificed (they already computed or
                # will be reloaded on demand) but in-flight ones never can.
                cands = [k for k in pool.slot_of
                         if (k, is_hi) not in self.inflight]
            if not cands:
                raise CacheStarvation(
                    f"{'hi' if is_hi else 'lo'} pool: every resident expert "
                    "has an async load in flight; drain the scheduler first")
            best_key = min(cands, key=lambda k: self.priority(
                k, current_layer))
        return best_key

    # ------------- views -------------
    def resident(self, high_precision: bool) -> Set[ExpertKey]:
        return set((self.hi if high_precision else self.lo).slot_of)
