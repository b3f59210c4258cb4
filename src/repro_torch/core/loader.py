"""Token-level Dynamic Expert Loader (HOBBIT §3.2): Expert Scorer + Task
Queue + Expert Scheduler, with a multi-stream byte-budgeted staging engine.

On a cache miss the Expert Scorer turns gate magnitudes into per-expert
precision decisions (Eq. 2 + T1/T2); the scheduler executes load tasks,
fetching weights from host storage and admitting them into the cache (which
may evict).  Two schedulers exist:

  * ``DynamicExpertLoader.drain`` — the original synchronous scheduler (one
    fetch per task on the caller's thread).  Kept as the reference path and
    for the engine's legacy per-expert decode.
  * ``StagingEngine`` — the wall-clock-real scheduler: PREFETCH tasks
    reserve their cache slot immediately (in-flight reservation, so nothing
    can race them) and stage their weight bytes on N background streams
    (default: one hi-precision, one lo-precision) that share a modeled H2D
    link budget; a ``wait(layer)`` barrier commits staged writes before the
    layer that needs them reads the pools.  ON_DEMAND tasks stay blocking
    but are batched into a single scatter per pool tensor (``commit_fn``).
    ``StagingEngine(streams=1, ordered=True)`` reproduces the original
    single-worker FIFO scheduler exactly (the parity reference).

Issue policy of the budgeted engine (``ordered=False``): queued jobs carry
``(layer, expert, precision, bytes, gate_score)``; each stream issues
**biggest-gate-first within the nearest-deadline layer**, and a queued (not
in-flight) hi-precision job is preempted by a lo-precision replacement when
the remaining link budget before the layer's ``wait()`` deadline —
``(deadline_layer - current_layer) * per_layer_s * link_bps`` minus bytes
already issued and not yet landed — cannot fit the hi copy.  This is the
paper's token-level dynamic precision decision made at *issue* time under
link contention rather than only at request time; the engine's compute path
consumes the downgrade by serving the affected expert from the lo pool.

A downgrade is meant to be *temporary*: when ``_pump()`` finds no queued
deadline work (twice in a row) and a hi stream fully idle, the idle-link
**upgrade pass** (``_pump_upgrades``, on by default; ``upgrade=False`` keeps
the per-token downgrade semantics bit-identical) re-issues hi copies for
lo-substituted experts — hottest Eq. 3 cache priority first, at most one in
flight per stream — landing them via the precision-keyed in-flight
reservation next to the resident lo copy.  The compute path serves the lo
stand-in (counted in ``served_lo_expert_steps``) until the hi bytes commit,
then switches back to hi.  The substitution therefore lasts exactly as long
as the link stays saturated — while every pump still carries deadline work,
hi reloads for substituted keys are deliberately suppressed (re-adding the
bytes the preemption shed would stall the very barriers the downgrade
protects; under the per-token downgrade semantics the same sustained contention
re-downgrades the same hot experts every token anyway) — and ends at the
first idle window, so a token-level precision decision can outlive its
token only while the link has no spare capacity to undo it, with the
exposure always visible in ``served_lo_expert_steps``.

StagingEngine lifecycle of one prefetched expert::

    submit_prefetch(layer, experts, decisions, gates)  [main thread]
        -> cache.admit() assigns a slot NOW            "reserve"
        -> cache.begin_inflight(key, slot)             eviction-proof
        -> job queued per stream; _pump() issues the best job when its
           stream is free (possibly downgrading hi -> lo under budget)
        -> stream executor stages host bytes           overlaps compute
    wait(layer)  (barrier before the layer runs)      [main thread]
        -> pending jobs for `layer` are force-issued, futures awaited
           (blocks only if the copy is late -> stall_s)
        -> cache.end_inflight(key)                     "commit" begins
        -> commit_fn(entries): ONE batched scatter per pool tensor
    (wait_all()/flush() at sequence boundaries commit leftovers without
    attributing stall)

Invariants: cache metadata is touched ONLY on the main thread (admission,
reservation, downgrade cancellation all happen at submit/pump/wait time);
the background workers see host storage and private staging buffers, never
the pools; an in-flight entry owns its slot from submit to commit (or until
a downgrade cancels it before issue), so a staged write can never land on a
reassigned slot (see core/cache.py for the reservation state machine).  The
staging engine shares the loader's cache and byte/load counters so
`engine.stats()` is one source of truth either way.  Metric definitions:
docs/METRICS.md; system map: docs/ARCHITECTURE.md.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Deque, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.cache import CacheStarvation, MultidimensionalCache
from repro_torch.core.scoring import (PREC_HI, PREC_LO, PREC_SKIP, Thresholds,
                                precision_decisions)
from repro_torch.spans import span

ON_DEMAND, PREFETCH, UPGRADE = "on_demand", "prefetch", "upgrade"


def measure_link_bps(nbytes: int = 1 << 26, repeats: int = 3,
                     device=None) -> float:
    """Measure the host -> device copy rate (bytes/s) used as the modeled
    link rate when `EngineConfig.link_gbps` is not set.

    On a CUDA device this times a pinned-host -> device copy of `nbytes`
    (best of `repeats`, each ended by a stream synchronisation) — the path
    every expert transfer takes.  On the CPU the "link" is a host memcpy.
    The result only feeds the staging engine's issue-time budget
    accounting, never a sleep."""
    import torch

    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type == "cuda":
        src = torch.ones(nbytes, dtype=torch.uint8, pin_memory=True)
        dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev)
        best = float("inf")
        for _ in range(repeats):
            stream.synchronize()
            t0 = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            stream.synchronize()
            best = min(best, time.perf_counter() - t0)
        return nbytes / max(best, 1e-9)
    nbytes = min(nbytes, 1 << 22)
    host_src = np.ones(nbytes, np.uint8)
    host_dst = np.empty_like(host_src)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        np.copyto(host_dst, host_src)
        best = min(best, time.perf_counter() - t0)
    return nbytes / max(best, 1e-9)


@dataclasses.dataclass
class LoadTask:
    """One expert transfer request (the paper's Task Queue entry)."""
    layer: int
    expert: int
    precision: int              # PREC_HI | PREC_LO
    reason: str                 # ON_DEMAND | PREFETCH
    bytes: int = 0              # filled by the scheduler from the cost model
    gate: float = 0.0           # routing weight that requested this expert


@dataclasses.dataclass
class LoadReport:
    """Outcome of scoring one (layer, slot) expert set."""
    tasks: List[LoadTask]
    skipped: List[int]          # expert ids skipped this layer (score > T2)
    hit_slots: List[Tuple[int, int, int]]   # (expert, precision, slot)


class DynamicExpertLoader:
    """Expert Scorer + Task Queue + the synchronous reference scheduler."""

    def __init__(self, cache: MultidimensionalCache, th: Thresholds,
                 fetch_fn: Callable[[int, int, int, int], None],
                 bytes_fn: Callable[[int], int]):
        """fetch_fn(layer, expert, precision, slot): writes the expert weights
        into the assigned device pool slot (engine-provided closure).
        bytes_fn(precision) -> transfer size."""
        self.cache = cache
        self.th = th
        self.fetch_fn = fetch_fn
        self.bytes_fn = bytes_fn
        self.queue: Deque[LoadTask] = deque()
        self.loaded_bytes = 0
        self.n_loads = {PREC_HI: 0, PREC_LO: 0}
        self.n_skips = 0

    # ---------------- Expert Scorer ----------------
    def new_layer(self):
        """Reset hard pins at a layer boundary.  Batched decoding calls this
        once per layer, then scores every slot's expert set with
        ``clear_pins=False`` so the union of all slots' experts stays
        protected while the layer executes."""
        self.cache.hard_pinned.clear()

    def score_and_enqueue(self, layer: int, experts: List[int],
                          gate_vals: np.ndarray, *,
                          clear_pins: bool = True) -> LoadReport:
        """Handle the on-demand expert set of one MoE layer for one token
        (one batch slot)."""
        dec = precision_decisions(gate_vals, self.th)
        # hard pins protect only the layer being executed; earlier layers'
        # experts already ran and may be evicted again
        if clear_pins:
            self.cache.hard_pinned.clear()
        tasks, skipped, hits = [], [], []
        for e, d, g in zip(experts, dec, gate_vals):
            if d == PREC_SKIP:
                skipped.append(e)
                self.n_skips += 1
                continue
            is_hi = d == PREC_HI
            # the experts of the layer being executed must never be evicted
            # by a concurrent prefetch admission
            self.cache.pin((layer, e), is_hi, hard=True)
            slot = self.cache.probe((layer, e), is_hi)
            if slot is not None:
                hits.append((e, d, slot))
            else:
                t = LoadTask(layer, e, int(d), ON_DEMAND, self.bytes_fn(int(d)),
                             float(g))
                tasks.append(t)
                self.queue.append(t)
        return LoadReport(tasks, skipped, hits)

    def enqueue_prefetch(self, layer: int, experts: List[int],
                         decisions: np.ndarray):
        """Queue prefetch tasks for a future layer (synchronous path)."""
        for e, d in zip(experts, decisions):
            if d == PREC_SKIP:
                continue
            if self.cache.lookup((layer, e), d == PREC_HI) is None:
                self.queue.append(
                    LoadTask(layer, e, int(d), PREFETCH, self.bytes_fn(int(d))))

    def take_queued(self) -> List[LoadTask]:
        """Hand the queued tasks to an external scheduler (clears the queue)."""
        tasks = list(self.queue)
        self.queue.clear()
        return tasks

    # ---------------- Expert Scheduler ----------------
    def drain(self, current_layer: int) -> List[Tuple[LoadTask, int]]:
        """Execute all queued tasks (on-demand first).  Returns
        [(task, slot)] in execution order."""
        done = []
        ordered = sorted(self.queue, key=lambda t: t.reason != ON_DEMAND)
        self.queue.clear()
        for t in ordered:
            is_hi = t.precision == PREC_HI
            if self.cache.lookup((t.layer, t.expert), is_hi) is not None:
                continue  # raced: already resident (e.g. dup prefetch)
            slot, _evicted = self.cache.admit((t.layer, t.expert), is_hi,
                                              current_layer)
            self.fetch_fn(t.layer, t.expert, t.precision, slot)
            self.loaded_bytes += t.bytes
            self.n_loads[t.precision] += 1
            done.append((t, slot))
        return done


# --------------------------------------------------------------------------
# multi-stream staging engine (byte-budgeted issue under a modeled H2D link)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _PrefetchJob:
    """One FIFO batch job of the ordered (single-worker parity) path."""
    tasks: List[Tuple[LoadTask, int]]       # (task, reserved slot)
    future: Future                          # -> (staged, t_start, t_end)
    t_submit: float


@dataclasses.dataclass
class StagingJob:
    """One queued/issued transfer of the budgeted multi-stream path."""
    task: LoadTask
    slot: int
    seq: int                                # global submit order (FIFO tie)
    stream: int
    future: Optional[Future] = None         # set at issue time


class StagingEngine:
    """Executes load tasks so prefetch copies overlap compute in wall clock,
    issuing them over N streams under a shared modeled H2D link budget.

    Division of labour with the engine:
      stage_fn(layer, expert, precision) -> staged host buffers (the
          host-side gather — the expensive part of the transfer — safe to run
          on a background thread because it only *reads* host storage).
      commit_fn(entries) with entries = [(task, slot, staged)] -> writes all
          staged buffers into the device pools, one scatter per pool tensor
          (main thread only, so pool arrays are never mutated concurrently
          with compute).

    Streams map to independent copy engines: hi-precision jobs issue on the
    first half of the streams, lo-precision jobs on the second half (with
    ``streams=2`` that is the paper-natural one-hi/one-lo split).  Each
    stream serializes its own copies; issue *order* within a stream is
    biggest-gate-first within the nearest-deadline layer.  The shared link
    budget (``link_bps``, measured at startup or configured) is consulted at
    issue time: a queued hi job whose bytes no longer fit before its layer's
    ``wait()`` deadline is preempted by a lo replacement (recorded in
    ``downgraded`` for the engine's compute path) — in-flight copies are
    never interrupted.  With ``emulate_link=True`` each staged copy also
    *occupies* the modeled link for bytes/link_bps seconds, so wall-clock
    stall numbers on this CPU-only container reflect link contention the
    way the simulator's timeline does.

    Cache metadata is only ever touched on the main thread: prefetch
    admission happens at submit time (with an in-flight reservation so
    lookup/eviction can't race it), downgrades cancel-and-readmit at pump
    time, and the background threads see nothing but host storage and their
    private staging buffers.
    """

    def __init__(self, loader: DynamicExpertLoader,
                 stage_fn: Callable[[int, int, int], dict],
                 commit_fn: Callable[[List[Tuple[LoadTask, int, dict]]], None],
                 *, streams: int = 2, ordered: bool = False,
                 link_bps: Optional[float] = None, emulate_link: bool = False,
                 upgrade: bool = True):
        self.loader = loader
        self.cache = loader.cache
        self.stage_fn = stage_fn
        self.commit_fn = commit_fn
        self.streams = max(1, int(streams))
        self.ordered = bool(ordered)
        # idle-link upgrade pass: re-issue hi copies for lo-substituted
        # (downgraded) experts when a hi stream has leftover link budget.
        # Only meaningful on the budgeted path — the ordered parity scheduler
        # never downgrades, so it never has anything to upgrade.
        self.upgrade = bool(upgrade) and not self.ordered
        self.link_bps = float(link_bps) if link_bps else 0.0
        self.emulate_link = bool(emulate_link) and self.link_bps > 0
        self._pools = [ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix=f"expert-stage{i}")
                       for i in range(self.streams)]
        # release the worker threads when the scheduler (engine) is collected
        self._finalizer = weakref.finalize(
            self, StagingEngine._shutdown_pools, self._pools)
        # owner: main-thread — the zero-lock scheduler queues: submit,
        # issue, collect and land all run on the caller's thread; the
        # stream executors only ever copy bytes (see class docstring)
        self._jobs: List[_PrefetchJob] = []     # owner: main-thread
        self._pending: List[StagingJob] = []    # owner: main-thread
        self._issued: List[StagingJob] = []     # owner: main-thread
        self._seq = 0
        self._rr = {True: 0, False: 0}              # round-robin per class
        # deadline clock (engine hints): current layer + per-layer seconds
        self._clock_layer = 0
        self._layer_s = 0.0         # compute-only window (downgrade budget)
        self._period_s = 0.0        # full layer period incl. load (stream feed)
        # consecutive pumps that found no queued deadline work (upgrade
        # hysteresis: see _pump_upgrades)
        self._idle_pumps = 0
        # issue-time downgrades the compute path should serve from lo
        # (per-token markers, retired each layer — the per-token semantics the
        # upgrade-off path keeps bit-identical)
        # owner: main-thread
        self.downgraded: Set[Tuple[int, int]] = set()
        # persistent downgrade substitutions: keys whose hi copy was
        # preempted and whose lo copy stands in for it until an upgrade
        # lands a hi copy next to it (or the lo copy is evicted / flushed).
        # The upgrade pass draws its candidates from here.
        # owner: main-thread
        self.lo_substituted: Set[Tuple[int, int]] = set()
        # observability (engine.stats() reads these)
        self.stall_s = 0.0              # wall time load work blocked compute
        self.copy_s = 0.0               # total staging-copy busy time
        self.overlap_s = 0.0            # portion of copy_s hidden by compute
        self.n_prefetch_jobs = 0
        self.n_dropped_prefetch = 0     # dropped for slot pressure
        self.issue_reorders = 0         # jobs issued ahead of an older one
        self.precision_downgrades = 0   # queued hi jobs preempted to lo
        self.upgrades = 0               # idle-link hi re-copies issued
        self.upgrade_bytes = 0          # bytes those re-copies moved
        self.served_lo_expert_steps = 0  # expert-steps computed from the lo
        #                                  pool in place of a hi decision
        #                                  (the accuracy-exposure proxy)
        self.per_stream_bytes = [0] * self.streams
        self._modeled_transfer_s = 0.0  # issued bytes / link_bps
        self._t_first_issue: Optional[float] = None
        self._t_last_commit: Optional[float] = None

    @staticmethod
    def _shutdown_pools(pools):
        """Finalizer target: release every stream's worker thread."""
        for p in pools:
            p.shutdown(wait=False)

    def _stream_of(self, precision: int) -> int:
        """Map a job's precision class to a stream: hi jobs round-robin over
        the first half of the streams, lo jobs over the second half."""
        if self.streams == 1:
            return 0
        is_hi = precision == PREC_HI
        n_hi = (self.streams + 1) // 2
        lo0, n_lo = n_hi, self.streams - n_hi
        self._rr[is_hi] += 1
        if is_hi:
            return self._rr[True] % n_hi
        return lo0 + self._rr[False] % n_lo

    # ---------------- prefetch (async, multi-stream) ----------------
    def set_deadline_clock(self, current_layer: int, per_layer_s: float,
                           period_s: Optional[float] = None):
        """Engine hint from the layer schedule: the decode loop is at
        `current_layer` and one layer takes ~`per_layer_s` of compute, so a
        job for layer L has a `(L - current_layer) * per_layer_s` window of
        link time it can hide before its `wait()` deadline (anything beyond
        that window becomes stall — the downgrade budget).  `period_s` is
        the full layer period *including* load time: the issue pump runs
        once per layer, so each stream is kept fed with one period's worth
        of link bytes to bridge the gap between pumps."""
        self._clock_layer = int(current_layer)
        self._layer_s = float(per_layer_s)
        self._period_s = float(period_s if period_s else per_layer_s)

    def submit_prefetch(self, layer: int, experts: List[int],
                        decisions: np.ndarray, *, current_layer: int,
                        gates: Optional[np.ndarray] = None) -> int:
        """Reserve slots and queue staging copies for predicted experts of a
        future layer.  Returns the number of tasks actually submitted."""
        if gates is None:
            gates = np.zeros(len(experts))
        tasks: List[Tuple[LoadTask, int]] = []
        for e, d, g in zip(experts, decisions, gates):
            if d == PREC_SKIP:
                continue
            is_hi = d == PREC_HI
            key = (layer, int(e))
            if self.cache.lookup(key, is_hi) is not None:
                continue                      # resident or already in flight
            if (is_hi and self.upgrade
                    and self.serves_lo_downgrade(layer, int(e))):
                # lo-substituted expert: its promotion belongs to the
                # idle-link upgrade pass, not the deadline path — a deadline
                # hi prefetch here would re-add the bytes the downgrade shed
                # and stall the wait() barrier the substitution exists to
                # protect
                continue
            if not self.cache.can_admit(is_hi):
                self.n_dropped_prefetch += 1  # slot pressure: skip, don't block
                continue
            slot, _ = self.cache.admit(key, is_hi, current_layer)
            self.cache.begin_inflight(key, is_hi, slot)
            t = LoadTask(layer, int(e), int(d), PREFETCH,
                         self.loader.bytes_fn(int(d)), float(g))
            tasks.append((t, slot))
        if not tasks:
            return 0
        if self.ordered:
            # single-worker parity path: ONE batched FIFO job per submit call on the
            # single worker, bit-identical to the original scheduler
            for t, _ in tasks:
                self.per_stream_bytes[0] += t.bytes
                if self.link_bps > 0:
                    self._modeled_transfer_s += t.bytes / self.link_bps
            if self._t_first_issue is None:
                self._t_first_issue = time.perf_counter()
            fut = self._pools[0].submit(self._stage_batch,
                                        [t for t, _ in tasks])
            self._jobs.append(_PrefetchJob(tasks, fut, time.perf_counter()))
            self.n_prefetch_jobs += 1
            return len(tasks)
        for t, slot in tasks:
            self._pending.append(StagingJob(t, slot, self._seq,
                                            self._stream_of(t.precision)))
            self._seq += 1
            self.n_prefetch_jobs += 1
        self._pump()
        return len(tasks)

    def _emulate_copy(self, t_start: float, nbytes: int):
        """Occupy the modeled link for the remainder of `nbytes`'s transfer
        time (copy work already done since `t_start` counts against it).
        No-op unless link emulation is on."""
        if not self.emulate_link:
            return
        remain = nbytes / self.link_bps - (time.perf_counter() - t_start)
        if remain > 0:
            time.sleep(remain)

    def _stage_batch(self, tasks: List[LoadTask]):
        """Worker body of one ordered-path batch job (each copy occupies the
        single stream for bytes/link_bps when the link is emulated, so the
        FIFO baseline pays the same modeled link as the budgeted path)."""
        t0 = time.perf_counter()
        staged = []
        for t in tasks:
            tc = time.perf_counter()
            staged.append(self._staged(t))
            self._emulate_copy(tc, t.bytes)
        return staged, t0, time.perf_counter()

    def _stage_one(self, task: LoadTask):
        """Worker body of one budgeted-path job (one expert copy); with link
        emulation on, the copy occupies its stream for bytes/link_bps."""
        t0 = time.perf_counter()
        staged = self._staged(task)
        self._emulate_copy(t0, task.bytes)
        return staged, t0, time.perf_counter()

    def _staged(self, t: LoadTask):
        """``stage_fn`` on one task, in a ``loader.stage`` span."""
        with span("loader.stage", t.layer, t.expert, t.precision, t.reason, t.bytes):
            return self.stage_fn(t.layer, t.expert, t.precision)

    # ---------------- budgeted issue ----------------
    # The compute-window estimate feeding the budget is a noisy EMA; only
    # issue a hi copy when it fits with 2x headroom, so the hi-vs-lo issue
    # decision doesn't flicker with scheduler jitter (a hi copy that barely
    # fits on paper almost never lands in time on a contended link).
    BUDGET_SAFETY = 0.5

    def _budget_bytes(self, deadline_layer: int) -> float:
        """Modeled link bytes transferable before `deadline_layer`'s wait(),
        discounted by BUDGET_SAFETY to absorb compute-window estimate noise."""
        gap = max(0, deadline_layer - self._clock_layer)
        return gap * self._layer_s * self.link_bps * self.BUDGET_SAFETY

    def _issued_backlog_bytes(self) -> int:
        """Bytes issued to any stream whose copy has not finished yet,
        excluding UPGRADE-reason copies: those are background work a
        deadline prefetch queues behind for at most one transfer, and
        counting them against the deadline budget would let an idle-window
        upgrade demote the very next deadline hi copy — re-creating the
        substitution the pass just repaired."""
        return sum(j.task.bytes for j in self._issued
                   if not j.future.done() and j.task.reason != UPGRADE)

    def _try_downgrade(self, job: StagingJob) -> Optional[StagingJob]:
        """Preempt a queued hi job whose bytes no longer fit the remaining
        link budget before its deadline: cancel the hi reservation and (when
        the lo pool can take it) re-reserve a lo replacement.  Returns the
        replacement job, or None when the job was dropped outright (lo copy
        already resident/in flight, or lo pool full)."""
        key = (job.task.layer, job.task.expert)
        self.cache.cancel_inflight(key, True)
        if self.cache.lookup(key, False) is not None:
            # lo already resident or in flight: the downgrade is served
            self.precision_downgrades += 1
            self.downgraded.add(key)
            if self.upgrade:
                self.lo_substituted.add(key)
            return None
        if not self.cache.can_admit(False):
            # no lo slot either: this is a plain drop, not a downgrade —
            # the layer will blocking-load hi on demand
            self.n_dropped_prefetch += 1
            return None
        self.precision_downgrades += 1
        self.downgraded.add(key)
        if self.upgrade:
            # with the upgrade pass off (per-token parity) the set would only
            # accumulate dead state nothing reads until flush()
            self.lo_substituted.add(key)
        slot, _ = self.cache.admit(key, False, self._clock_layer)
        self.cache.begin_inflight(key, False, slot)
        t = LoadTask(job.task.layer, job.task.expert, PREC_LO, PREFETCH,
                     self.loader.bytes_fn(PREC_LO), job.task.gate)
        rep = StagingJob(t, slot, self._seq, self._stream_of(PREC_LO))
        self._seq += 1
        return rep

    def _issue(self, job: StagingJob):
        """Hand one job to its stream's executor and account the issue."""
        job.future = self._pools[job.stream].submit(self._stage_one, job.task)
        self._issued.append(job)
        self.per_stream_bytes[job.stream] += job.task.bytes
        if self.link_bps > 0:
            self._modeled_transfer_s += job.task.bytes / self.link_bps
        if self._t_first_issue is None:
            self._t_first_issue = time.perf_counter()

    def _pump(self, *, force_layer: Optional[int] = None):
        """Issue queued jobs onto their streams (and every queued job
        targeting `force_layer`, ahead of a wait barrier).  Issue order per
        stream: nearest deadline layer first, biggest gate within it, then
        FIFO.  Each stream is kept fed with at most ~one layer's worth of
        link bytes (`link_bps * per_layer_s`); the rest stays queued here,
        where it can still be reordered — and where a queued hi job that no
        longer fits the link budget before its deadline is downgraded to a
        lo replacement.  In-flight copies are never preempted.  Once every
        queued deadline job is placed, leftover stream budget goes to the
        idle-link upgrade pass (`_pump_upgrades`)."""
        if self.ordered:
            return
        had_deadline_work = bool(self._pending)
        # per-stream issued-but-unfinished bytes (the stream's fed backlog)
        backlog = [0] * self.streams
        for j in self._issued:
            if not j.future.done():
                backlog[j.stream] += j.task.bytes
        # No feed estimate (no deadline clock yet, or an unmodeled link)
        # means *unlimited* feed: every queued job issues immediately.  A
        # zero here would degenerate the threshold below to one byte and
        # serialize each stream to a single outstanding copy.
        feed = (self.link_bps * max(self._period_s, self._layer_s)
                if self.link_bps > 0 and self._layer_s > 0
                else float("inf"))
        progress = True
        while progress and self._pending:
            progress = False
            for stream in range(self.streams):
                cands = [j for j in self._pending if j.stream == stream]
                if not cands:
                    continue
                forced = (force_layer is not None
                          and any(j.task.layer == force_layer for j in cands))
                if backlog[stream] >= max(feed, 1.0) and not forced:
                    continue            # stream fed; keep the rest reorderable
                if forced:
                    cands = [j for j in cands if j.task.layer == force_layer]
                best = min(cands,
                           key=lambda j: (j.task.layer, -j.task.gate, j.seq))
                if best.seq != min(j.seq for j in self._pending
                                   if j.stream == stream):
                    self.issue_reorders += 1
                self._pending.remove(best)
                # budget preemption applies only while the deadline is still
                # ahead (gap >= 1 layer): a job collected by its own wait()
                # barrier must issue as requested — the downgrade decision
                # belongs to the contention window before the deadline
                if (best.task.precision == PREC_HI and self.link_bps > 0
                        and self._layer_s > 0 and not forced
                        and best.task.layer > self._clock_layer):
                    budget = self._budget_bytes(best.task.layer)
                    if self._issued_backlog_bytes() + best.task.bytes > budget:
                        rep = self._try_downgrade(best)
                        if rep is not None:
                            self._pending.append(rep)
                        progress = True
                        continue
                self._issue(best)
                backlog[best.stream] += best.task.bytes
                progress = True
        self._pump_upgrades(backlog, had_deadline_work=had_deadline_work)

    def _pump_upgrades(self, backlog: List[int], *,
                       had_deadline_work: bool = False):
        """Idle-link upgrade pass (ROADMAP's upgrade-in-place): when no
        queued deadline work remains and a hi stream is fully idle,
        re-issue hi copies for lo-substituted experts — hottest Eq. 3 cache
        priority first, at most one in flight per stream.  Upgrade jobs are
        created directly at issue time (never queued), so a deadline
        prefetch submitted afterwards is always pumped first: an upgrade
        can only ride link time that would otherwise idle, a deadline copy
        arriving mid-upgrade waits at most one transfer, and the `wait()`
        barrier never blocks on one.  The hi copy lands via the normal
        precision-keyed in-flight reservation *next to* the resident lo
        copy; once committed, `serves_lo_downgrade` flips off and the
        compute path switches back to hi.

        Hysteresis: upgrades wait for TWO consecutive pumps that saw no
        deadline work at all (queued at entry or still queued now).  During
        a contention burst the pump's queue drains and refills every layer,
        and an upgrade issued into such a momentary gap occupies its stream
        just as the next layer's deadline prefetches arrive — the
        hysteresis keeps the pass out of the burst entirely and costs one
        pump cycle of recovery latency once the link genuinely idles."""
        if self._pending or had_deadline_work:
            self._idle_pumps = 0
            return
        self._idle_pumps += 1
        if not self.upgrade or self._idle_pumps < 2:
            return
        cands = []
        for key in list(self.lo_substituted):
            if self.cache.lookup(key, False) is None:
                # the lo stand-in was evicted: nothing to upgrade in place
                self.lo_substituted.discard(key)
                continue
            if (self.cache.lookup(key, True) is not None
                    or self.cache.is_inflight(key, True)):
                continue                # hi already landed or landing
            if self.cache.is_inflight(key, False):
                # the lo replacement itself is still in flight: re-issuing
                # the hi bytes now would undo the preemption that shed them
                continue
            cands.append(key)
        if not cands:
            return
        # fleet-blended cache priority (cache.priority): a fleet-hot expert
        # is re-promoted before one only this sequence has touched
        prio = lambda k: self.cache.priority(k, self._clock_layer)  # noqa: E731
        cands.sort(key=lambda k: -prio(k))
        hi_bytes = self.loader.bytes_fn(PREC_HI)
        n_hi = 1 if self.streams == 1 else (self.streams + 1) // 2
        for key in cands:
            # at most ONE upgrade in flight per stream, issued onto the
            # first IDLE hi stream (not the round-robin pick, which could
            # map a candidate to a busy stream while another hi stream
            # idles): an in-flight copy is never preempted, so a deadline
            # prefetch arriving mid-upgrade waits at most one transfer.
            # Deliberately NOT feed-gated: in the offload regime one hi
            # copy often exceeds a layer-period of link bytes, and a feed
            # veto would starve re-promotion forever on a fully idle link —
            # the single-copy cap IS the budget bound
            stream = next((s for s in range(n_hi) if backlog[s] == 0), None)
            if stream is None:
                break                   # every hi stream busy this pump
            if not self.cache.can_admit(True):
                break                   # hi pool has no evictable slot
            # an upgrade must never evict a hi resident at least as hot as
            # the expert it promotes: that trades one exposure for another
            # and feeds an evict -> miss -> downgrade -> upgrade churn
            # cycle under a tight hi pool
            victim_p = self.cache.peek_victim_priority(True,
                                                       self._clock_layer)
            if victim_p is not None and victim_p >= prio(key):
                break                   # candidates are priority-sorted
            slot, _ = self.cache.admit(key, True, self._clock_layer)
            self.cache.begin_inflight(key, True, slot)
            t = LoadTask(key[0], key[1], PREC_HI, UPGRADE, hi_bytes)
            job = StagingJob(t, slot, self._seq, stream)
            self._seq += 1
            self._issue(job)
            backlog[stream] += hi_bytes
            self.upgrades += 1
            self.upgrade_bytes += hi_bytes

    # ---------------- barriers ----------------
    def _collect_batch(self, job: _PrefetchJob, entries: List,
                       *, blocking_for_layer: bool):
        """Await one ordered-path batch job and queue its landed entries."""
        t_wait = time.perf_counter()
        staged, t0, t1 = job.future.result()
        if blocking_for_layer:
            self.stall_s += max(0.0, time.perf_counter() - t_wait)
        busy = max(0.0, t1 - t0)
        self.copy_s += busy
        self.overlap_s += min(busy, max(0.0, t_wait - t0))
        for (task, slot), buf in zip(job.tasks, staged):
            self._land(task, slot, buf, entries, stream=0)

    def _collect_job(self, job: StagingJob, entries: List,
                     *, blocking_for_layer: bool):
        """Await one budgeted-path job and queue its landed entry."""
        t_wait = time.perf_counter()
        staged, t0, t1 = job.future.result()
        if blocking_for_layer:
            self.stall_s += max(0.0, time.perf_counter() - t_wait)
        busy = max(0.0, t1 - t0)
        self.copy_s += busy
        self.overlap_s += min(busy, max(0.0, t_wait - t0))
        self._land(job.task, job.slot, staged, entries, stream=job.stream)

    def _land(self, task: LoadTask, slot: int, buf, entries: List, *,
              stream: int):
        """Clear the in-flight reservation and queue the staged buffer for
        the batched commit (skipping entries whose reservation was flushed
        between submit and commit)."""
        is_hi = task.precision == PREC_HI
        self.cache.end_inflight((task.layer, task.expert), is_hi)
        # the reservation may have been flushed by a new_sequence between
        # submit and commit; only write slots the entry still owns
        if self.cache.lookup((task.layer, task.expert), is_hi) == slot:
            entries.append((task, slot, buf))
            self.loader.loaded_bytes += task.bytes
            self.loader.n_loads[task.precision] += 1
            if is_hi:
                # a landed hi copy ends any lo substitution for this expert:
                # the compute path must serve hi, not a stale downgrade marker
                self.lo_substituted.discard((task.layer, task.expert))
                self.downgraded.discard((task.layer, task.expert))

    def wait(self, layer: int):
        """Barrier before computing `layer`: commit every finished job, and
        block on (then commit) any queued or in-flight job that targets
        `layer`.  All collected jobs land in ONE batched pool scatter.
        Upgrade re-copies never block the barrier — they are background
        work; the layer keeps serving the lo stand-in until the hi copy has
        actually committed."""
        entries: List = []
        if self.ordered:
            remaining = []
            for job in self._jobs:
                needed = any(t.layer == layer for t, _ in job.tasks)
                if needed or job.future.done():
                    self._collect_batch(job, entries,
                                        blocking_for_layer=needed)
                else:
                    remaining.append(job)
            self._jobs = remaining
        else:
            self._pump(force_layer=layer)
            remaining = []
            for job in self._issued:
                needed = (job.task.layer == layer
                          and job.task.reason != UPGRADE)
                if needed or job.future.done():
                    self._collect_job(job, entries, blocking_for_layer=needed)
                else:
                    remaining.append(job)
            self._issued = remaining
            self._pump()
        if entries:
            self.commit_fn(entries)
            self._t_last_commit = time.perf_counter()

    def wait_all(self):
        """Commit every queued and in-flight job without attributing stall
        (sequence/batch boundary, not a compute barrier)."""
        entries: List = []
        for job in self._jobs:
            self._collect_batch(job, entries, blocking_for_layer=False)
        self._jobs = []
        while self._pending or self._issued:
            for stream in range(self.streams):
                cands = [j for j in self._pending if j.stream == stream]
                for j in sorted(cands, key=lambda j: (j.task.layer,
                                                      -j.task.gate, j.seq)):
                    self._pending.remove(j)
                    self._issue(j)
            for job in self._issued:
                self._collect_job(job, entries, blocking_for_layer=False)
            self._issued = []
        if entries:
            self.commit_fn(entries)
            self._t_last_commit = time.perf_counter()

    def flush(self):
        """Commit everything in flight (sequence/batch boundary)."""
        self.wait_all()
        self.downgraded.clear()
        self.lo_substituted.clear()

    def retire_layer(self, layer: int):
        """Drop per-token downgrade markers once `layer`'s compute consumed
        them.  With the upgrade pass OFF this restores the per-token contract —
        a later decode step's hi request for the same expert blocking-loads
        hi again rather than silently keep serving lo.  With the upgrade
        pass ON the substitution instead persists in `lo_substituted` until
        a background hi re-copy lands (`serves_lo_downgrade` tracks that),
        keeping the promotion off the critical path."""
        self.downgraded = {k for k in self.downgraded if k[0] != layer}

    def serves_lo_downgrade(self, layer: int, expert: int) -> bool:
        """True when (layer, expert)'s hi copy was downgraded away and its
        lo stand-in is resident — the compute path should read the lo pool
        instead of blocking on an on-demand hi load.

        Upgrade pass ON: the substitution persists across decode steps and
        ends the moment a hi copy has fully landed next to the lo one (hi
        resident and no longer in flight) or the lo copy is evicted.
        Upgrade pass OFF (per-token parity): only the per-token `downgraded`
        markers count, retired each layer by `retire_layer`."""
        key = (layer, expert)
        if self.upgrade:
            if key not in self.lo_substituted:
                return False
            if self.cache.lookup(key, False) is None:
                self.lo_substituted.discard(key)    # lo stand-in evicted
                return False
            if (self.cache.lookup(key, True) is not None
                    and not self.cache.is_inflight(key, True)):
                # upgrade complete: hi bytes committed beside the lo copy
                self.lo_substituted.discard(key)
                return False
            return True
        return (key in self.downgraded
                and self.cache.lookup(key, False) is not None)

    # ---------------- on-demand (blocking, batched) ----------------
    def drain_on_demand(self, tasks: List[LoadTask],
                        current_layer: int) -> List[Tuple[LoadTask, int]]:
        """Execute the current layer's miss set: one staging gather per task
        on the caller's thread (these block compute — that's the stall the
        stats record; under link emulation each copy also occupies the link
        for bytes/rate) and a single batched commit.  Hi tasks whose expert
        was downgraded at issue time (lo replacement resident) are skipped —
        the compute path serves them from the lo pool.  Misses stay on the
        caller's thread rather than the prefetch streams on purpose: they
        are due *now*, and queueing them behind speculative future-layer
        copies would invert the deadline order the pump maintains."""
        # cheap skip checks run BEFORE the stall timer starts: a layer whose
        # miss set is empty or fully resident/downgraded must contribute
        # exactly 0.0 stall, not a timer epsilon per layer (which drifts
        # load_stall_s upward on hit-heavy runs and pollutes the bench gate)
        todo = []
        for t in tasks:
            is_hi = t.precision == PREC_HI
            if is_hi and self.serves_lo_downgrade(t.layer, t.expert):
                continue  # issue-time downgrade: compute reads the lo copy
            if self.cache.lookup((t.layer, t.expert), is_hi) is not None:
                continue  # duplicate across batch slots / raced with prefetch
            todo.append(t)
        if not todo:
            return []
        t_start = time.perf_counter()
        entries, done = [], []
        for t in todo:
            is_hi = t.precision == PREC_HI
            key = (t.layer, t.expert)
            if self.cache.lookup(key, is_hi) is not None:
                continue  # duplicate within this very miss set
            try:
                slot, _ = self.cache.admit(key, is_hi, current_layer)
            except CacheStarvation:
                # every candidate victim is an in-flight prefetch: land them,
                # clearing their reservations, then retry
                self.wait_all()
                slot, _ = self.cache.admit(key, is_hi, current_layer)
            tc = time.perf_counter()
            buf = self._staged(t)
            self._emulate_copy(tc, t.bytes)
            entries.append((t, slot, buf))
            self.loader.loaded_bytes += t.bytes
            self.loader.n_loads[t.precision] += 1
            # on-demand copies occupy the modeled link like any other
            # transfer; without this, miss-heavy runs under-report
            # link_utilization vs the simulator's timeline
            if self.link_bps > 0:
                self._modeled_transfer_s += t.bytes / self.link_bps
                if self._t_first_issue is None:
                    self._t_first_issue = tc
            done.append((t, slot))
        if entries:
            self.commit_fn(entries)
            self._t_last_commit = time.perf_counter()
        self.stall_s += time.perf_counter() - t_start
        return done

    # ---------------- observability ----------------
    def link_utilization(self) -> float:
        """Share of the submit→last-commit window the modeled link spent
        busy (issued bytes / link_bps over the wall-clock window)."""
        if (self._t_first_issue is None or self._t_last_commit is None
                or self.link_bps <= 0):
            return 0.0
        window = self._t_last_commit - self._t_first_issue
        if window <= 0:
            return 0.0
        return min(1.0, self._modeled_transfer_s / window)

    def stats(self) -> dict:
        """JSON-serializable staging counters (see docs/METRICS.md)."""
        return {
            "load_stall_s": self.stall_s,
            "copy_s": self.copy_s,
            "overlap_s": self.overlap_s,
            "overlap_fraction": (self.overlap_s / self.copy_s
                                 if self.copy_s > 0 else 0.0),
            "prefetch_jobs": self.n_prefetch_jobs,
            "dropped_prefetch": self.n_dropped_prefetch,
            "streams": self.streams,
            "per_stream_bytes": list(self.per_stream_bytes),
            "issue_reorders": self.issue_reorders,
            "precision_downgrades": self.precision_downgrades,
            "upgrades": self.upgrades,
            "upgrade_bytes": self.upgrade_bytes,
            "served_lo_expert_steps": self.served_lo_expert_steps,
            "link_utilization": self.link_utilization(),
            "link_gbps": self.link_bps / 1e9,
        }

    def shutdown(self):
        """Release every stream's worker thread (idempotent)."""
        self._finalizer()
