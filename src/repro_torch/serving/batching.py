"""Continuous batching for the serving path, backend-agnostic.

The scheduler owns `max_batch` slots on an `InferenceBackend` (dense or
HOBBIT-offload — identical code path).  Admission is SLO-aware by default
(`policy="slo"`): the queue is ordered by `serving.workload.slo_urgency`
(effective priority = static priority + aging credit, tie-broken by TTFT
deadline slack), which degrades to FIFO when requests carry no
priority/SLO metadata; `policy="fifo"` forces strict arrival order.  When
the most urgent queued request cannot be admitted (no free slot or no KV
headroom) and it outranks the least urgent decoding request by more than
`preempt_margin` effective-priority levels, the scheduler *preempts*: the
victim's KV state is snapshotted to host (`backend.pause`), its slot and
pages are freed, and it is requeued with its decode progress intact — it
resumes later via `backend.resume` without re-prefilling.  Aging bounds
starvation (any waiting request eventually outranks any fixed priority).

Admission is *chunked and batched*: up to `admit_k` queued requests are in
admission concurrently, and one `backend.join_step()` call per scheduler
iteration advances ALL of them by one prefill chunk (one shared jitted
call on paged backends) before the next decode step runs — so a long
prompt prefills in fixed-size chunks interleaved with decode steps and
never stalls in-flight decodes.  On completion a request `release`s its
slot (returning its KV pages to the pool on paged backends) and the next
queued request joins at the very next step — no bucketing by prompt length
and no waiting for batch-mates to finish.

Admission is KV-aware: a request is only admitted when
`backend.can_admit(prompt + max_new_tokens + 1)` says the pool can hold its
*whole* lifetime (the backend reserves that budget at `join_begin`), so a
paged pool can never starve an in-flight decode; when the pool is full the
request simply waits in the queue for a retirement to free pages — that
wait is reported as `admission_wait_s`.

Per-request latency is split into queue wait / prefill / decode so the
reported `decode_tok_s` measures decode steps only (queue wait and prefill
are reported separately).  See docs/METRICS.md for every stats() field.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.kv_pages import PagePoolExhausted
from repro_torch.models.model import Model
from repro_torch.serving.api import DenseBackend, InferenceBackend
from repro_torch.serving.decode import sample_token
from repro_torch.serving.workload import (DEFAULT_AGING_S, effective_priority,
                                          slo_urgency)
from repro_torch.spans import span


@dataclasses.dataclass
class Request:
    """One generation request and, after completion, its latency breakdown."""
    rid: int
    prompt: np.ndarray              # (S,)
    max_new_tokens: int
    submitted_at: float = 0.0
    # SLO metadata (all optional — a metadata-free request behaves FIFO):
    priority: int = 0               # static class priority (higher wins)
    ttft_slo_s: Optional[float] = None   # submit -> first token target
    tpot_slo_s: Optional[float] = None   # per-output-token decode target
    # filled on completion:
    output: Optional[np.ndarray] = None
    queue_wait_s: float = 0.0       # submit -> admission started (slot+KV)
    admission_wait_s: float = 0.0   # submit -> prefill complete (first token)
    prefill_latency_s: float = 0.0  # this request's own (chunked) prefill
    decode_s: float = 0.0           # wall time of decode steps it rode in
    load_stall_s: float = 0.0       # share of expert-load stall in its steps
    precision_downgrades: float = 0.0   # share of issue-time hi->lo downgrades
    served_lo: float = 0.0          # share of lo-for-hi expert-steps in its
    #                                 steps (accuracy-exposure proxy; decays
    #                                 to 0 once upgrades land hi re-copies)
    total_latency_s: float = 0.0


class BatchingServer:
    """Slot-based continuous batching over any `InferenceBackend`.

    `admit_k` bounds how many requests prefill concurrently (they share one
    jitted chunk call per iteration on paged backends).  Accepts either a
    backend, or `(model, params)` for the common dense case (kept for
    backwards compatibility with the original server)."""

    def __init__(self, backend_or_model, params=None, *, max_batch: int = 8,
                 max_len: int = 512, temperature: float = 0.0, seed: int = 0,
                 admit_k: int = 4, policy: str = "slo",
                 aging_s: float = DEFAULT_AGING_S,
                 preempt_margin: float = 1.0):
        """policy: "slo" (urgency-ordered admission + preemption; degrades
        to FIFO when requests carry no priority/SLO metadata) or "fifo"
        (strict arrival order, never preempts).  aging_s / preempt_margin
        parameterize `serving.workload.effective_priority`."""
        if isinstance(backend_or_model, Model):
            backend: InferenceBackend = DenseBackend(backend_or_model, params)
        else:
            backend = backend_or_model
        assert policy in ("slo", "fifo"), policy
        self.backend = backend
        self.max_batch = max_batch
        self.max_len = max_len
        self.temperature = temperature
        self.admit_k = admit_k
        self.policy = policy
        self.aging_s = float(aging_s)
        self.preempt_margin = float(preempt_margin)
        self.gen = torch.Generator().manual_seed(seed)
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        # scheduler event log: (event, slot, rid, step_index) — lets tests
        # and operators confirm mid-flight admissions/retirements ("admit" =
        # chunked prefill started, "join" = prefill complete, slot decoding;
        # "preempt"/"resume" bracket a pause/resume preemption)
        self.events: List[Tuple[str, int, int, int]] = []
        self.preemptions = 0
        self._step_time_s = 0.0
        self._step_tokens = 0
        self._occupancy_sum = 0         # Σ per-step live slots (decode+admit)
        self._steps = 0
        self._closed = False
        self._last_backend_stats: Optional[dict] = None

    def submit(self, req: Request):
        """Queue a request.  A pre-set `submitted_at` (a workload trace's
        arrival offset) is honored; 0.0 means "now"."""
        if req.submitted_at == 0.0:
            req.submitted_at = time.time()
        self.queue.append(req)

    # ------------------------------------------------------------------
    def _sample(self, logits) -> np.ndarray:
        return sample_token(logits, self.gen, self.temperature)

    def run(self):
        """Serve until queue, admissions and in-flight slots are drained."""
        if not self.queue:
            return
        self.backend.start_batch(self.max_batch, self.max_len)
        free = list(range(self.max_batch))
        for slot in free:           # slots are inactive until a request joins
            self.backend.release(slot)
        active: Dict[int, Request] = {}
        admitting: Dict[int, Request] = {}
        admit_t0: Dict[int, float] = {}
        outs: Dict[int, List[int]] = {}
        pending_tok: Dict[int, int] = {}
        step_idx = 0
        stats0 = self.backend.stats()
        last_stall = stats0.get("load_stall_s", 0.0)
        last_downgrades = stats0.get("precision_downgrades", 0)
        last_served_lo = stats0.get("served_lo_expert_steps", 0)

        def retire(slot: int):
            req = active.pop(slot)
            req.output = np.asarray(outs.pop(slot), np.int32)
            req.total_latency_s = time.time() - req.submitted_at
            pending_tok.pop(slot, None)
            self.backend.release(slot)
            self.completed.append(req)
            self.events.append(("retire", slot, req.rid, step_idx))
            free.append(slot)

        def order_queue():
            """SLO policy: most urgent first (degenerates to FIFO without
            priority/SLO metadata — urgency then orders purely by age)."""
            if self.policy == "slo" and len(self.queue) > 1:
                now = time.time()
                self.queue.sort(key=lambda r: slo_urgency(
                    r.priority, r.submitted_at, r.ttft_slo_s, now,
                    self.aging_s))

        def try_preempt() -> bool:
            """Preempt-and-requeue: pause the least-urgent decoding victim
            when the most urgent queued request cannot be admitted and
            outranks it by more than preempt_margin effective-priority
            levels.  Returns True when a slot+pages were freed."""
            if self.policy != "slo" or not self.queue or not active:
                return False
            req = self.queue[0]
            now = time.time()
            eff = lambda r: effective_priority(  # noqa: E731
                r.priority, r.submitted_at, now, self.aging_s)
            victim_slot = min(active, key=lambda s: eff(active[s]))
            vreq = active[victim_slot]
            if eff(vreq) + self.preempt_margin >= eff(req):
                return False
            snap = self.backend.pause(victim_slot)
            active.pop(victim_slot)
            vreq._paused = {"snapshot": snap,           # type: ignore[attr-defined]
                            "outs": outs.pop(victim_slot),
                            "pending_tok": pending_tok.pop(victim_slot)}
            self.queue.append(vreq)
            free.append(victim_slot)
            self.preemptions += 1
            self.events.append(("preempt", victim_slot, vreq.rid, step_idx))
            return True

        while self.queue or active or admitting:
            with span("sched.iter"):
                # finished requests free their slots before the next step
                for slot in [s for s, r in active.items()
                             if len(outs[s]) >= r.max_new_tokens]:
                    retire(slot)
                # admission: up to admit_k queued requests prefill concurrently,
                # each gated on KV capacity for its whole lifetime.  At most one
                # preemption per scheduler iteration keeps the pause path from
                # thrashing the batch.
                order_queue()
                if self.queue and len(admitting) < self.admit_k:
                    req = self.queue[0]
                    need = len(req.prompt) + req.max_new_tokens + 1
                    blocked = not free or not self.backend.can_admit(
                        need, prompt=None if getattr(req, "_paused", None)
                        else req.prompt)
                    if blocked:
                        try_preempt()       # at most one pause per iteration
                while free and self.queue and len(admitting) < self.admit_k:
                    req = self.queue[0]
                    need = len(req.prompt) + req.max_new_tokens + 1
                    paused = getattr(req, "_paused", None)
                    # the prompt rides along so paged backends can price the
                    # request net of prefix sharing (aliased prefix = free);
                    # a resuming request restores private pages, so no prompt
                    if not self.backend.can_admit(
                            need, prompt=None if paused else req.prompt):
                        if not active and not admitting:
                            # nothing in flight can ever free capacity for it
                            raise RuntimeError(
                                f"request rid={req.rid} needs {need} KV tokens "
                                "but the drained pool cannot hold it; grow "
                                "kv_pages / max_len or shrink the request")
                        break               # wait for a retirement to free pages
                    self.queue.pop(0)
                    slot = free.pop(0)
                    t0 = time.time()
                    with span("sched.admit") as sp:
                        if sp.on:
                            sp.attrs["rids"] = [req.rid]
                        if paused is not None:
                            # resume a preempted victim: KV restored from its
                            # host snapshot, decode continues where it left
                            # off.  The snapshot may need more pages than
                            # can_admit priced (aliased prefix pages were
                            # copied out private), so a failed restore
                            # requeues the victim
                            try:
                                self.backend.resume(slot, paused["snapshot"])
                            except PagePoolExhausted:
                                self.queue.insert(0, req)
                                free.insert(0, slot)
                                break       # wait for a retirement to free pages
                            req._paused = None  # type: ignore[attr-defined]
                            active[slot] = req
                            outs[slot] = paused["outs"]
                            pending_tok[slot] = paused["pending_tok"]
                            self.events.append(("resume", slot, req.rid, step_idx))
                            continue
                        req.queue_wait_s = t0 - req.submitted_at
                        self.backend.join_begin(slot, np.asarray(req.prompt, np.int32),
                                                reserve_tokens=need)
                        admitting[slot] = req
                        admit_t0[slot] = t0
                        self.events.append(("admit", slot, req.rid, step_idx))
                # one shared call advances every in-progress admission one chunk
                if admitting:
                    with span("sched.join") as sp:
                        if sp.on:
                            sp.attrs["rids"] = [r.rid for r in admitting.values()]
                        done = self.backend.join_step()
                    now = time.time()
                    for slot, logits in done.items():
                        req = admitting.pop(slot)
                        req.prefill_latency_s = now - admit_t0.pop(slot)
                        req.admission_wait_s = now - req.submitted_at
                        with span("sched.sample"):
                            tok = int(self._sample(logits[None])[0])
                        active[slot] = req
                        outs[slot] = [tok][: req.max_new_tokens]
                        pending_tok[slot] = tok
                        self.events.append(("join", slot, req.rid, step_idx))
                stepping = [s for s, r in active.items()
                            if len(outs[s]) < r.max_new_tokens]
                if not stepping:
                    continue
                tokens = np.zeros((self.max_batch,), np.int32)
                for slot in stepping:
                    tokens[slot] = pending_tok[slot]
                t0 = time.time()
                with span("sched.step") as sp:
                    logits = self.backend.step(tokens)
                dt = time.time() - t0
                if sp.on:
                    sp.attrs["rids"] = [active[s].rid for s in stepping]
                # expert-load stall and issue-time precision downgrades accrued
                # this step, split across the requests that rode in it (offload
                # backends only; dense reports 0)
                with span("sched.stats"):
                    step_stats = self.backend.stats()
                now_stall = step_stats.get("load_stall_s", 0.0)
                stall = (now_stall - last_stall) / len(stepping)
                last_stall = now_stall
                now_dg = step_stats.get("precision_downgrades", 0)
                downgrades = (now_dg - last_downgrades) / len(stepping)
                last_downgrades = now_dg
                now_sl = step_stats.get("served_lo_expert_steps", 0)
                served_lo = (now_sl - last_served_lo) / len(stepping)
                last_served_lo = now_sl
                with span("sched.sample"):
                    nxt = self._sample(logits)
                for slot in stepping:
                    active[slot].decode_s += dt
                    active[slot].load_stall_s += stall
                    active[slot].precision_downgrades += downgrades
                    active[slot].served_lo += served_lo
                    outs[slot].append(int(nxt[slot]))
                    pending_tok[slot] = int(nxt[slot])
                self._step_time_s += dt
                self._step_tokens += len(stepping)
                self._occupancy_sum += len(stepping) + len(admitting)
                self._steps += 1
                step_idx += 1

    # ------------------------------------------------------------------
    def close(self):
        """Scheduler teardown: snapshot the backend's final stats (so
        `stats()` keeps working after close instead of raising on a closed
        backend), then close the backend so offload backends always release
        their staging worker threads.  Idempotent (backend close is); a
        closed server must not be run() again."""
        if not self._closed:
            try:
                self._last_backend_stats = self.backend.stats()
            except Exception:
                self._last_backend_stats = self._last_backend_stats or {}
            self._closed = True
        close = getattr(self.backend, "close", None)
        if close is not None:
            close()

    def __enter__(self):
        """Context-manager support: `with BatchingServer(...) as srv:`."""
        return self

    def __exit__(self, *exc):
        """Always close the backend on scope exit, error or not."""
        self.close()
        return False

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Aggregate serving metrics over completed requests (see
        docs/METRICS.md for the full glossary)."""
        if not self.completed:
            return {}
        done = self.completed
        # after close() the backend's staging threads are gone: serve the
        # snapshot taken at close instead of raising
        backend_stats = (self._last_backend_stats if self._closed
                         else self.backend.stats()) or {}
        declared = [r for r in done
                    if r.ttft_slo_s is not None or r.tpot_slo_s is not None]

        def met(r: Request) -> bool:
            ok = True
            if r.ttft_slo_s is not None:
                ok = r.admission_wait_s <= r.ttft_slo_s
            if ok and r.tpot_slo_s is not None and r.output is not None \
                    and len(r.output) > 1:
                ok = r.decode_s / (len(r.output) - 1) <= r.tpot_slo_s
            return ok

        return {
            "requests": len(done),
            "mean_queue_wait_s": float(np.mean([r.queue_wait_s for r in done])),
            "admission_wait_s": float(np.mean([r.admission_wait_s
                                               for r in done])),
            "mean_prefill_s": float(np.mean([r.prefill_latency_s for r in done])),
            "mean_decode_s": float(np.mean([r.decode_s for r in done])),
            "mean_load_stall_s": float(np.mean([r.load_stall_s for r in done])),
            # issue-time hi->lo downgrades attributed to the requests that
            # rode in the steps where the staging engine made them
            "mean_precision_downgrades": float(np.mean(
                [r.precision_downgrades for r in done])),
            # lo-for-hi expert-steps attributed to the requests that rode in
            # them: each request's accuracy exposure to downgrade
            # substitution (decays toward 0 while idle-link upgrades land)
            "mean_served_lo": float(np.mean([r.served_lo for r in done])),
            "precision_downgrades": backend_stats.get(
                "precision_downgrades", 0),
            "issue_reorders": backend_stats.get("issue_reorders", 0),
            "upgrades": backend_stats.get("upgrades", 0),
            "upgrade_bytes": backend_stats.get("upgrade_bytes", 0),
            "served_lo_expert_steps": backend_stats.get(
                "served_lo_expert_steps", 0),
            "link_utilization": backend_stats.get("link_utilization", 0.0),
            "mean_total_s": float(np.mean([r.total_latency_s for r in done])),
            # SLO scheduling outcomes: attainment over requests declaring a
            # TTFT/TPOT target (1.0 when none do), tail first-token latency,
            # and pause/resume preemptions fired by the SLO policy
            "slo_attainment": ((sum(met(r) for r in declared) / len(declared))
                               if declared else 1.0),
            "p99_ttft_s": float(np.percentile(
                [r.admission_wait_s for r in done], 99)),
            "preemptions": self.preemptions,
            # decode throughput over decode-step wall time only (queue wait
            # and prefill are reported separately above)
            "decode_tok_s": self._step_tokens / max(self._step_time_s, 1e-9),
            # mean live slots per decode step (decoding + admitting): the
            # paged-vs-dense occupancy metric of benchmarks/decode_speedup
            "mean_occupancy": (self._occupancy_sum / self._steps
                               if self._steps else 0.0),
            "overlap_fraction": backend_stats.get("overlap_fraction", 0.0),
            "kv_page_fraction": backend_stats.get("kv_page_fraction", 0.0),
            "backend": backend_stats,
        }
