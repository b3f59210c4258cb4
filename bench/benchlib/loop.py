"""The closed loop of clients around ``BatchingServer.run`` and what it
records.

``Probe`` wraps the backend that the server drives: it times each
``step``, ``join_step`` and ``stats`` call (host spans), notes at each
``join_begin`` how much of the prompt the prefix cache already held, stamps
every output token with its time and request, and hands each call's entry
to the loop, which decides the phases by the clock: warm-up (the warm-up
wave, then the mix's traffic until ``warmup_s`` and ``warmup_decode_steps``
are met), the measured window of ``seconds`` from the first call after
that, and the drain.  When a request's slot is released its client submits the next
request at once (no think time), stamped as submitted when the reply it
waited for completed.  When the window has closed no new request is
submitted and every request in flight is cut to the tokens it has, so the
server drains within a step or a few prefill chunks.

Warm-up and window run in one ``BatchingServer.run()``: its
``start_batch`` resets the expert cache's sequence records and the graphs,
so a second call would start cold.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from benchlib.traffic import Job

now = time.perf_counter


def counters(s: dict) -> Dict[str, float]:
    """The engine counters the metrics read, from one ``stats()`` dict."""
    def pairs(key):
        hist = (s.get(key) or {}).get("hist", {})
        return float(sum(int(v) * int(c) for v, c in hist.items()))
    cache = s.get("cache", {})
    return {"hits": float(cache.get("hits", 0)), "misses": float(cache.get("misses", 0)),
            "loaded_bytes": float(s.get("loaded_bytes", 0)),
            "load_stall_s": float(s.get("load_stall_s", 0.0)),
            "hi_pairs": pairs("hi_pairs_per_launch"), "lo_pairs": pairs("lo_pairs_per_launch"),
            "skips": float(s.get("skips", 0)),
            "served_lo": float(s.get("served_lo_expert_steps", 0)),
            "downgrades": float(s.get("precision_downgrades", 0))}


@dataclasses.dataclass
class Record:
    """Everything a run measured; the metric readers take it.  `spec` and
    `block` are the configuration's (``bench/blocks/``): the FLOP counts
    are ``block.token_flops`` / ``chunk_flops`` on `spec`."""
    spec: dict
    t_start: float
    block: object = None
    w0: Optional[float] = None
    w1: Optional[float] = None
    spans: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    stamps: Dict[int, List[float]] = dataclasses.field(default_factory=dict)
    submits: Dict[int, float] = dataclasses.field(default_factory=dict)
    prompt_len: Dict[int, int] = dataclasses.field(default_factory=dict)
    warm: Set[int] = dataclasses.field(default_factory=set)
    # decode steps: (t0, t1, [(rid, keys attended by the token fed)])
    steps: List[Tuple[float, float, list]] = dataclasses.field(default_factory=list)
    # join_step calls: (t0, t1, [(rid, first position, tokens prefilled)])
    joins: List[Tuple[float, float, list]] = dataclasses.field(default_factory=list)
    stats: List[Tuple[float, Dict[str, float]]] = dataclasses.field(default_factory=list)
    failed: Set[int] = dataclasses.field(default_factory=set)
    # the logits each output token was sampled from, per request
    logits: Dict[int, List[np.ndarray]] = dataclasses.field(default_factory=dict)
    excluded: Optional[Tuple[float, float]] = None   # profiler start .. stop
    trace: object = None                             # devtrace.TraceData

    # ---- helpers the readers share ----
    def in_window(self, t: float) -> bool:
        return self.w0 <= t <= self.w1

    def host_ok(self, a: float, b: float) -> bool:
        """False for a span that overlaps the profiler's start or stop."""
        return self.excluded is None or b < self.excluded[0] or a > self.excluded[1]

    def window_steps(self):
        return [s for s in self.steps if self.in_window(s[1])]

    def window_joins(self):
        return [j for j in self.joins if self.in_window(j[1])]

    def stats_before(self, t: float) -> Tuple[float, Dict[str, float]]:
        """The last counters read at or before t (the first read if none)."""
        best = self.stats[0]
        for entry in self.stats:
            if entry[0] > t:
                break
            best = entry
        return best

    def stats_after(self, t: float) -> Tuple[float, Dict[str, float]]:
        for entry in self.stats:
            if entry[0] >= t:
                return entry
        return self.stats[-1]

    def tokens_between(self, a: float, b: float) -> int:
        return sum(1 for ts in self.stamps.values() for t in ts if a < t <= b)


class ClosedLoop:
    """Clients, phases and the record of one run (module docstring)."""

    def __init__(self, server, mix: dict, jobs, *, seconds: float, chunk: int, spec: dict,
                 block, t_start: float, tracer=None):
        from repro_torch.serving.batching import Request
        self._request = Request
        self.server = server
        self.mix = mix
        self.jobs = jobs
        self.seconds = float(seconds)
        self.chunk = int(chunk)
        self.tracer = tracer
        self.rec = Record(spec=spec, t_start=t_start, block=block)
        self.req: Dict[int, object] = {}
        self.client: Dict[int, int] = {}
        self.slot_rid: Dict[int, int] = {}
        self.rid_slot: Dict[int, int] = {}
        self.count: Dict[int, int] = {}
        self.fed: Dict[int, int] = {}
        self.matched: Dict[int, int] = {}   # slot -> prompt tokens the prefix cache held
        self.admitting: List[int] = []
        self.active: Set[int] = set()
        self.wave_left: Set[int] = set()
        self.decode_steps = 0
        self.closed = False
        self._events = 0
        self._t_run = None

    # ---- clients ----
    def submit(self, job: Job, client: int, t: float) -> None:
        r = self._request(rid=job.rid, prompt=job.prompt, max_new_tokens=job.max_new_tokens,
                          submitted_at=time.time())
        self.req[job.rid] = r
        self.client[job.rid] = client
        self.rec.submits[job.rid] = t
        self.rec.prompt_len[job.rid] = len(job.prompt)
        self.rec.stamps[job.rid] = []
        self.rec.logits[job.rid] = []
        if job.warm:
            self.rec.warm.add(job.rid)
            self.wave_left.add(job.rid)
        self.server.submit(r)

    def start(self, wave: List[Job]) -> None:
        t = now()
        for i, job in enumerate(wave):
            self.submit(job, i % self.mix["clients"], t)
        for c in range(len(wave), self.mix["clients"]):
            self.submit(next(self.jobs), c, t)

    # ---- phases ----
    def _sync_admits(self) -> None:
        events = self.server.events
        while self._events < len(events):
            kind, slot, rid, _ = events[self._events]
            self._events += 1
            if kind == "admit":
                self.slot_rid[slot] = rid
                self.rid_slot[rid] = slot
                # the chunked prefill starts feeding at the matched prefix,
                # re-feeding the last token of a prompt matched whole
                self.fed[rid] = min(self.matched.pop(slot, 0), self.rec.prompt_len[rid] - 1)
                self.count[rid] = 0
                self.admitting.append(rid)

    def tick(self) -> None:
        t = now()
        if self._t_run is None:
            self._t_run = t
        rec = self.rec
        if rec.w0 is None:
            if (not self.wave_left and t - self._t_run >= self.mix["warmup_s"]
                    and self.decode_steps >= self.mix["warmup_decode_steps"]):
                rec.w0, rec.w1 = t, t + self.seconds
        elif not self.closed and t >= rec.w1:
            self.close()
        if self.tracer is not None:
            self.tracer.tick(t, rec.w0, self.closed)

    def close(self) -> None:
        """End of the window: no new request; cut those in flight."""
        self.closed = True
        for rid in self.admitting + sorted(self.active):
            self.req[rid].max_new_tokens = max(self.count.get(rid, 0), 1)
        self.server.queue.clear()

    def stepping(self) -> List[int]:
        return [rid for rid in sorted(self.active, key=self.rid_slot.__getitem__)
                if self.count[rid] < self.req[rid].max_new_tokens]

    # ---- probe callbacks ----
    def on_join(self, t0: float, t1: float, done: dict, pending: List[int]) -> None:
        """A request the call finished was fed the rest of its prompt from
        where its admission started feeding (the last chunk under paged KV,
        the whole prompt in the dense-KV one-shot prefill); one still
        pending, one chunk."""
        finished = {self.slot_rid[slot] for slot in done}
        entries = []
        for rid in pending:
            plen = self.rec.prompt_len[rid]
            n = plen - self.fed[rid] if rid in finished else min(self.chunk, plen - self.fed[rid])
            entries.append((rid, self.fed[rid], n))
            self.fed[rid] += n
        self.rec.joins.append((t0, t1, entries))
        for slot, lg in done.items():
            rid = self.slot_rid[slot]
            self.admitting.remove(rid)
            self.active.add(rid)
            self.count[rid] = 1
            self.rec.stamps[rid].append(t1)
            self.rec.logits[rid].append(np.array(lg, np.float32, copy=True))
            if not np.isfinite(lg).all():
                self.rec.failed.add(rid)

    def on_step(self, t0: float, t1: float, logits, stepping: List[int]) -> None:
        entries = []
        for rid in stepping:
            entries.append((rid, self.rec.prompt_len[rid] + self.count[rid]))
            self.count[rid] += 1
            self.rec.stamps[rid].append(t1)
            self.rec.logits[rid].append(np.array(logits[self.rid_slot[rid]], np.float32))
            if not np.isfinite(logits[self.rid_slot[rid]]).all():
                self.rec.failed.add(rid)
        self.rec.steps.append((t0, t1, entries))
        if not self.wave_left:
            self.decode_steps += 1

    def on_release(self, slot: int) -> None:
        rid = self.slot_rid.pop(slot, None)
        if rid is None:                 # run() releases every slot first
            return
        self.active.discard(rid)
        self.wave_left.discard(rid)
        if not self.closed:
            stamps = self.rec.stamps[rid]
            self.submit(next(self.jobs), self.client[rid], stamps[-1] if stamps else now())


class Probe:
    """The backend the server drives: the real one, timed (module docstring)."""

    def __init__(self, inner, loop: ClosedLoop):
        self.inner = inner
        self.loop = loop
        self.model = inner.model

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self, tokens):
        stepping = self.loop.stepping()
        self.loop.tick()
        t0 = now()
        lg = self.inner.step(tokens)        # logits on the host: the step is done
        t1 = now()
        self.loop.rec.spans.append(("step", t0, t1))
        self.loop.on_step(t0, t1, lg, stepping)
        return lg

    def join_begin(self, slot, prompt, reserve_tokens=None):
        """Note how much of the prompt the page pool's prefix cache matched
        (its ``prefix_hit_tokens`` grows by that; no pool: none)."""
        kv = getattr(self.inner, "kv", None)
        hit = kv.prefix_hit_tokens if kv is not None else 0
        self.inner.join_begin(slot, prompt, reserve_tokens=reserve_tokens)
        self.loop.matched[slot] = kv.prefix_hit_tokens - hit if kv is not None else 0

    def join_step(self):
        self.loop._sync_admits()
        pending = list(self.loop.admitting)
        self.loop.tick()
        t0 = now()
        done = self.inner.join_step()
        t1 = now()
        self.loop.rec.spans.append(("join_step", t0, t1))
        self.loop.on_join(t0, t1, done, pending)
        return done

    def stats(self):
        t0 = now()
        s = self.inner.stats()
        t1 = now()
        self.loop.rec.spans.append(("stats", t0, t1))
        self.loop.rec.stats.append((t1, counters(s)))
        return s

    def release(self, slot):
        self.inner.release(slot)
        self.loop.on_release(slot)


def time_sampling(server, rec: Record) -> None:
    """Record the server's token sampling as "sample" spans."""
    inner = server._sample

    def sample(logits):
        t0 = now()
        out = inner(logits)
        rec.spans.append(("sample", t0, now()))
        return out

    server._sample = sample
