"""Workload generator + SLO scheduling policy helpers.

One deterministic (seeded) trace drives BOTH the live `BatchingServer` and
the virtual-clock `core.simulator.ServingTimeline`, so scheduling policies
are searched on the deterministic timeline and the winner serves real
traffic — the same live/simulated split the staging policies use.

A trace is a list of `WorkloadRequest`s with arrival offsets, drawn from a
mix of `RequestClass`es (per-class prompt/output length distributions,
priorities and SLOs).  Arrivals are bursty Poisson: a base rate with
periodic bursts multiplying it (`burst_factor` inside every
`burst_every_s`-long cycle's first `burst_len_s`).  Classes can opt into a
shared-prefix cohort (a common system prompt prepended to their prompts)
so the prefix-sharing radix cache has something to alias.

The policy helpers (`effective_priority`, `slo_urgency`) are the ONE
definition of SLO ordering used by both the live scheduler
(`serving/batching.py`) and the simulator timeline: effective priority is
the request's static priority plus an aging credit (one priority level per
`aging_s` seconds waited), which bounds starvation — any waiting request
eventually outranks any fixed priority.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

# one priority level earned per this many seconds of queue wait: the aging
# term that makes SLO ordering starvation-free (a priority-0 request waiting
# k*AGING_S seconds outranks a fresh priority-k request)
DEFAULT_AGING_S = 10.0


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One traffic class: lengths, priority, SLOs, mix weight."""
    name: str
    weight: float = 1.0                      # mix share (relative)
    priority: int = 0                        # static priority (higher wins)
    ttft_slo_s: Optional[float] = None       # submit -> first token target
    tpot_slo_s: Optional[float] = None       # per-output-token target
    prompt_tokens: Tuple[int, int] = (16, 64)   # uniform [lo, hi)
    new_tokens: Tuple[int, int] = (8, 32)       # uniform [lo, hi)
    shared_prefix: bool = False              # prepend the cohort system prompt


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    classes: Tuple[RequestClass, ...]
    num_requests: int = 32
    arrival_rate: float = 4.0                # mean requests/s outside bursts
    burst_factor: float = 4.0                # rate multiplier inside a burst
    burst_every_s: float = 8.0               # burst cycle period
    burst_len_s: float = 2.0                 # burst duration per cycle
    shared_prefix_tokens: int = 32           # cohort system-prompt length
    vocab: int = 128
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class WorkloadRequest:
    """One generated request: arrival offset + the Request fields."""
    rid: int
    arrival_s: float
    prompt: np.ndarray                       # int32 token ids
    max_new_tokens: int
    priority: int = 0
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None
    cls: str = ""


def generate_workload(cfg: WorkloadConfig) -> List[WorkloadRequest]:
    """Deterministic bursty-Poisson trace over the configured class mix."""
    rng = np.random.default_rng(cfg.seed)
    weights = np.array([c.weight for c in cfg.classes], dtype=np.float64)
    weights /= weights.sum()
    sys_prompt = rng.integers(0, cfg.vocab, cfg.shared_prefix_tokens)
    out: List[WorkloadRequest] = []
    t = 0.0
    for rid in range(cfg.num_requests):
        # thinned Poisson arrivals: the rate is arrival_rate, multiplied by
        # burst_factor inside each cycle's first burst_len_s
        in_burst = (t % cfg.burst_every_s) < cfg.burst_len_s
        rate = cfg.arrival_rate * (cfg.burst_factor if in_burst else 1.0)
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        c = cfg.classes[int(rng.choice(len(cfg.classes), p=weights))]
        plen = int(rng.integers(*c.prompt_tokens))
        body = rng.integers(0, cfg.vocab, plen)
        prompt = (np.concatenate([sys_prompt, body]) if c.shared_prefix
                  else body).astype(np.int32)
        out.append(WorkloadRequest(
            rid=rid, arrival_s=t, prompt=prompt,
            max_new_tokens=int(rng.integers(*c.new_tokens)),
            priority=c.priority, ttft_slo_s=c.ttft_slo_s,
            tpot_slo_s=c.tpot_slo_s, cls=c.name))
    return out


def to_requests(trace: Sequence[WorkloadRequest], *, t0: float = 0.0):
    """Convert a trace into live `serving.batching.Request`s (submitted_at
    pre-set to t0 + arrival offset; `BatchingServer.submit` honors it)."""
    from repro_torch.serving.batching import Request
    return [Request(rid=w.rid, prompt=w.prompt,
                    max_new_tokens=w.max_new_tokens,
                    submitted_at=t0 + w.arrival_s, priority=w.priority,
                    ttft_slo_s=w.ttft_slo_s, tpot_slo_s=w.tpot_slo_s)
            for w in trace]


# ----------------------------------------------------------------------
# SLO ordering policy (shared by BatchingServer and ServingTimeline)

# owner: main-thread — SLO ordering runs inside the scheduler step (live
# server and virtual-clock timeline both call it from the admitting thread)
def effective_priority(priority: int, submitted_at: float, now: float,
                       aging_s: float = DEFAULT_AGING_S) -> float:
    """Static priority + aging credit (1 level per `aging_s` waited).

    The aging term is the starvation bound: a request of priority p0 that
    has waited `(p1 - p0 + m) * aging_s` outranks any fresh priority-p1
    request by margin m, so no fixed priority can hold it back forever.
    """
    return float(priority) + max(0.0, now - submitted_at) / aging_s


# owner: main-thread
def slo_urgency(priority: int, submitted_at: float,
                ttft_slo_s: Optional[float], now: float,
                aging_s: float = DEFAULT_AGING_S) -> Tuple[float, float]:
    """Sort key for admission: most urgent first under ascending sort.

    Primary: -effective_priority (higher effective priority first).
    Secondary: TTFT deadline slack (requests closest to — or furthest
    past — their deadline first; no-SLO requests order by age).
    """
    slack = ((submitted_at + ttft_slo_s - now) if ttft_slo_s is not None
             else 1e12 + submitted_at - now)  # no deadline: after SLO peers,
    #                                           oldest first among themselves
    return (-effective_priority(priority, submitted_at, now, aging_s), slack)
