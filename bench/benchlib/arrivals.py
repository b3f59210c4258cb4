"""Frozen copy of the program's bursty-Poisson trace generator
(``repro_torch/serving/workload.py``: ``RequestClass``, ``WorkloadConfig``,
``WorkloadRequest``, ``generate_workload``), kept with the benchmark for
open-loop cells, so that a later change to the program cannot change the
traffic they are measured on.  No cell uses it while
``BatchingServer.run`` admits every queued request at once, whatever its
arrival time."""

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
