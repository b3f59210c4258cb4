"""The general generator of closed-loop traffic, driven by a mix file
(``bench/traffic/<mix>.json``).

Lengths are stratified: each block of ``strata`` requests holds the same
prompt lengths (the midpoints of ``strata`` equal slices of the
``prompt_len`` range) and the same output lengths (likewise over
``output_len``), paired and ordered afresh per block from the seed.  So any
whole number of blocks holds the same sizes whatever the seed, and a seed
changes the order and the token ids only.  Token ids are uniform over the
vocabulary: no prompt shares a prefix with another.

Before the traffic, a warm-up wave of ``max_batch`` requests with prompts
of 1, 2, ..., ``max_batch`` prefill chunks admits them together, so the
chunked prefill runs with every count of pending rows from ``max_batch``
down to 1 (the shapes its captured graphs are keyed by) before the window.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np


@dataclasses.dataclass
class Job:
    rid: int
    prompt: np.ndarray          # int32 token ids
    max_new_tokens: int
    warm: bool = False


def check_mix(mix: dict) -> None:
    if mix.get("loop") != "closed":
        raise ValueError(f"loop {mix.get('loop')!r}: only closed loops are generated "
                         "(BatchingServer.run admits every queued request at once)")
    if mix["clients"] > mix["max_batch"]:
        raise ValueError("more clients than slots would queue requests in a closed loop")
    if mix["think_s"] != 0 or mix["temperature"] != 0:
        raise ValueError("think time and sampled tokens are not generated: the check "
                         "compares greedy tokens")


def strata(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths at the midpoints of n equal slices of [lo, hi]."""
    return np.rint(lo + (hi - lo) * (np.arange(n) + 0.5) / n).astype(np.int64)


def warmup_wave(mix: dict, vocab: int, chunk: int, rng: np.random.Generator) -> List[Job]:
    out_len = min(2, mix["output_len"][1])
    return [Job(rid=-(i + 1), prompt=rng.integers(0, vocab, chunk * (i + 1)).astype(np.int32),
                max_new_tokens=out_len, warm=True)
            for i in range(mix["max_batch"])]


def jobs(mix: dict, vocab: int, rng: np.random.Generator) -> Iterator[Job]:
    """The endless stream of the mix's requests, rid 0, 1, ..."""
    n = mix["strata"]
    plens = strata(*mix["prompt_len"], n)
    olens = strata(*mix["output_len"], n)
    rid = 0
    while True:
        pairing = rng.permutation(n)
        for i in rng.permutation(n):
            yield Job(rid=rid, prompt=rng.integers(0, vocab, plens[i]).astype(np.int32),
                      max_new_tokens=int(olens[pairing[i]]))
            rid += 1


def max_len(mix: dict, chunk: int, page: int) -> int:
    """KV length every slot reserves: the longest prompt (the warm-up wave's
    included) plus the longest output and one, rounded up to whole pages."""
    need = max(mix["prompt_len"][1], chunk * mix["max_batch"]) + mix["output_len"][1] + 1
    return -(-need // page) * page
