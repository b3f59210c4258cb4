"""Synthetic-but-structured data pipeline of the port.

Deterministic, seedable, shardable token streams with enough statistical
structure (Zipfian unigrams + order-1 Markov states + repeated motifs) that
a small LM measurably learns, expert routers develop preferences (which
HOBBIT's cache exploits) and quantization-accuracy experiments have a
non-degenerate signal.  The streams are drawn with numpy exactly as the JAX
package draws them, so a seed gives the same tokens in both; batches carry
torch tensors on the device the caller names (the card by default).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Batch


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_prob: float = 0.35        # probability a motif is replayed
    n_motifs: int = 64
    markov_states: int = 128


class SyntheticLM:
    """Order-1 Markov over a state space + Zipf emission + motif replay."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Zipfian unigram over vocab
        ranks = np.arange(1, v + 1)
        self.unigram = (1.0 / ranks ** cfg.zipf_a)
        self.unigram /= self.unigram.sum()
        # sparse markov transition: each state prefers a small token subset
        s = cfg.markov_states
        self.state_tokens = rng.choice(v, size=(s, 16), p=self.unigram)
        self.token_state = rng.integers(0, s, size=v)
        # motifs: fixed short token strings occasionally replayed verbatim
        self.motifs = rng.choice(v, size=(cfg.n_motifs, cfg.motif_len), p=self.unigram)

    def sample_tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n, np.int64)
        state = rng.integers(0, self.cfg.markov_states)
        i = 0
        while i < n:
            if rng.random() < self.cfg.motif_prob:
                m = self.motifs[rng.integers(0, self.cfg.n_motifs)]
                take = min(len(m), n - i)
                out[i : i + take] = m[:take]
                i += take
                if i < n:
                    state = self.token_state[out[i - 1]]
                continue
            cand = self.state_tokens[state]
            out[i] = cand[rng.integers(0, len(cand))]
            state = self.token_state[out[i]]
            i += 1
        return out


def batches(cfg: DataConfig, *, host_id: int = 0, num_hosts: int = 1,
            start_step: int = 0, device: DeviceLike = "cuda") -> Iterator[Batch]:
    """Infinite deterministic batch stream; disjoint across hosts; resumable
    by step (checkpoint restart contract).  tokens (B, S) int32, loss_mask
    (B, S) float32, on `device`."""
    dev = resolve_device(device)
    gen = SyntheticLM(cfg)
    per_host = cfg.batch_size // num_hosts
    if per_host * num_hosts != cfg.batch_size:
        raise ValueError(f"batch_size {cfg.batch_size} does not split over {num_hosts} hosts")
    step = start_step
    while True:
        toks = np.empty((per_host, cfg.seq_len), np.int32)
        for b in range(per_host):
            rng = np.random.default_rng((cfg.seed, step, host_id * per_host + b))
            toks[b] = gen.sample_tokens(rng, cfg.seq_len)
        yield Batch(tokens=torch.from_numpy(toks).to(dev),
                    loss_mask=torch.ones((per_host, cfg.seq_len), dtype=torch.float32,
                                         device=dev))
        step += 1


def eval_batches(cfg: DataConfig, n: int, *, seed_offset: int = 10_000,
                 device: DeviceLike = "cuda"):
    """Finite held-out set (disjoint seeds from the train stream)."""
    c2 = dataclasses.replace(cfg, seed=cfg.seed + seed_offset)
    it = batches(c2, device=device)
    return [next(it) for _ in range(n)]


def unigram_entropy(cfg: DataConfig) -> float:
    gen = SyntheticLM(cfg)
    p = gen.unigram
    return float(-(p * np.log(p)).sum())
