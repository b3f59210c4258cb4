"""Token sampling and the generation result record."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


def sample_token(logits, gen: Optional[torch.Generator] = None,
                 temperature: float = 0.0, top_k: int = 0) -> np.ndarray:
    """logits (B, V) host array -> (B,) int32 tokens.  Greedy at
    temperature 0 (first maximal index, as jnp.argmax); otherwise a draw
    from the tempered softmax (top_k > 0 keeps the k largest logits)."""
    lg = np.asarray(logits, np.float32)
    if temperature <= 0.0:
        return np.argmax(lg, axis=-1).astype(np.int32)
    t = torch.from_numpy(lg / temperature)
    if top_k:
        kth = torch.topk(t, top_k, dim=-1).values[:, -1:]
        t = torch.where(t < kth, torch.full_like(t, -1e30), t)
    probs = torch.softmax(t, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].numpy().astype(np.int32)


class GenerateResult(NamedTuple):
    tokens: np.ndarray          # (B, prompt+new)
    prefill_s: float
    decode_s: float
    steps: int

    @property
    def decode_tok_s(self) -> float:
        return self.tokens.shape[0] * self.steps / max(self.decode_s, 1e-9)
