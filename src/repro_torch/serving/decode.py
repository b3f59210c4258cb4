"""Serving substrate of the port: prefill and decode step builders, token
sampling and the model-level generate loop.

`make_serve_step` is one new token against a dense KV cache of length
max_len (a windowed layer's a ring of min(max_len, window) slots, an MLA
layer's a latent cache, an SSM layer's its fixed-size state, all written in
place).  ``generate(jit=True)`` runs it as a captured step
(``capture.CapturedStep``): a CUDA graph replayed per token on the card,
eager on the CPU.  ``generate``'s prefill (``make_prefill_step``) stays
eager on both: the reference builds ``jax.jit(prefill)`` anew in every
call (``src/repro/serving/decode.py:69-72``), so it compiles once per call,
and a graph that lives for one call would add its warm-up and its capture
and replay nothing.  The backends' prefill lives as long as the backend,
so ``models.prefill.DenseKVPrefill`` captures the prompt shapes that come
back.  Sampling runs on the host with a ``torch.Generator``.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.capture import CapturedStep, addresses
from repro_torch.device import to_device, to_host
from repro_torch.models.model import Batch, Model


def make_serve_step(model: Model) -> Callable:
    """serve_step(params, cache, tokens (B, 1), positions (B,)) ->
    (logits (B, V), cache).  The cache is written in place; the one passed
    in comes back (the reference donates and returns it)."""

    def serve_step(params, cache, tokens, positions):
        return model.decode_step(params, cache, tokens, positions), cache

    return serve_step


def make_prefill_step(model: Model, max_len: int) -> Callable:
    """prefill_step(params, batch: Batch) -> (last-token logits (B, V), a
    decode cache padded to max_len, next positions (B,) on the host).  A
    "vision_patches" model takes the batch's prefix embeddings in front of
    its tokens; an encoder model (Whisper) the batch's audio frames, whose
    cross keys and values land in the cache; other models ignore both, as
    the reference does."""

    def prefill_step(params, batch: Batch):
        return model.prefill(params, batch, max_len)

    return prefill_step


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


def generate(model: Model, params, prompts, new_tokens: int, *,
             max_len: Optional[int] = None, temperature: float = 0.0,
             seed: int = 0, extra: Optional[dict] = None,
             jit: bool = True) -> GenerateResult:
    """Greedy/temperature generation on the parameters' device.  prompts:
    (B, S) host array; `extra` holds further `Batch` fields (host arrays,
    copied to the parameters' device, or tensors), such as "prefix_embeds"
    (B, P, D), whose P positions the default cache length counts beside the
    prompt's, or Whisper's "audio_frames" (B, F, d_enc), whose cross keys
    and values the cache holds (a sinusoidal-position model refuses a
    max_len past its max_seq_len).  With `jit` the
    decode step is a captured step (one CUDA graph for the call on the
    card); without, every step runs eagerly."""
    prompts = np.asarray(prompts, np.int32)
    s = prompts.shape[1]
    dev = params["embed"].device
    extra = {k: v if isinstance(v, torch.Tensor) or v is None else to_device(v, dev)
             for k, v in (extra or {}).items()}
    prefix = extra.get("prefix_embeds")
    if prefix is not None and model.cfg.frontend == "vision_patches":
        s += prefix.shape[1]
    max_len = max_len or (s + new_tokens + 1)
    batch = Batch(tokens=to_device(prompts, dev),
                  loss_mask=torch.ones(prompts.shape, dtype=torch.float32, device=dev),
                  **extra)
    prefill = make_prefill_step(model, max_len)
    serve_step = make_serve_step(model)

    t0 = time.time()
    logits, cache, positions = prefill(params, batch)
    (lg,) = to_host(logits)
    t1 = time.time()

    def step(tokens, pos):
        return serve_step(params, cache, tokens, pos)[0]

    captured = CapturedStep(step, "serve_step") if jit else None
    key = addresses(buf for c in cache for buf in c.values())
    gen = torch.Generator().manual_seed(seed)
    out = [prompts]
    tok = sample_token(lg, gen, temperature)
    for i in range(new_tokens):
        out.append(tok[:, None])
        if i == new_tokens - 1:
            break
        args = (to_device(tok[:, None], dev), to_device(positions, dev))
        lg = step(*args) if captured is None else captured(*args, key=key)
        (lg,) = to_host(lg)
        positions = positions + 1
        tok = sample_token(lg, gen, temperature)
    t2 = time.time()
    return GenerateResult(np.concatenate(out, axis=1), t1 - t0, t2 - t1, new_tokens)
