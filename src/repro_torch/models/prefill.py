"""The one-shot prefill into a persistent dense decode cache, shared by
``serving.api.DenseBackend`` and ``core.engine.OffloadEngine`` (the
reference jits it per max_len and retraces it per prompt shape:
``serving/api.py:276-279``, ``core/engine.py:511-516``).

``Model.prefill_entries`` (forward and the last logits) runs as a captured
step ("prefill", ``capture.CapturedStep``), keyed by the prompt's shape
alone: never max_len, a slot or a cache address, so its graphs outlive
``start_batch``.  ``Model.write_cache`` then lays the entries out in the
cache eagerly.  A capture pays off only when a shape comes back, and a
graph holds memory for as long as it lives, so on the card:

* a prompt shape's first call runs eagerly ("prefill.eager"); its second
  captures ("prefill.capture") and later ones replay ("prefill.graph"):
  a server whose prompt lengths never repeat keeps the eager time to
  first token;
* at most ``MAX_GRAPHS`` graphs live.  A shape without a graph that has
  been asked for more than twice as often as the least-used held graph's
  shape replaces it (captured first, then the old one dropped); otherwise
  it runs eagerly.  So under a steady mix of more shapes than graphs the
  use counts draw level and captures die out, while a shape that has
  become hot still wins a graph;
* a prompt of more than ``MAX_TOKENS`` tokens (B x S) always runs eagerly:
  its kernels are long enough that launches do not dominate, and its
  attention temporaries (heads x S^2 scores) would stay reserved in the
  pool.

The graphs share one ``capture.GraphPool``: each call reads its logits
back and copies its entries into the cache before it returns, so no
replay finds another's outputs still unread.  The pool's reserve is then
one prefill's working set (the float32 head cast of the logits included)
and the static outputs (prompt-length entries) of at most ``MAX_GRAPHS``
graphs.  The graphs bake in the parameters' addresses, fixed for the
owner's lifetime.  ``jit=False`` runs every call eagerly and captures
nothing.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.capture import CapturedStep, GraphPool
from repro_torch.device import to_device, to_host
from repro_torch.kernels import ops
from repro_torch.models.model import Model


class DenseKVPrefill:
    """Prefill into a dense decode cache, captured per repeated prompt
    shape (module docstring)."""

    MAX_GRAPHS = 4
    MAX_TOKENS = 2048

    def __init__(self, model: Model, params, *, jit: bool = True):
        self.model = model
        self.params = params
        self.step = CapturedStep(self._entries, "prefill", GraphPool()) if jit else None
        self.uses: Dict[tuple, int] = {}        # calls per graph key

    def _entries(self, tokens: torch.Tensor):
        return self.model.prefill_entries(self.params, tokens)

    def _run(self, tokens: torch.Tensor):
        """The entries of one call: a replay, a capture or an eager call."""
        step = self.step
        if step is None:
            return self._entries(tokens)
        k = step.graph_key(tokens)
        n = self.uses[k] = self.uses.get(k, 0) + 1
        if k in step:
            return step(tokens)
        if n >= 2 and tokens.numel() <= self.MAX_TOKENS:
            victim = None
            if step.graphs >= self.MAX_GRAPHS:
                victim = min((h for h in self.uses if h in step), key=self.uses.get)
            if victim is None or 2 * self.uses[victim] < n:
                out = step(tokens)
                if victim is not None:
                    step.drop(victim)
                return out
        ops._record(step.name, "eager")
        return self._entries(tokens)

    def __call__(self, cache, prompts: np.ndarray, max_len: int,
                 slot: Optional[int] = None) -> np.ndarray:
        """Prefill prompts (B, S) into `cache` (every row; with `slot`, one
        prompt into row `slot`).  Returns the last-token logits (B, V) on
        the host."""
        s = prompts.shape[1]
        self.model.check_prompt_fits(s, max_len)
        logits, entries = self._run(to_device(prompts, self.params["embed"].device))
        self.model.write_cache(cache, entries, s, max_len, slot)
        return to_host(logits)[0]
