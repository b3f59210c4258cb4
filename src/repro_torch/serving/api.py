"""Unified serving API of the port: one slot-oriented `InferenceBackend`
protocol in front of the dense (resident-weights) decode path and the HOBBIT
offload engine, so the scheduler and the launcher drive either one.

    start_batch(batch, max_len)      allocate B slots (all marked active)
    prefill(prompts (B,S)) -> (B,V)  full-batch prefill, last-token logits
    join(slot, prompt (S,)) -> (V,)  admit one request into a slot mid-flight
    join_begin(slot, prompt, ...)    start an incremental admission
    join_step() -> {slot: (V,)}      advance all admissions
    can_admit(tokens, *, prompt)     does KV capacity exist for a request?
    pause(slot) -> snapshot          preempt a slot: KV to host, slot freed
    resume(slot, snapshot)           re-admit a paused request
    release(slot)                    free a slot
    step(tokens (B,)) -> (B,V)       one decode step for the whole batch
    stats() -> dict                  backend counters
    close()                          release resources (idempotent)

KV memory comes in two layouts, chosen per backend at construction: dense
(a (B, max_len) cache per slot and layer, allocated by ``start_batch``; a
windowed layer's is a ring of min(max_len, window) slots, so its rows are
shorter) or paged
(``paged=True`` / ``EngineConfig(paged_kv=True)``: a shared
`models.kv_pages.PagedKVPool` of page_size-token pages with prefix sharing,
prompts prefilled in prefill_chunk-token chunks).  Logits cross to the host
as float32 numpy arrays, as in the JAX package.  ``generate`` and
``score_nll`` drive any backend through this protocol.

``DenseBackend(jit=True)`` (the default, as the reference jits its steps)
runs its decode step on either KV layout, on paged KV each chunk of
chunked prefill, and on dense KV the one-shot prefill of a batch or a join
(``models.prefill.DenseKVPrefill``: the forward captured per prompt
shape that comes back, its entries laid out in the cache eagerly) as captured steps
(``capture.CapturedStep``): CUDA graphs on the card, eager on the CPU.
The offload engine captures its decode step's device work, its dense-KV
prefill and its chunked admission itself, whatever ``BackendConfig.jit``
says (``core/engine.py``).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.capture import CapturedStep, addresses
from repro_torch.device import to_device, to_host
from repro_torch.models.kv_pages import ChunkedPrefill, PagedKVPool
from repro_torch.models.model import Model, supports_paged_kv
from repro_torch.models.prefill import DenseKVPrefill
from repro_torch.serving.decode import GenerateResult, sample_token


@runtime_checkable
class InferenceBackend(Protocol):
    """Slot-oriented decode interface served by the continuous scheduler."""

    model: Model

    def start_batch(self, batch: int, max_len: int) -> None: ...

    def prefill(self, prompts: np.ndarray) -> np.ndarray: ...

    def join(self, slot: int, prompt: np.ndarray) -> np.ndarray: ...

    def join_begin(self, slot: int, prompt: np.ndarray,
                   reserve_tokens: Optional[int] = None) -> None: ...

    def join_step(self) -> dict: ...

    def can_admit(self, tokens: int, *, prompt=None) -> bool: ...

    def pause(self, slot: int) -> dict: ...

    def resume(self, slot: int, snapshot: dict) -> None: ...

    def release(self, slot: int) -> None: ...

    def step(self, tokens: np.ndarray) -> np.ndarray: ...

    def stats(self) -> dict: ...

    def close(self) -> None: ...


def _blocking_join(backend, slot: int, prompt) -> np.ndarray:
    """THE blocking-join loop shared by every backend: begin an admission,
    then drive `join_step` until `slot` completes; other admissions that
    finish meanwhile stay claimable (`_unclaimed_joins`)."""
    backend.join_begin(slot, np.asarray(prompt, np.int32).reshape(-1))
    while True:
        done = backend.join_step()
        lg = done.pop(slot, None)
        backend._unclaimed_joins.update(done)
        if lg is not None:
            return lg


def refuse_encoder(cfg) -> None:
    """Backends serve decoder-only models: their batches are built from
    prompts alone (so is the reference's DenseBackend, which has no audio
    frames to give Whisper's encoder)."""
    if cfg.encoder is not None:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: serve it through "
                         "serving.decode.generate(model, params, prompts, n, "
                         "extra={'audio_frames': frames}), not through a backend")


class DenseBackend:
    """All weights resident on the parameters' device; prefill + decode
    through the dense model (capacity-dispatched MoE).

    ``jit=True`` runs the decode step as a captured step ("serve_step": a
    CUDA graph replayed per step on the card, keyed by the batch shape and
    the KV buffers it writes; ``start_batch`` drops the graphs with the
    buffers), on paged KV each prefill chunk ("prefill_chunk"), and on
    dense KV the one-shot prefill and joins ("prefill", keyed by the
    prompt's shape alone, so its graphs outlive ``start_batch``; a shape's
    first call eager, a few graphs at most: ``models.prefill``);
    ``jit=False`` runs all three eagerly.

    ``paged=True`` swaps the per-slot (B, max_len) cache for a shared
    `PagedKVPool` (page_size-token pages, a pool of `kv_pages` pages —
    default the dense equivalent) and prefills prompts in
    `prefill_chunk`-token chunks."""

    def __init__(self, model: Model, params, *, jit: bool = True, paged: bool = False,
                 page_size: int = 64, kv_pages: Optional[int] = None,
                 prefill_chunk: int = 64, prefix_sharing: bool = True):
        refuse_encoder(model.cfg)
        if paged and not supports_paged_kv(model.cfg):
            raise ValueError(f"arch {model.cfg.name} does not support the paged KV layout "
                             "(only all-'attn' models without MLA do; windowed layers "
                             "keep ring caches, MLA layers latent caches and SSM layers "
                             "their states on the dense layout)")
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self._jit = jit
        self._step = CapturedStep(self._decode, "serve_step") if jit else None
        self._prefill = DenseKVPrefill(model, params, jit=jit)
        self.paged = paged
        self.page_size = page_size
        self.kv_pages = kv_pages
        self.prefill_chunk = prefill_chunk
        self.prefix_sharing = prefix_sharing
        self.cache = None
        self.kv: Optional[PagedKVPool] = None
        self._admission: Optional[ChunkedPrefill] = None
        self._pending_joins: dict = {}
        self._unclaimed_joins: dict = {}
        self.batch = 0
        self.max_len = 0
        self.positions = np.zeros((0,), np.int64)
        self.active = np.zeros((0,), bool)

    def start_batch(self, batch: int, max_len: int) -> None:
        self.batch, self.max_len = batch, max_len
        self.positions = np.zeros((batch,), np.int64)
        self.active = np.ones((batch,), bool)
        self._pending_joins = {}
        self._unclaimed_joins = {}
        if self._step is not None:
            self._step.reset()          # the graphs bake in the buffers replaced here
        if not self.paged:
            self.cache = self.model.init_cache(batch, max_len, self.device)
            return
        self.kv = self.model.init_cache(batch, max_len, self.device, paged=True,
                                        page_size=self.page_size, num_pages=self.kv_pages,
                                        prefix_sharing=self.prefix_sharing)
        self._admission = ChunkedPrefill(self.model, self.params, self.kv,
                                         chunk=self.prefill_chunk, jit=self._jit)

    def prefill(self, prompts) -> np.ndarray:
        """Full-batch prefill; paged: chunked, every row reserving max_len.
        Dense: the entries written into each layer's cache buffers in place
        (``models.prefill.DenseKVPrefill``: K/V rows padded with zeros, rings,
        latent rows, an SSM layer's state as the prefill left it)."""
        prompts = np.asarray(prompts, np.int64)
        if self.paged:
            logits = self._admission.run_batch(prompts, self.max_len)
            self.positions = np.full(prompts.shape[:1], prompts.shape[1], np.int64)
            self.active[:] = True
            return logits
        logits = self._prefill(self.cache, prompts, self.max_len)  # in place
        self.positions = np.full(prompts.shape[:1], prompts.shape[1], np.int64)
        self.active[:] = True
        return logits

    def join(self, slot: int, prompt) -> np.ndarray:
        return _blocking_join(self, slot, prompt)

    def join_begin(self, slot: int, prompt,
                   reserve_tokens: Optional[int] = None) -> None:
        """Paged: reserve pages for `reserve_tokens` (default max_len) and
        queue the prompt for chunked prefill.  Dense: stash the prompt."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if self.paged:
            self._admission.begin(slot, prompt,
                                  reserve_tokens=reserve_tokens or self.max_len)
        else:
            self._pending_joins[slot] = prompt

    def join_step(self) -> dict:
        """Advance admissions (paged: one chunk for every pending prompt in
        one call); completed slots are activated."""
        done: dict = dict(self._unclaimed_joins)
        self._unclaimed_joins = {}
        if self.paged:
            done.update(self._admission.step())
            for slot in done:
                self.positions[slot] = int(self.kv.lens[slot])
                self.active[slot] = True
            return done
        for slot, prompt in list(self._pending_joins.items()):
            del self._pending_joins[slot]
            done[slot] = self._join_dense(slot, prompt)
        return done

    def _join_dense(self, slot: int, prompt) -> np.ndarray:
        """A one-row prefill scattered into row `slot` of each layer's cache
        (a ring layer's row is its ring, as long as the batch's; an MLA
        layer's its latent row; an SSM layer's its state, overwriting what
        the dead row was stepped to)."""
        prompt = prompt.reshape(1, -1)
        logits = self._prefill(self.cache, prompt, self.max_len, slot)
        self.positions[slot] = prompt.shape[1]
        self.active[slot] = True
        return logits[0]

    def can_admit(self, tokens: int, *, prompt=None) -> bool:
        """Paged: unreserved pages for `tokens`, net of prefix sharing when
        `prompt` is given.  Dense: always."""
        if self.paged:
            return self.kv.can_reserve(tokens, prompt=prompt)
        return True

    def pause(self, slot: int) -> dict:
        """Preempt `slot`: its KV to the host (dense: each layer's row, a
        ring layer's ring, an MLA layer's latent row, an SSM layer's state
        row), the slot freed.  A freed row is still stepped (an SSM layer
        steps every row), so ``resume`` copies the snapshot back over it."""
        if self.paged:
            snap = self.kv.snapshot_slot(slot)
            self.kv.release(slot)
            self.active[slot] = False
            return {"layout": "paged", "position": int(self.positions[slot]), "kv": snap}
        rows = [{name: buf[slot].to("cpu", copy=True) for name, buf in c.items()}
                for c in self.cache]
        self.active[slot] = False
        return {"layout": "dense", "position": int(self.positions[slot]), "cache": rows}

    def resume(self, slot: int, snapshot: dict) -> None:
        """Restore a paused slot: its snapshot copied back over the row in
        place, by name (over whatever an SSM layer's dead row was stepped
        to), and the slot live again at its position."""
        if snapshot["layout"] == "paged":
            self.kv.restore_slot(slot, snapshot["kv"])
        else:
            for c, row in zip(self.cache, snapshot["cache"]):
                for name, buf in c.items():
                    buf[slot].copy_(row[name])
        self.positions[slot] = int(snapshot["position"])
        self.active[slot] = True

    def release(self, slot: int) -> None:
        self.active[slot] = False
        if self.paged and self.kv is not None:
            self.kv.release(slot)

    def _decode(self, tokens, positions, active, table=None) -> torch.Tensor:
        """The decode step on the current KV layout (its buffers written in
        place): tokens (B, 1), positions (B,), active (B,), paged: the page
        table (B, maxp) -> logits (B, V)."""
        if self.paged:
            return self.model.decode_step_paged(self.params, self.kv.k, self.kv.v, table,
                                                tokens, positions, active)
        return self.model.decode_step(self.params, self.cache, tokens, positions, active)

    def step(self, tokens) -> np.ndarray:
        tokens = np.asarray(tokens, np.int64).reshape(-1, 1)
        args = [to_device(tokens, self.device), to_device(self.positions, self.device),
                to_device(self.active, self.device)]
        if self.paged:
            # page growth and copy-on-write run here, before the step
            args.append(self.kv.prepare_decode(np.flatnonzero(self.active), self.positions))
            buffers = (*self.kv.k, *self.kv.v)
        else:
            buffers = [buf for c in self.cache for buf in c.values()]
        if self._step is None:
            logits = self._decode(*args)
        else:
            logits = self._step(*args, key=addresses(buffers))
        # only active slots advance; freed slots idle at their last position
        self.positions = self.positions + self.active.astype(np.int64)
        return to_host(logits)[0]

    def stats(self) -> dict:
        """Uniform backend counters; kv_* report page-pool pressure (zeros
        under the dense layout)."""
        s = {"backend": "dense", "batch": self.batch, "max_len": self.max_len,
             "load_stall_s": 0.0, "overlap_fraction": 0.0,
             "precision_downgrades": 0, "issue_reorders": 0,
             "link_utilization": 0.0, "per_stream_bytes": [],
             "kv_pages_used": 0, "kv_pages_total": 0, "kv_page_fraction": 0.0,
             "prefix_hit_tokens": 0, "cow_copies": 0, "aliased_page_fraction": 0.0}
        if self.paged and self.kv is not None:
            s.update(self.kv.stats())
        return s

    def close(self) -> None:
        """Resident weights hold no staging threads: nothing to release."""


class HobbitBackend:
    """`OffloadEngine` behind the protocol."""

    def __init__(self, engine):
        self.engine = engine
        self.model = engine.model

    @property
    def kv(self) -> Optional[PagedKVPool]:
        """The engine's page pool (None under the dense KV layout)."""
        return self.engine.kv_pool

    def start_batch(self, batch: int, max_len: int) -> None:
        self.engine.start_batch(batch, max_len)

    def prefill(self, prompts) -> np.ndarray:
        return self.engine.prefill_batch(prompts)

    def join(self, slot: int, prompt) -> np.ndarray:
        return self.engine.join(slot, prompt)

    def join_begin(self, slot: int, prompt,
                   reserve_tokens: Optional[int] = None) -> None:
        self.engine.join_begin(slot, prompt, reserve_tokens=reserve_tokens)

    def join_step(self) -> dict:
        return self.engine.join_step()

    def can_admit(self, tokens: int, *, prompt=None) -> bool:
        return self.engine.can_admit(tokens, prompt=prompt)

    def pause(self, slot: int) -> dict:
        return self.engine.pause(slot)

    def resume(self, slot: int, snapshot: dict) -> None:
        self.engine.resume(slot, snapshot)

    def release(self, slot: int) -> None:
        self.engine.release(slot)

    def step(self, tokens) -> np.ndarray:
        return self.engine.decode_step_batch(tokens)

    def stats(self) -> dict:
        s = dict(self.engine.stats())
        s["backend"] = "hobbit"
        return s

    def close(self) -> None:
        self.engine.close()


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Typed backend construction config (mirrored by `launch/serve.py`).

    kind            "dense" (resident weights) or "hobbit" (offload engine)
    jit             capture the dense decode step as a CUDA graph on the
                    card (the offload engine captures its layer segments
                    whatever this says)
    paged           paged KV layout (shared page pool) on either backend
    page_size       tokens per KV page
    kv_pages        pool size in pages (None: the dense equivalent)
    prefill_chunk   tokens per chunked-prefill call
    prefix_sharing  radix prefix cache over the paged pool
    engine          `core.EngineConfig` for kind="hobbit" (None: defaults);
                    `paged=True` overrides its paged-KV fields
    """
    kind: str = "dense"
    jit: bool = True
    paged: bool = False
    page_size: int = 64
    kv_pages: Optional[int] = None
    prefill_chunk: int = 64
    prefix_sharing: bool = True
    engine: Optional[object] = None


_UNSET = object()   # distinguishes "not passed" from any explicit value


def make_backend(kind, model: Model, params, *, engine_config=_UNSET, jit=_UNSET,
                 paged=_UNSET, page_size=_UNSET, kv_pages=_UNSET, prefill_chunk=_UNSET,
                 prefix_sharing=_UNSET):
    """``make_backend(BackendConfig(...), model, params)``; a bare kind string
    stands for the all-defaults config.  The historical keyword arguments
    are DEPRECATED: they are folded into a BackendConfig behind a
    DeprecationWarning, and a config together with them raises TypeError."""
    legacy = {name: val for name, val in [
        ("engine", engine_config), ("jit", jit), ("paged", paged),
        ("page_size", page_size), ("kv_pages", kv_pages),
        ("prefill_chunk", prefill_chunk), ("prefix_sharing", prefix_sharing),
    ] if val is not _UNSET}
    if isinstance(kind, BackendConfig):
        if legacy:
            raise TypeError("make_backend(BackendConfig(...)) takes no keyword "
                            f"arguments; fold {sorted(legacy)} into the config")
        cfg = kind
    else:
        if legacy:
            warnings.warn("make_backend(kind, ..., **kwargs) is deprecated; pass "
                          "make_backend(BackendConfig(kind=..., ...), model, params)",
                          DeprecationWarning, stacklevel=2)
        cfg = BackendConfig(kind=kind, **legacy)
    refuse_encoder(model.cfg)
    if cfg.kind == "dense":
        return DenseBackend(model, params, jit=cfg.jit, paged=cfg.paged,
                            page_size=cfg.page_size, kv_pages=cfg.kv_pages,
                            prefill_chunk=cfg.prefill_chunk,
                            prefix_sharing=cfg.prefix_sharing)
    if cfg.kind == "hobbit":
        from repro_torch.core.engine import EngineConfig, OffloadEngine
        ecfg = cfg.engine or EngineConfig()
        if cfg.paged:
            ecfg = dataclasses.replace(ecfg, paged_kv=True, kv_page_size=cfg.page_size,
                                       kv_pages=cfg.kv_pages,
                                       prefill_chunk=cfg.prefill_chunk,
                                       prefix_sharing=cfg.prefix_sharing)
        return HobbitBackend(OffloadEngine(model, params, ecfg))
    raise ValueError(f"unknown backend kind: {cfg.kind!r}")


def generate(backend: InferenceBackend, prompts, new_tokens: int, *,
             max_len: Optional[int] = None, temperature: float = 0.0,
             seed: int = 0) -> GenerateResult:
    """Greedy/temperature generation through any backend.  prompts: (B, S)."""
    prompts = np.asarray(prompts, np.int32)
    b, s = prompts.shape
    max_len = max_len or (s + new_tokens + 1)
    backend.start_batch(b, max_len)
    gen = torch.Generator().manual_seed(seed)
    t0 = time.time()
    lg = backend.prefill(prompts)
    t1 = time.time()
    out = [prompts]
    tok = sample_token(lg, gen, temperature)
    for i in range(new_tokens):
        out.append(tok[:, None])
        if i == new_tokens - 1:
            break
        lg = backend.step(tok)
        tok = sample_token(lg, gen, temperature)
    t2 = time.time()
    return GenerateResult(np.concatenate(out, axis=1), t1 - t0, t2 - t1, new_tokens)


def score_nll(backend: InferenceBackend, tokens, *,
              max_len: Optional[int] = None) -> float:
    """Teacher-forced mean NLL through any backend's decode path: the first
    token enters through a 1-token join, every later token is a decode step,
    so offload backends are scored on their serving path."""
    tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
    max_len = max_len or (len(tokens) + 1)
    backend.start_batch(1, max_len)
    lg = backend.join(0, np.asarray(tokens[:1], np.int32))
    nll, n = 0.0, 0
    for t in tokens[1:]:
        p = np.asarray(lg, np.float64)
        p -= p.max()
        p -= np.log(np.exp(p).sum())
        nll -= p[t]
        n += 1
        lg = backend.step(np.asarray([t], np.int32))[0]
    return float(nll / max(n, 1))
