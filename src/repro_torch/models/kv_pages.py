"""Paged KV cache of the port: a fixed device-resident page pool shared by
all serving slots, so a slot's KV memory grows with its actual length
instead of every slot paying for the batch's ``max_len``.

PyTorch twin of the JAX package's ``models/kv_pages.py``.  The metadata is
the same numpy / plain-Python logic, decision for decision: per-slot page
tables, a free list, per-page refcounts, admission reservations, the radix
prefix trie with copy-on-write (COW) and its ``cow_debt`` headroom, and
preemption snapshots.  What differs on a card:

* The page buffers are torch tensors on the pool's device, one K and one V
  buffer per layer, updated in place (the reference rebinds donated jitted
  outputs).  Each buffer has ``num_pages + 1`` rows: the last row is a write
  sink that no table ever names.  The paged attention layers send the K/V
  writes the reference drops (inactive slots, prefill pads, prefix re-feeds)
  to the sink, because torch indexing has no drop mode and an out-of-range
  index on the card is a device assert.
* ``_copy_page`` (the COW device copy) copies one page row per layer in
  place on the current stream.
* ``table_device()`` exports a fresh int32 copy of the host table whenever
  it changed (``to_device`` stages it in its own pinned buffer), so the
  host may mutate the live table right after.
* ``snapshot_slot`` copies the slot's pages to the host with a blocking
  copy, before ``release`` hands them to another slot.

``ChunkedPrefill`` is the shared admission driver: it feeds prompts through
``model.prefill_chunk_paged`` in fixed-size chunks (one batched call per
chunk covering every request being admitted), captured by default
(``jit=True``, as the reference jits it): a CUDA graph per (pending rows,
chunk) replayed on the card, with the host's ``ensure``, copy-on-write and
table export before each replay and the logits read back right after it.
With prefix sharing it resumes feeding at the matched length (re-feeding at
least the final prompt token so last-token logits exist) and passes a
per-row ``wstart`` so re-fed positions attend but never re-write aliased
pages.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.capture import CapturedStep, addresses
from repro_torch.device import DeviceLike, to_device, to_host


class PagePoolExhausted(RuntimeError):
    """Raised when a page allocation or reservation cannot be satisfied.

    Admission-time callers (the batching scheduler) treat this as "the
    request must wait for pages"; hitting it mid-decode means the caller
    admitted a request without reserving its full length."""


def pages_for(tokens: int, page_size: int) -> int:
    """Number of pages needed to hold `tokens` KV entries."""
    return -(-int(tokens) // page_size) if tokens > 0 else 0


def _copy_page(pages: torch.Tensor, src: int, dst: int) -> None:
    """Copy physical page `src` onto `dst` inside one page buffer (the COW
    device copy), in place."""
    pages[dst].copy_(pages[src])


class _PrefixNode:
    """One page of a registered prompt chain in the radix prefix index.

    ``tokens`` is the page's written token content (a full ``page_size``
    tuple for interior pages, shorter for a trailing partial page — partial
    nodes are always leaves); ``page`` is the physical page id whose KV
    holds those tokens; ``refs`` is the set of live slots whose tables alias
    the page through this node.  Nodes are pruned when ``refs`` empties."""

    __slots__ = ("tokens", "page", "parent", "children", "partials", "refs")

    def __init__(self, tokens: Tuple[int, ...], page: int,
                 parent: Optional["_PrefixNode"]):
        self.tokens = tokens
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _PrefixNode] = {}
        self.partials: List[_PrefixNode] = []
        self.refs: set = set()


class PagedKVPool:
    """Fixed device-resident KV page pool with per-slot page tables, a radix
    prefix index for cross-slot page aliasing, and copy-on-write.

    ``k[layer]`` / ``v[layer]`` are ``(num_pages + 1, page_size, Hkv, hd)``
    tensors; row ``num_pages`` is the write sink (see the module docstring).
    All metadata lives on the host."""

    def __init__(self, *, num_layers: int, num_kv_heads: int, head_dim: int,
                 dtype: torch.dtype, num_pages: int, page_size: int = 64,
                 max_pages_per_slot: int = 0, prefix_sharing: bool = True,
                 device: DeviceLike = "cuda"):
        """max_pages_per_slot bounds one slot's logical length (defaults to
        the whole pool); it is the width of the exported page table.
        prefix_sharing=False disables the radix index entirely."""
        self.num_layers = num_layers
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_pages_per_slot = int(max_pages_per_slot or num_pages)
        self.prefix_sharing = bool(prefix_sharing)
        self.device = torch.device(device)
        shape = (self.num_pages + 1, self.page_size, num_kv_heads, head_dim)
        self.k: List[torch.Tensor] = [torch.zeros(shape, dtype=dtype, device=self.device)
                                      for _ in range(num_layers)]
        self.v: List[torch.Tensor] = [torch.zeros(shape, dtype=dtype, device=self.device)
                                      for _ in range(num_layers)]
        self.start(0)

    # ------------- batch lifecycle -------------
    def start(self, batch: int):
        """Reset metadata for a new batch of `batch` slots (buffers are
        reused; stale page contents are dead because reads are masked by
        each slot's position)."""
        self.batch = batch
        self.free: List[int] = list(range(self.num_pages))
        self.table = np.zeros((batch, self.max_pages_per_slot), np.int32)
        self.owned: List[List[int]] = [[] for _ in range(batch)]
        self.lens = np.zeros((batch,), np.int64)
        self.reserved = np.zeros((batch,), np.int64)   # pages promised, not drawn
        self.refcount = np.zeros((self.num_pages,), np.int32)
        self._root = _PrefixNode((), -1, None)
        self._page_node: Dict[int, _PrefixNode] = {}
        self._slot_nodes: List[List[_PrefixNode]] = [[] for _ in range(batch)]
        # pages that pending copy-on-writes of shared partial pages may
        # consume: one per extra sharer of each partial shared page
        self.cow_debt = 0
        self.prefix_hit_tokens = 0
        self.cow_copies = 0
        self._table_dev: Optional[torch.Tensor] = None

    # ------------- radix prefix index -------------
    def _is_partial(self, node: _PrefixNode) -> bool:
        return len(node.tokens) < self.page_size

    def _refs_add(self, node: _PrefixNode, slot: int):
        if self._is_partial(node) and len(node.refs) >= 1:
            self.cow_debt += 1        # one more potential COW on this page
        node.refs.add(slot)

    def _refs_discard(self, node: _PrefixNode, slot: int):
        if slot not in node.refs:
            return
        if self._is_partial(node) and len(node.refs) >= 2:
            self.cow_debt -= 1
        node.refs.discard(slot)
        if not node.refs:
            self._prune(node)

    def _prune(self, node: _PrefixNode):
        """Unlink a no-longer-referenced node (its descendants emptied
        first: a slot referencing a node references all its ancestors)."""
        parent = node.parent
        if parent is not None:
            if self._is_partial(node):
                if node in parent.partials:
                    parent.partials.remove(node)
            elif parent.children.get(node.tokens) is node:
                del parent.children[node.tokens]
        if self._page_node.get(node.page) is node:
            del self._page_node[node.page]

    def _match_prefix(self, prompt: np.ndarray
                      ) -> Tuple[List[_PrefixNode], Optional[_PrefixNode], int, int]:
        """Longest trie match for `prompt`: (full-page node chain, best
        partial leaf or None, tokens covered by the chain, tokens covered by
        the partial)."""
        psz, n = self.page_size, len(prompt)
        node, nodes, off = self._root, [], 0
        while n - off >= psz:
            child = node.children.get(tuple(prompt[off:off + psz].tolist()))
            if child is None:
                break
            nodes.append(child)
            off += psz
            node = child
        best, bestk = None, 0
        for pc in node.partials:
            k = min(len(pc.tokens), n - off)
            if k > bestk and pc.tokens[:k] == tuple(prompt[off:off + k].tolist()):
                best, bestk = pc, k
        return nodes, best, off, bestk

    def _share_plan(self, tokens: int, prompt
                    ) -> Optional[Tuple[List[_PrefixNode], int, int]]:
        """Best admissible aliasing plan for a fresh slot needing `tokens`
        total KV entries: (node chain, matched tokens, suffix pages to
        reserve).  Partial-page sharing first (one cow_debt unit), then full
        pages only, then None.  Non-mutating."""
        if not (self.prefix_sharing and prompt is not None):
            return None
        prompt = np.asarray(prompt).reshape(-1)
        if len(prompt) == 0:
            return None
        need = pages_for(tokens, self.page_size)
        nodes, best, off, bestk = self._match_prefix(prompt)
        plans = []
        if best is not None and bestk > 0:
            plans.append((nodes + [best], off + bestk, 1))
        if nodes:
            plans.append((list(nodes), off, 0))
        for chain, matched, debt in plans:
            if len(chain) > need:
                continue
            extra = need - len(chain)
            if extra + debt <= self.reservable_pages():
                return chain, matched, extra
        return None

    def _alias(self, slot: int, chain: List[_PrefixNode]):
        """Point the first len(chain) logical pages of `slot` at the chain's
        physical pages (refcount++ each)."""
        own = self.owned[slot]
        for node in chain:
            self.table[slot, len(own)] = node.page
            own.append(node.page)
            self.refcount[node.page] += 1
            self._refs_add(node, slot)
            self._slot_nodes[slot].append(node)
        self._table_dev = None

    def register_prefix(self, slot: int, prompt):
        """Insert `slot`'s completed prompt into the radix index, page by
        page; already-shared pages are skipped and content another live slot
        registered first wins."""
        if not self.prefix_sharing:
            return
        prompt = np.asarray(prompt).reshape(-1)
        psz, n = self.page_size, len(prompt)
        node, own = self._root, self.owned[slot]
        for i in range(n // psz):
            content = tuple(prompt[i * psz:(i + 1) * psz].tolist())
            mine = int(own[i])
            child = node.children.get(content)
            if child is not None:
                if child.page != mine:
                    return            # duplicate content registered first
                node = child
                continue
            if mine in self._page_node:
                return                # page already indexed under other content
            child = _PrefixNode(content, mine, node)
            child.refs.add(slot)
            node.children[content] = child
            self._page_node[mine] = child
            self._slot_nodes[slot].append(child)
            node = child
        rem = n % psz
        if rem == 0:
            return
        mine = int(own[n // psz])
        if mine in self._page_node:
            return                    # trailing page is itself an alias
        content = tuple(prompt[n - rem:].tolist())
        if any(pc.tokens == content for pc in node.partials):
            return                    # identical partial already registered
        leaf = _PrefixNode(content, mine, node)
        leaf.refs.add(slot)
        node.partials.append(leaf)
        self._page_node[mine] = leaf
        self._slot_nodes[slot].append(leaf)

    # ------------- copy-on-write -------------
    def make_writable(self, slot: int, start: int, end: int):
        """Host-side COW guard: call before any call that writes token
        positions [start, end) of `slot`.  Shared target pages are copied to
        fresh pages (the writer's table entry moves, readers keep the
        original).  A page only this slot references stays registered when
        the write lands strictly past the node's recorded tokens and is
        unregistered when the write overlaps them."""
        if not self.prefix_sharing or start >= end:
            return
        psz = self.page_size
        own = self.owned[slot]
        for li in range(int(start) // psz, (int(end) - 1) // psz + 1):
            if li >= len(own):
                break                 # not drawn yet -> cannot be shared
            pid = int(own[li])
            node = self._page_node.get(pid)
            if node is None or slot not in node.refs:
                continue              # exclusive page
            if self.refcount[pid] > 1:
                self._cow(slot, li, node)
            elif max(int(start), li * psz) - li * psz < len(node.tokens):
                self._refs_discard(node, slot)  # sole owner: just unregister
                self._slot_nodes[slot].remove(node)

    def _cow(self, slot: int, li: int, node: _PrefixNode):
        """Copy-on-write logical page `li` of `slot` off the shared physical
        page onto a fresh one (funded by the cow_debt headroom)."""
        pid = node.page
        promised = int(self.reserved.sum())
        if not self.free or len(self.free) - promised - (self.cow_debt - 1) <= 0:
            raise PagePoolExhausted(
                f"slot {slot}: pool exhausted on copy-on-write of page {pid} "
                f"({len(self.free)} free, {promised} reserved, "
                f"{self.cow_debt} COW debt)")
        new = self.free.pop()
        self.refcount[new] = 1
        self.refcount[pid] -= 1
        self.table[slot, li] = new
        self.owned[slot][li] = new
        self._refs_discard(node, slot)          # releases one cow_debt unit
        self._slot_nodes[slot].remove(node)
        for kp, vp in zip(self.k, self.v):
            _copy_page(kp, pid, new)
            _copy_page(vp, pid, new)
        self.cow_copies += 1
        self._table_dev = None

    # ------------- admission reservations -------------
    def reservable_pages(self) -> int:
        """Pages available to new admissions: free minus promised minus the
        pages pending copy-on-writes may consume."""
        return len(self.free) - int(self.reserved.sum()) - self.cow_debt

    def fits(self, tokens: int) -> bool:
        """True iff a request of `tokens` total KV entries can ever be
        served by this pool (page-table width and pool size)."""
        need = pages_for(tokens, self.page_size)
        return need <= min(self.max_pages_per_slot, self.num_pages)

    def can_reserve(self, tokens: int, prompt=None) -> bool:
        """True iff a request needing `tokens` total KV entries can be
        admitted now without ever starving an admitted slot; with `prompt`,
        priced against the best prefix-sharing plan.  Non-mutating."""
        if not self.fits(tokens):
            return False
        if pages_for(tokens, self.page_size) <= self.reservable_pages():
            return True
        return self._share_plan(tokens, prompt) is not None

    def reserve(self, slot: int, tokens: int, prompt=None) -> int:
        """Promise `tokens` total KV entries to `slot`; with `prompt` and
        sharing on, alias the longest trie-matched prefix first and reserve
        only the unshared suffix.  Returns the matched token count.  Raises
        PagePoolExhausted if the promise cannot be kept, ValueError if it
        exceeds the slot's page-table width."""
        need = pages_for(tokens, self.page_size)
        if need > self.max_pages_per_slot:
            raise ValueError(
                f"request needs {need} pages > max_pages_per_slot="
                f"{self.max_pages_per_slot} (max_len bound)")
        if need > self.num_pages:
            raise PagePoolExhausted(
                f"request needs {need} pages > pool size {self.num_pages}")
        if self.prefix_sharing and prompt is not None and not self.owned[slot]:
            plan = self._share_plan(tokens, prompt)
            if plan is not None:
                chain, matched, extra = plan
                self._alias(slot, chain)
                self.reserved[slot] = max(int(self.reserved[slot]), extra)
                self.lens[slot] = max(int(self.lens[slot]), matched)
                self.prefix_hit_tokens += matched
                return matched
        extra = need - len(self.owned[slot])
        if extra > self.reservable_pages() + int(self.reserved[slot]):
            raise PagePoolExhausted(
                f"slot {slot}: {extra} pages wanted, "
                f"{self.reservable_pages()} reservable")
        self.reserved[slot] = max(int(self.reserved[slot]), extra)
        return 0

    # ------------- allocation -------------
    def ensure(self, slot: int, length: int):
        """Grow `slot` to cover `length` tokens from the free list (its own
        reservation first); the draw may not take pages promised to other
        slots or owed to pending copy-on-writes."""
        target = pages_for(length, self.page_size)
        if target > self.max_pages_per_slot:
            raise ValueError(f"slot {slot}: length {length} exceeds max_pages_per_slot")
        own = self.owned[slot]
        while len(own) < target:
            promised_to_others = int(self.reserved.sum()) - int(self.reserved[slot])
            if not self.free or len(self.free) - promised_to_others - self.cow_debt <= 0:
                raise PagePoolExhausted(
                    f"slot {slot}: pool exhausted growing to {length} tokens "
                    f"({len(self.free)} free, {promised_to_others} promised "
                    "to other slots' reservations; admit with reserve() to "
                    "prevent this)")
            pid = self.free.pop()
            self.refcount[pid] = 1
            self.table[slot, len(own)] = pid
            own.append(pid)
            if self.reserved[slot] > 0:
                self.reserved[slot] -= 1
            self._table_dev = None
        self.lens[slot] = max(int(self.lens[slot]), int(length))

    def release(self, slot: int):
        """Drop the slot's claim on its pages (exclusive ones return to the
        free list) and its reservation.  A second release is a no-op."""
        for node in reversed(self._slot_nodes[slot]):
            self._refs_discard(node, slot)
        self._slot_nodes[slot] = []
        for pid in self.owned[slot]:
            self.refcount[pid] -= 1
            if self.refcount[pid] <= 0:
                self.refcount[pid] = 0
                self.free.append(pid)
        self.owned[slot] = []
        self.lens[slot] = 0
        self.reserved[slot] = 0
        self._table_dev = None

    # ------------- preemption snapshots -------------
    def snapshot_slot(self, slot: int) -> Dict[str, object]:
        """Host snapshot of `slot`'s KV state for preemption: page contents
        (per layer, blocking copies to host), written length and undrawn
        reservation.  Take it BEFORE ``release(slot)``."""
        pages = [int(p) for p in self.owned[slot]]
        if pages:
            idx = to_device(np.asarray(pages, np.int64), self.device)
            k = [kp.index_select(0, idx).cpu() for kp in self.k]
            v = [vp.index_select(0, idx).cpu() for vp in self.v]
        else:
            k, v = [], []
        return {"length": int(self.lens[slot]), "reserved": int(self.reserved[slot]),
                "num_pages": len(pages), "k": k, "v": v}

    def restore_slot(self, slot: int, snap: Dict[str, object]) -> None:
        """Re-admit a paused slot from its snapshot onto fresh private pages
        (never re-registered in the trie).  Raises PagePoolExhausted when
        the pool cannot cover pages + reservation now."""
        assert not self.owned[slot], f"slot {slot} not empty on restore"
        npages = int(snap["num_pages"])
        reserved = int(snap["reserved"])
        if npages + reserved > self.reservable_pages():
            raise PagePoolExhausted(
                f"slot {slot}: resume needs {npages}+{reserved} pages, "
                f"{self.reservable_pages()} reservable")
        own = self.owned[slot]
        for li in range(npages):
            pid = self.free.pop()
            self.refcount[pid] = 1
            self.table[slot, li] = pid
            own.append(pid)
        if npages:
            idx = to_device(np.asarray(own, np.int64), self.device)
            for kp, sk in zip(self.k, snap["k"]):
                kp.index_copy_(0, idx, sk.to(self.device))
            for vp, sv in zip(self.v, snap["v"]):
                vp.index_copy_(0, idx, sv.to(self.device))
        self.lens[slot] = int(snap["length"])
        self.reserved[slot] = reserved
        self._table_dev = None

    def prepare_decode(self, rows, positions) -> torch.Tensor:
        """Decode-step prologue: grow each slot of `rows` to cover the token
        about to be written at positions[r] (copying a shared page off its
        sharers first) and return the page table on the device."""
        for r in rows:
            pos = int(positions[r])
            self.ensure(r, pos + 1)
            self.make_writable(r, pos, pos + 1)
        return self.table_device()

    # ------------- device views -------------
    def table_device(self) -> torch.Tensor:
        """Page table as an int32 (batch, max_pages_per_slot) tensor on the
        pool's device: a fresh copy whenever the host table changed."""
        if self._table_dev is None:
            self._table_dev = to_device(self.table, self.device)
        return self._table_dev

    # ------------- observability -------------
    @property
    def pages_used(self) -> int:
        return self.num_pages - len(self.free)

    @property
    def page_fraction(self) -> float:
        return self.pages_used / self.num_pages if self.num_pages else 0.0

    @property
    def aliased_pages(self) -> int:
        return int(np.sum(self.refcount >= 2))

    def stats(self) -> Dict[str, float]:
        """JSON-serializable pool counters (backend stats() contract keys)."""
        return {
            "kv_pages_used": self.pages_used,
            "kv_pages_total": self.num_pages,
            "kv_page_fraction": self.page_fraction,
            "kv_page_size": self.page_size,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "cow_copies": self.cow_copies,
            "aliased_page_fraction": (self.aliased_pages / self.pages_used
                                      if self.pages_used else 0.0),
        }


class ChunkedPrefill:
    """Incremental chunked-prefill admission driver over a `PagedKVPool`.

    ``begin(slot, prompt, reserve_tokens)`` registers a joining request
    (reserving its full KV budget, aliasing a trie-matched prefix); each
    ``step()`` advances every pending admission by one chunk through one
    batched ``model.prefill_chunk_paged`` call and returns the last-token
    logits of the requests whose prompt completed; ``run`` is the blocking
    loop."""

    def __init__(self, model, params, pool: PagedKVPool, *, chunk: int = 64,
                 jit: bool = True):
        """chunk: tokens fed per step per request.  jit: run each chunk as a
        captured step ("prefill_chunk": a CUDA graph per (pending rows,
        chunk) on the card, eager on the CPU), as the reference jits it;
        False runs it eagerly."""
        self.model = model
        self.params = params
        self.pool = pool
        self.chunk = int(chunk)
        self._step = CapturedStep(self._prefill_chunk, "prefill_chunk") if jit else None
        # slot -> (prompt, fed, wstart): next feed offset + write floor
        self._pending: Dict[int, Tuple[np.ndarray, int, int]] = {}
        self._unclaimed: Dict[int, np.ndarray] = {}  # finished during run()

    def begin(self, slot: int, prompt, reserve_tokens: Optional[int] = None):
        """Register `prompt` for admission into `slot`, reserving
        `reserve_tokens` total KV entries (default: the prompt alone)."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        assert len(prompt) > 0, "empty prompt"
        assert slot not in self._pending, f"slot {slot} already admitting"
        matched = self.pool.reserve(slot, int(reserve_tokens or len(prompt)),
                                    prompt=prompt)
        fed = min(int(matched), len(prompt) - 1)
        self._pending[slot] = (prompt, fed, int(matched))

    @property
    def pending_slots(self) -> List[int]:
        return sorted(self._pending)

    def step(self) -> Dict[int, np.ndarray]:
        """Feed one chunk for every pending admission in one call.  Returns
        {slot: last-token logits (V,)} for prompts that completed."""
        finished: Dict[int, np.ndarray] = dict(self._unclaimed)
        self._unclaimed = {}
        if not self._pending:
            return finished
        slots = self.pending_slots
        c = self.chunk
        toks = np.zeros((len(slots), c), np.int64)
        ints = np.zeros((3, len(slots)), np.int64)        # starts, ns, wstarts
        for i, s in enumerate(slots):
            prompt, fed, ws = self._pending[s]
            n = min(c, len(prompt) - fed)
            toks[i, :n] = prompt[fed:fed + n]
            ints[:, i] = (fed, n, ws)
            self.pool.ensure(s, fed + n)
            self.pool.make_writable(s, max(fed, ws), fed + n)
        dev = self.pool.device
        args = (to_device(self.pool.table[slots], dev), to_device(toks, dev),
                *to_device(ints, dev))
        if self._step is None:
            lg = self._prefill_chunk(*args)
        else:
            lg = self._step(*args, key=addresses((*self.pool.k, *self.pool.v)))
        (lg,) = to_host(lg)                 # read back before the next replay
        for i, s in enumerate(slots):
            prompt, fed, ws = self._pending[s]
            fed += int(ints[1, i])
            if fed >= len(prompt):
                del self._pending[s]
                self.pool.register_prefix(s, prompt)
                finished[s] = lg[i]
            else:
                self._pending[s] = (prompt, fed, ws)
        return finished

    def _prefill_chunk(self, table, tokens, starts, ns, wstarts) -> torch.Tensor:
        """One chunk for the pending rows (table (R, maxp), tokens (R, C),
        starts / ns / wstarts (R,)): K/V written into the pool's pages in
        place; the last valid token's logits (R, V)."""
        return self.model.prefill_chunk_paged(self.params, self.pool.k, self.pool.v, table,
                                              tokens, starts, ns, wstarts)

    def run_batch(self, prompts: np.ndarray, reserve_tokens: int) -> np.ndarray:
        """Prefill prompts (B, S) into slots 0..B-1, each reserving
        `reserve_tokens`, advancing all of them together; returns the
        last-token logits (B, V)."""
        for r in range(prompts.shape[0]):
            self.begin(r, prompts[r], reserve_tokens=reserve_tokens)
        done: Dict[int, np.ndarray] = {}
        while len(done) < prompts.shape[0]:
            done.update(self.step())
        return np.stack([done[r] for r in range(prompts.shape[0])])

    def run(self, slot: int, prompt, reserve_tokens: Optional[int] = None) -> np.ndarray:
        """Blocking admission: begin + step until `slot` finishes; other
        admissions that finish meanwhile stay claimable by the next step."""
        self.begin(slot, prompt, reserve_tokens)
        while True:
            done = self.step()
            if slot in done:
                self._unclaimed.update({s: l for s, l in done.items() if s != slot})
                return done[slot]
            self._unclaimed.update(done)
