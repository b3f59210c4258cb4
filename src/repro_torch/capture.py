"""Captured fixed-shape steps: the port's counterpart of the reference's
``jax.jit`` on its decode steps, prefills and single experts
(``serving/decode.py``, ``DenseBackend``, ``OffloadEngine._jit`` with its
grouped FFN at the fixed pair count B * top_k and its per-expert path,
``models/kv_pages.ChunkedPrefill``, the one-shot dense-KV prefill of both
backends).  What stays eager: ``decode.generate``'s prefill, which lives
for one call (the reference re-jits it per call), a one-shot prefill whose
prompt shape has no graph (``models.prefill.DenseKVPrefill`` captures only
shapes that come back, and only a few), and the host-side work around
every step.

``CapturedStep(fn, name)`` wraps a step whose tensor inputs have fixed
shapes.  The device of the inputs decides the route, as in ``kernels.ops``:

    CPU tensors   -> ``fn`` runs eagerly                 ("<name>.eager")
    CUDA tensors  -> one CUDA graph per key, replayed    ("<name>.graph")
    anything else -> ValueError

On CUDA the first call for a key runs ``fn`` eagerly on the current stream
and returns that result: it is the warm-up, so every kernel's library load,
first-launch attribute setup and cached occupancy query happens before the
capture.  Then the step is captured once more on a side stream
(``capture_error_mode="thread_local"``: the staging threads' copies on their
own streams go on; Python's cyclic GC held off, since a pass that destroys
a dead graph mid-capture invalidates it) from static copies of the inputs
("<name>.capture").
Later calls copy their inputs into those static buffers and replay.

The key is the inputs' shapes, dtypes and device plus whatever the caller
passes as ``key``: the addresses of the persistent buffers the step reads or
writes in place (a KV cache, page pools, step state shared across graphs),
which the graph bakes in along with every kernel argument.  A step that
writes no persistent buffer passes no address: a prefill's key is its
prompt's shape alone, so its graphs outlive ``start_batch``.  Every graph
also bakes in the addresses of the parameters it reads, which is safe
because a backend's parameters are fixed for its lifetime.  The outputs of
a replay are the graph's static output tensors, overwritten by the next
replay of the same key: callers read or copy them before calling again.

There is no fallback.  On CUDA a capture or a replay that fails raises; no
path runs the step eagerly instead, and no environment variable switches
capture off.  The eager path is the caller's choice of not wrapping the step
(``DenseBackend(jit=False)``, ``decode.generate(jit=False)``,
``ChunkedPrefill(jit=False)``), or of not calling it for a key
(``DenseKVPrefill``'s first call of a prompt shape, counted
"prefill.eager").

Memory: by default each graph draws on a private pool of its own.  Steps
built with a shared ``GraphPool`` capture on its one side stream into its
one pool, so a graph's temporaries reuse memory that an earlier graph of
the pool freed when its capture ended, and a graph's static outputs may
lie in memory that another graph of the pool uses for its temporaries.
The rule that makes this safe: **a caller copies (or consumes on the
stream) every output of a replay before the next replay of any step of
the pool.**  The prefill steps (a prefill's logits read back, its cache
entries copied into the decode cache) and the engine's single experts
(each output added into the layer's float32 sum) keep it.

Launch counts: the kernel wrappers count a launch when Python calls them
(``ops.dispatch_counts``, ``ops.dequant_mm_launches``,
``ops.grouped_launches``), and a replay calls none.  So the counts that a
capture adds are taken back (nothing ran) and added again on every replay:
the counters stay true counts of the launches that ran.
"""

from __future__ import annotations

import gc
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops


class _Graph(NamedTuple):
    graph: Any                                  # torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]            # static input buffers
    outputs: Any                                # static outputs of the capture
    launches: List[Dict[str, int]]              # counter growth per replay


def _grown(before: List[Dict[str, int]], after: List[Dict[str, int]]) -> List[Dict[str, int]]:
    return [{k: n - b.get(k, 0) for k, n in a.items() if n != b.get(k, 0)}
            for b, a in zip(before, after)]


class GraphPool:
    """One CUDA-graph memory pool and one capture stream, shared by the
    graphs of every ``CapturedStep`` built with it (module docstring: a
    caller consumes a replay's outputs before the next replay of any step
    of the pool).  Created on the first capture.  A pool whose graphs have
    all been dropped is not used again (the allocator frees it; make a new
    one), so a caller that replaces one graph by another captures the new
    one before it drops the old."""

    def __init__(self):
        self.handle = None
        self.stream: Optional[torch.cuda.Stream] = None

    def _open(self, device: torch.device) -> None:
        if self.stream is None:
            self.handle = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device=device)


class CapturedStep:
    """A fixed-shape step, captured as a CUDA graph per key on the card and
    run eagerly on the CPU (module docstring).  `pool`: a ``GraphPool``
    shared with other steps (None: a private pool per graph)."""

    def __init__(self, fn: Callable, name: str, pool: Optional[GraphPool] = None):
        self.fn = fn
        self.name = name
        self.pool = pool
        self._graphs: Dict[tuple, _Graph] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    @staticmethod
    def graph_key(*inputs: torch.Tensor, key: tuple = ()) -> tuple:
        """The key a call's graph is held under: the inputs' shapes, dtypes
        and devices, and the caller's `key`."""
        return tuple((tuple(t.shape), t.dtype, t.device) for t in inputs), key

    def __call__(self, *inputs: torch.Tensor, key: tuple = ()):
        if ops._route(self.name, *inputs) == "torch":
            ops._record(self.name, "eager")
            return self.fn(*inputs)
        k = self.graph_key(*inputs, key=key)
        g = self._graphs.get(k)
        if g is None:
            return self._capture(k, inputs)
        for dst, src in zip(g.inputs, inputs):
            dst.copy_(src)
        g.graph.replay()
        for counter, grown in zip(ops._counters(), g.launches):
            for name, n in grown.items():
                counter[name] = counter.get(name, 0) + n
        ops._record(self.name, "graph")
        return g.outputs

    def _capture(self, k: tuple, inputs: Tuple[torch.Tensor, ...]):
        out = self.fn(*inputs)                  # the warm-up is this call's result
        static = tuple(t.clone() for t in inputs)
        if self.pool is not None:
            self.pool._open(inputs[0].device)
            self._stream = self.pool.stream
        elif self._stream is None:
            self._stream = torch.cuda.Stream(device=inputs[0].device)
        counters = ops._counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        # no cyclic GC pass inside the capture: one that frees a dead graph
        # (cudaGraphExecDestroy) there invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self._stream,
                                  pool=None if self.pool is None else self.pool.handle,
                                  capture_error_mode="thread_local"):
                outputs = self.fn(*static)
        finally:
            if collecting:
                gc.enable()
        launches = _grown(before, [dict(c) for c in counters])
        for c, b in zip(counters, before):      # the capture launched nothing
            c.clear()
            c.update(b)
        self._graphs[k] = _Graph(graph, static, outputs, launches)
        ops._record(self.name, "capture")
        return out

    def reset(self) -> None:
        """Drop every graph (the persistent buffers they bake in are being
        replaced)."""
        self._graphs.clear()

    def __contains__(self, k: tuple) -> bool:
        """Whether a graph is held under key `k` (``graph_key``)."""
        return k in self._graphs

    def drop(self, k: tuple) -> None:
        """Drop the graph held under key `k`: its static outputs go back to
        its pool, for later captures into the same pool."""
        del self._graphs[k]

    @property
    def graphs(self) -> int:
        """Graphs held (one per key captured since the last reset)."""
        return len(self._graphs)


def addresses(tensors) -> tuple:
    """The device addresses of `tensors`: the part of a capture key that
    names the persistent buffers a step writes in place."""
    return tuple(t.data_ptr() for t in tensors)
