"""Captured fixed-shape steps: the port's counterpart of the reference's
``jax.jit`` on its decode steps and prefill chunks (``serving/decode.py``,
``DenseBackend``, ``OffloadEngine._jit`` with its grouped FFN at the fixed
pair count B * top_k, ``models/kv_pages.ChunkedPrefill``).  What stays
eager: one-shot prefill (each prompt shape is called once, so a graph adds
only its capture) and the engine's per-expert path.

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
which the graph bakes in along with every kernel argument.  The outputs of a
replay are the graph's static output tensors, overwritten by the next
replay of the same key: callers read or copy them before calling again.

There is no fallback.  On CUDA a capture or a replay that fails raises; no
path runs the step eagerly instead, and no environment variable switches
capture off.  The eager path is the caller's choice of not wrapping the step
(``DenseBackend(jit=False)``, ``decode.generate(jit=False)``,
``ChunkedPrefill(jit=False)``).

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


class CapturedStep:
    """A fixed-shape step, captured as a CUDA graph per key on the card and
    run eagerly on the CPU (module docstring)."""

    def __init__(self, fn: Callable, name: str):
        self.fn = fn
        self.name = name
        self._graphs: Dict[tuple, _Graph] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def __call__(self, *inputs: torch.Tensor, key: tuple = ()):
        if ops._route(self.name, *inputs) == "torch":
            ops._record(self.name, "eager")
            return self.fn(*inputs)
        k = (tuple((tuple(t.shape), t.dtype, t.device) for t in inputs), key)
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
        if self._stream is None:
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

    @property
    def graphs(self) -> int:
        """Graphs held (one per key captured since the last reset)."""
        return len(self._graphs)


def addresses(tensors) -> tuple:
    """The device addresses of `tensors`: the part of a capture key that
    names the persistent buffers a step writes in place."""
    return tuple(t.data_ptr() for t in tensors)
