"""Spans of the port's host work: what each layer of a decode step, a
prefill chunk, a staging copy or a scheduler iteration spent its wall time
on, kept in memory for whoever reads them in the same process.

Recording is on exactly while a ``torch.profiler`` session is active: the
check reads torch's own process-wide flag
(``torch.autograd.profiler._is_profiler_enabled``; on a torch without it,
the C++ profiler state the flag mirrors, chosen once at import), so
profiling a server turns the spans on with the device trace, and nothing
else does.  Whether a
span is recorded is decided when it opens; a span opened while recording is
off is not recorded even if recording turns on before it closes (its
children then have no parent).  While off, ``span()`` costs one flag check
and hands back one shared do-nothing context: no object, no dict.

A span records its name, start and end on ``time.perf_counter()`` (the
clock the benchmark stamps its own spans with and maps the device trace
onto), its parent (the innermost span open on the same thread when it
opened; each thread keeps its own stack, since staging threads record too),
an id and a small dict of attributes.  Attributes are given positionally,
in the order ``KEYS`` lists them for the span's name, so an unrecorded span
builds no dict; a recorded one may add more through ``attrs``.  Spans of
one request share its id: the scheduler's spans carry the request ids they
serve (``rids``), and the engine's reach them through their parent.

Recorded spans go into a bounded ring (``CAPACITY``); when it is full the
oldest span is dropped and counted (``dropped()``).  ``snapshot()`` returns
the ring's spans in the order they closed.  No span is emitted to the
profiler itself (no ``record_function``, no NVTX range), so the device
trace's events are the same with or without them.  docs/TORCH_METRICS.md
lists every span with its parent and attributes.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

clock = time.perf_counter

# every span name and the keys of its positional attributes, in order
KEYS: Dict[str, tuple] = {
    # engine (core/engine.py)
    "engine.step": ("step", "rows"),
    "engine.prologue": (),
    "engine.segment": ("layer",),
    "engine.route": ("layer",),
    "engine.predict": ("layer",),
    "predictor.gating": ("layer", "layers"),
    "engine.load": ("layer",),
    "engine.pairs": ("layer",),
    "engine.reload": ("layer", "expert", "precision", "bytes"),
    "engine.ffn": ("layer",),
    "engine.retire": ("layer",),
    "engine.logits": (),
    # loader (core/loader.py)
    "loader.stage": ("layer", "expert", "precision", "reason", "bytes"),
    # chunked prefill (models/kv_pages.py)
    "prefill.chunk": ("rows",),
    "prefill.plan": (),
    "prefill.replay": (),
    "prefill.readback": (),
    # scheduler (serving/batching.py)
    "sched.iter": (),
    "sched.admit": (),
    "sched.join": (),
    "sched.step": (),
    "sched.stats": (),
    "sched.sample": (),
}

CAPACITY = 1 << 16


if hasattr(_profiler, "_is_profiler_enabled"):
    def recording() -> bool:
        """True while a torch.profiler session is active in this process."""
        return _profiler._is_profiler_enabled
else:   # a torch without the Python flag: the C++ state it mirrors
    recording = torch._C._autograd._profiler_enabled


class Span:
    """One recorded span (see the module docstring).  ``end`` is None while
    it is open."""

    __slots__ = ("id", "name", "start", "end", "parent", "_values", "_attrs", "_rec")
    on = True

    def __init__(self, rec: "Recorder", name: str, values: tuple):
        self.id = next(rec._ids)
        self.name = name
        self._values = values
        self._attrs: Optional[dict] = None
        self._rec = rec
        stack = rec._stack()
        self.parent: Optional[int] = stack[-1].id if stack else None
        stack.append(self)
        self.end: Optional[float] = None
        self.start = clock()

    @property
    def attrs(self) -> dict:
        """The attributes, built from the positional values when first read
        (the recording path builds no dict)."""
        if self._attrs is None:
            self._attrs = dict(zip(KEYS[self.name], self._values))
        return self._attrs

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end = clock()
        self._rec._close(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{self.start:.6f}-{self.end}, {self.attrs})")


class _Off:
    """The context an unrecorded span returns: it does nothing."""

    __slots__ = ()
    on = False
    attrs = None

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class Recorder:
    """The ring of recorded spans and each thread's stack of open ones."""

    def __init__(self, capacity: int = CAPACITY):
        self._ring: deque = deque(maxlen=capacity)
        self._dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def span(self, name: str, a=None, b=None, c=None, d=None, e=None):
        """Open span `name` with the values of ``KEYS[name]`` in order:
        ``with span("engine.segment", layer): ...``.  Off: ``OFF``."""
        if not recording():
            return OFF
        return Span(self, name, (a, b, c, d, e))

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, sp: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is sp:   # always, as spans close in `with` order
            stack.pop()
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(sp)

    def snapshot(self) -> List[Span]:
        """The recorded spans, oldest first by the time they closed."""
        with self._lock:
            return list(self._ring)

    def dropped(self) -> int:
        """Spans the ring dropped, oldest first, to make room."""
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0


# one recorder per process, as the profiler flag that switches it is
RECORDER = Recorder()
span = RECORDER.span
snapshot = RECORDER.snapshot
dropped = RECORDER.dropped
clear = RECORDER.clear
