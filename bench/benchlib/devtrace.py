"""The traced sub-window of a ``--trace 1`` run: ``torch.profiler`` with
CUDA activity only (no host op events, so the host runs as untraced),
started a fraction into the window and stopped a few seconds later, both at
a synchronisation.  Device timestamps are put on the harness's clock by a
marker kernel (``torch.cuda._sleep``) launched on an idle device right
after the profiler starts.  Nothing is written to disk."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from benchlib.arith import gaps, union_length

MARK_CYCLES = 20000


@dataclasses.dataclass
class TraceData:
    t0: float                   # sub-window on the harness's clock
    t1: float
    # device activities: (name, "kernel" | "copy", start, end) on that clock
    events: List[Tuple[str, str, float, float]]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        return union_length([(a, b) for _, _, a, b in self.events], self.t0, self.t1)

    def idle(self) -> List[Tuple[float, float]]:
        return gaps([(a, b) for _, _, a, b in self.events], self.t0, self.t1)


class Tracer:
    def __init__(self, start_after_s: float, length_s: float):
        self.start_after_s = start_after_s
        self.length_s = length_s
        self.prof = None
        self.t_call = self.t_mark = self.t0 = self.t1 = self.t_done = None

    def tick(self, t: float, w0: Optional[float], closed: bool) -> None:
        if self.t_done is not None or w0 is None:
            return
        if self.prof is None:
            if not closed and t >= w0 + self.start_after_s:
                self._start()
        elif closed or t >= self.t0 + self.length_s:
            self._stop()

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        from benchlib.loop import now
        self.t_call = now()
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_mark = now()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        self.t0 = now()

    def _stop(self) -> None:
        import torch
        from benchlib.loop import now
        torch.cuda.synchronize()
        self.t1 = now()
        self.prof.__exit__(None, None, None)
        self.t_done = now()

    @property
    def excluded(self) -> Optional[Tuple[float, float]]:
        """Host interval the profiler's start and stop disturb."""
        if self.t_call is None:
            return None
        return (self.t_call, self.t_done if self.t_done is not None else float("inf"))

    def data(self) -> Optional[TraceData]:
        """The sub-window's device activities, or None when it recorded none."""
        if self.prof is None or self.t_done is None:
            return None
        from torch.autograd import DeviceType
        dev = [e for e in self.prof.events() if e.device_type == DeviceType.CUDA]
        if not dev:
            return None
        dev.sort(key=lambda e: e.time_range.start)
        marks = [e for e in dev if "spin" in e.name.lower() or "sleep" in e.name.lower()]
        mark = marks[0] if marks else dev[0]
        base = mark.time_range.start
        events = []
        for e in dev:
            if e is mark:
                continue
            a = self.t_mark + (e.time_range.start - base) / 1e6
            b = self.t_mark + (e.time_range.end - base) / 1e6
            low = e.name.lower()
            kind = "copy" if low.startswith(("memcpy", "memset")) else "kernel"
            events.append((e.name, kind, a, b))
        return TraceData(self.t0, self.t1, events)


def breakdown(rec, top: int = 10) -> dict:
    """The traced sub-window's device operations that took most time, and its
    idle device time by the harness span the host was in ("scheduler"
    outside the backend calls and sampling)."""
    tr = rec.trace
    ops = {}
    for name, _, a, b in tr.events:
        lo, hi = max(a, tr.t0), min(b, tr.t1)
        if hi > lo:
            ops[name] = ops.get(name, 0.0) + (hi - lo)
    spans = sorted((a, b, n) for n, a, b in rec.spans if b >= tr.t0 and a <= tr.t1)
    idle = {}
    for a, b in tr.idle():
        mid = 0.5 * (a + b)
        label = "scheduler"
        for sa, sb, n in spans:
            if sa <= mid <= sb:
                label = n
                break
        idle[label] = idle.get(label, 0.0) + (b - a)
    order = lambda d: sorted(([k[:120], v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return {"device_ops": order(ops), "idle_gaps": order(idle)}
