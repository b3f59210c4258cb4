"""Offload decode's tail gap: the 95th percentile of every gap in the
window between consecutive output tokens of one request (a prefill chunk
run between two decode steps is part of the gap); in a traced run the
gaps across the profiler's start and stop are left out."""

from benchlib.arith import percentile


def read(rec):
    g = [(b - a) * 1e3 for ts in rec.stamps.values() for a, b in zip(ts, ts[1:])
         if rec.in_window(a) and rec.in_window(b) and rec.host_ok(a, b)]
    return percentile(g, 95.0)
