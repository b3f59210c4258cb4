"""Prefill (models/kv_pages.py ChunkedPrefill, models/moe.py): median host
wall of join_step in the window, one chunk for every pending admission."""

from benchlib.arith import median


def read(rec):
    return median([(b - a) * 1e3 for a, b, _ in rec.window_joins() if rec.host_ok(a, b)])
