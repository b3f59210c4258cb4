"""Engine step (core/engine.py): median host wall of backend.step in the
window."""

from benchlib.arith import median


def read(rec):
    return median([(b - a) * 1e3 for a, b, _ in rec.window_steps() if rec.host_ok(a, b)])
