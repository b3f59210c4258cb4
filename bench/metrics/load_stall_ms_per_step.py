"""Loader and link (core/loader.py): delta of the staging engine's
load_stall_s over the window, per decode step."""


def read(rec):
    (ta, a), (tb, b) = rec.stats_before(rec.w0), rec.stats_before(rec.w1)
    n = sum(1 for s in rec.steps if ta < s[1] <= tb)
    return (b["load_stall_s"] - a["load_stall_s"]) / n * 1e3 if n else None
