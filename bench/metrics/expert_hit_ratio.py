"""Cache and predictor (core/cache.py, core/predictor.py): the expert
cache's hits over lookups in the window (deltas of hits and misses)."""


def read(rec):
    a, b = rec.stats_before(rec.w0)[1], rec.stats_before(rec.w1)[1]
    hits, misses = b["hits"] - a["hits"], b["misses"] - a["misses"]
    return hits / (hits + misses) if hits + misses > 0 else None
