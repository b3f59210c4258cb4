"""Loader and link (core/loader.py): expert bytes copied host to device
over the window (delta of loaded_bytes), per output token, in MB."""


def read(rec):
    (ta, a), (tb, b) = rec.stats_before(rec.w0), rec.stats_before(rec.w1)
    n = rec.tokens_between(ta, tb)
    return (b["loaded_bytes"] - a["loaded_bytes"]) / n / 1e6 if n else None
