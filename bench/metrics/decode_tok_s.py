"""Output tokens stamped inside the window, first tokens from prefill
included, over the window's seconds."""


def read(rec):
    n = sum(1 for ts in rec.stamps.values() for t in ts if rec.in_window(t))
    return n / (rec.w1 - rec.w0)
