"""95th percentile, over the requests whose first token falls in the
window, of first token minus submit (the completion of the client's
previous reply)."""

from benchlib.arith import percentile


def read(rec):
    t = [(ts[0] - rec.submits[rid]) * 1e3 for rid, ts in rec.stamps.items()
         if ts and rid not in rec.warm and rec.in_window(ts[0])]
    return percentile(t, 95.0)
