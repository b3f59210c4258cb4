"""Share of the window's routed (token, MoE layer, expert) pairs of decode
steps that were computed from 4-bit weights or skipped: deltas of the
engine's hi and lo pair histograms and skip count."""


def read(rec):
    a, b = rec.stats_before(rec.w0)[1], rec.stats_before(rec.w1)[1]
    d = {k: b[k] - a[k] for k in ("hi_pairs", "lo_pairs", "skips")}
    total = d["hi_pairs"] + d["lo_pairs"] + d["skips"]
    return (d["lo_pairs"] + d["skips"]) / total if total > 0 else None
