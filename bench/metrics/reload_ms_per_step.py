"""Loader and link (core/engine.py): host wall of the union-overflow
reloads, an expert staged and committed while the layer's pairs are
decided, a wait that ``load_stall_s`` does not count (the program's
``engine.reload`` spans), per decode step wholly inside the traced
sub-window; spans read through ``repro_torch.spans.snapshot()``, summed
where they start inside those steps.  None without a trace or without the
program's spans."""


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    steps = [(a, b) for a, b, _ in rec.steps if a >= tr.t0 and b <= tr.t1]
    got = [s for s in spans.snapshot() if any(a <= s.start <= b for a, b in steps)]
    if not any(s.name == "engine.step" for s in got):
        return None
    return sum(s.end - s.start for s in got if s.name == "engine.reload") / len(steps) * 1e3
