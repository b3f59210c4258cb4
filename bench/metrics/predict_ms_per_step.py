"""Cache and predictor (core/predictor.py, core/engine.py): host wall of
the adaptive prefetch predictions (the program's ``engine.predict`` spans:
each row's stacked-gating calls and their readbacks, the walk over the
cache and the prefetch submissions), per decode step wholly inside the
traced sub-window; spans read through ``repro_torch.spans.snapshot()``,
summed where they start inside those steps.  None without a trace or
without the program's spans."""


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
    return sum(s.end - s.start for s in got if s.name == "engine.predict") / len(steps) * 1e3
