"""Engine step (core/engine.py): host wall of the MoE layers' captured
segments and their readback (the program's ``engine.segment`` spans, what
the engine's ``gating_s`` sums: attention, norm and router replayed, then
the wait for them and the layer before's FFN), per decode step wholly
inside the traced sub-window; spans read through
``repro_torch.spans.snapshot()``, summed where they start inside those
steps.  None without a trace or without the program's spans."""


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
    return sum(s.end - s.start for s in got if s.name == "engine.segment") / len(steps) * 1e3
