"""Engine step (core/engine.py): host wall of the step's decisions, the
self time (a span's wall less its child spans') of the program's
``engine.route`` (fleet heat, prediction scoring, on-demand scoring),
``engine.pairs`` (precision decisions and cache lookups; its
``engine.reload`` children left out), ``engine.ffn`` (pair-table pack, its
copy to the card and the FFN replay's launch) and ``engine.retire`` (trace
rows, the loader's layer retirement, the layer-time averages) spans, per
decode step wholly inside the traced sub-window; spans read through
``repro_torch.spans.snapshot()``, summed where they start inside those
steps.  None without a trace or without the program's spans."""

NAMES = ("engine.route", "engine.pairs", "engine.ffn", "engine.retire")


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
    children = {}
    for s in got:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0.0) + (s.end - s.start)
    t = sum(s.end - s.start - children.get(s.id, 0.0) for s in got if s.name in NAMES)
    return t / len(steps) * 1e3
