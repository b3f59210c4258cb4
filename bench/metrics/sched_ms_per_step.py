"""Scheduler layer (serving/batching.py): host wall per decode iteration
outside the backend's step and join_step (the per-step stats() call,
sampling and the server's bookkeeping), between consecutive window steps."""


def read(rec):
    steps = [s for s in rec.window_steps() if rec.host_ok(s[0], s[1])]
    joins = [(j[0], j[1]) for j in rec.joins]
    total, n = 0.0, 0
    for (a0, a1, _), (b0, b1, _) in zip(steps, steps[1:]):
        if not rec.host_ok(a1, b0):
            continue
        inside = sum(min(jb, b0) - max(ja, a1) for ja, jb in joins if jb > a1 and ja < b0)
        total += (b0 - a1) - inside
        n += 1
    return total / n * 1e3 if n else None
