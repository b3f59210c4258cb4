"""Engine step (core/engine.py): step wall minus load stall minus kernel
time, per decode step of the traced sub-window (host work with the device
idle and no load awaited)."""


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    steps = [s for s in rec.steps if s[0] >= tr.t0 and s[1] <= tr.t1]
    if not steps:
        return None
    wall = sum(b - a for a, b, _ in steps)
    stall = (rec.stats_after(steps[-1][1])[1]["load_stall_s"]
             - rec.stats_before(steps[0][0])[1]["load_stall_s"])
    kern = sum(e_b - e_a for _, kind, e_a, e_b in tr.events if kind == "kernel"
               and any(a <= e_a <= b for a, b, _ in steps))
    return (wall - stall - kern) / len(steps) * 1e3
