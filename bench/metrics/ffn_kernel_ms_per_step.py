"""Kernels (kernels/csrc/grouped_matmul.cu, dequant.cu): device time of the
grouped FFN kernels (grouped_mm_kernel, grouped_mmv_kernel) per decode step
of the traced sub-window."""


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    n = sum(1 for s in rec.steps if tr.t0 <= s[1] <= tr.t1)
    t = sum(min(b, tr.t1) - max(a, tr.t0) for name, kind, a, b in tr.events
            if kind == "kernel" and "grouped_mm" in name and b > tr.t0 and a < tr.t1)
    return t / n * 1e3 if n and t > 0 else None
