"""Kernels (kernels/csrc/grouped_matmul.cu, dequant.cu): expert-pool bytes
the grouped FFN launches read on the card, in MB, per decode step wholly
inside the traced sub-window: the ``weight_bytes`` of the program's
``engine.ffn`` spans (each distinct slot as the kernels stream it:
``kernels.ops.grouped_ffn_weight_bytes``), read through
``repro_torch.spans.snapshot()`` where they start inside those steps,
over 1e6.  None without a trace or without the program's spans."""


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
    b = sum(s.attrs["weight_bytes"] for s in got if s.name == "engine.ffn")
    return b / 1e6 / len(steps)
