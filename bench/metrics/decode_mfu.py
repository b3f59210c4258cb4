"""Whole step: model FLOPs of the tokens decoded in the traced sub-window
(the block's ``token_flops``; ``moe_gqa``: benchlib/flops.py, projections,
attention over each token's context, the router, top-k experts, the head)
over the sub-window times the bf16 peak, in %."""

from benchlib import peaks


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    f = sum(rec.block.token_flops(rec.spec, keys) for _, b, entries in rec.steps
            if tr.t0 <= b <= tr.t1 for _, keys in entries)
    return 100.0 * f / (tr.window_s * peaks.BF16_FLOPS) if f > 0 else None
