"""Whole step: model FLOPs of the prompt tokens prefilled in the traced
sub-window (the block's ``chunk_flops``; ``moe_gqa``: benchlib/flops.py,
routed top-k, not the capacity einsum's padding; the head on a prompt's
last token) over the sub-window times the bf16 peak, in %."""

from benchlib import peaks


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    f = sum(rec.block.chunk_flops(rec.spec, start, n,
                                  head=start + n >= rec.prompt_len[rid])
            for _, b, entries in rec.joins if tr.t0 <= b <= tr.t1
            for rid, start, n in entries)
    return 100.0 * f / (tr.window_s * peaks.BF16_FLOPS) if f > 0 else None
