"""Smoke-sized stand-ins for the cells' configuration and traffic, for the
CPU tests: the cell's files with small widths, lengths and times."""

import copy

from benchlib import paths
from benchlib.cell import load_block


def smoke_config(name: str = "mixtral-8x7b-l8", **sizes) -> dict:
    """The configuration file `name` cut by its block's ``smoke_config``
    (``moe_gqa``: width 64, 2 layers, a vocabulary of 512)."""
    cfg = paths.load_json(paths.BENCH / "configs" / f"{name}.json")
    return load_block(cfg).smoke_config(cfg, **sizes)


def smoke_mix(manifest, cell: str) -> dict:
    mix = copy.deepcopy(manifest.traffic_file(manifest.cell(cell)))
    decode = mix["output_len"][1] > 1
    mix.update(prompt_len=[8, 40] if decode else [32, 96],
               output_len=[8, 24] if decode else [1, 1], warmup_s=0.3,
               warmup_decode_steps=4 if decode else 0, trace_s=0.5)
    return mix
