"""Smoke-sized stand-ins for the cells' configuration and traffic, for the
CPU tests: the cell's files with small widths, lengths and times."""

import copy

from benchlib import paths


def smoke_config(name: str = "mixtral-8x7b-l8", *, width: int = 64, layers: int = 2,
                 vocab: int = 512, experts: int = 0) -> dict:
    cfg = paths.load_json(paths.BENCH / "configs" / f"{name}.json")
    cfg.update(hidden_size=width, intermediate_size=width, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=layers, vocab_size=vocab,
               num_local_experts=experts or (4 if cfg["num_local_experts"] == 8 else 8))
    cfg["engine"] = dict(cfg["engine"], hi_slots=4, lo_slots=2, group_size=16,
                         kv_page_size=16, prefill_chunk=16)
    return cfg


def smoke_mix(manifest, cell: str) -> dict:
    mix = copy.deepcopy(manifest.traffic_file(manifest.cell(cell)))
    decode = mix["output_len"][1] > 1
    mix.update(prompt_len=[8, 40] if decode else [32, 96],
               output_len=[8, 24] if decode else [1, 1], warmup_s=0.3,
               warmup_decode_steps=4 if decode else 0, trace_s=0.5)
    return mix
