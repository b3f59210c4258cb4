"""The Mixtral / Phi-3.5-MoE block: grouped-query attention with RoPE,
top-k softmax routing renormalised over the chosen experts, SwiGLU
experts, every layer one attention and one MoE sub-layer.  The arithmetic
lives in ``benchlib/spec.py``, ``benchlib/weights.py``, ``benchlib/flops.py``
and ``reference/plain.py``."""

from __future__ import annotations

from benchlib import flops, spec as specs, weights

REFERENCE = "plain"
plain_spec = specs.plain_spec
port_config = specs.port_config
make_weights = weights.make_weights
token_flops = flops.token_flops
chunk_flops = flops.chunk_flops


def smoke_config(cfg: dict, *, width: int = 64, layers: int = 2, vocab: int = 512,
                 experts: int = 0) -> dict:
    """Width `width`, 4 / 2 heads, `layers` layers, a vocabulary of `vocab`,
    `experts` experts (default 4 for 8, else 8), a small expert cache,
    groups of 16, pages and chunks of 16."""
    cfg = dict(cfg, hidden_size=width, intermediate_size=width, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=layers, vocab_size=vocab,
               num_local_experts=experts or (4 if cfg["num_local_experts"] == 8 else 8))
    cfg["engine"] = dict(cfg["engine"], hi_slots=4, lo_slots=2, group_size=16,
                         kv_page_size=16, prefill_chunk=16)
    return cfg
