"""Gemma-2 27B [arXiv:2408.00118] — dense, local+global alternating, softcaps."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    block_pattern=("attn_local", "attn"),   # alternating 4096-window local / global
    moe_pattern=(False, False),
    window_size=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    ffn_activation="swiglu",
    sandwich_norm=True,
    scale_embedding=True,
    rope_theta=10000.0,
    max_seq_len=8192,
    source="arXiv:2408.00118 (Gemma 2)",
).validate()
