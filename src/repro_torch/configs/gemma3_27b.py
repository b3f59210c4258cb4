"""Gemma-3 27B [hf:google/gemma-3-1b-pt family] — 5:1 local:global, 128k, qk-norm."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,           # 10 blocks of (5 local + 1 global) + 2 tail local
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    block_pattern=("attn_local",) * 5 + ("attn",),
    moe_pattern=(False,) * 6,
    window_size=1024,
    qk_norm=True,
    sandwich_norm=True,
    scale_embedding=True,
    ffn_activation="swiglu",
    rope_theta=1000000.0,
    max_seq_len=131072,
    source="hf:google/gemma-3-1b-pt (Gemma 3 family card)",
).validate()
