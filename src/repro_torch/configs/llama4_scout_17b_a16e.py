"""Llama-4 Scout 17B-active/16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE top-1
+ shared expert, iRoPE chunked-local attention (3 chunked : 1 global)."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,           # 12 blocks of (3 chunked + 1 global)
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("attn_chunked", "attn_chunked", "attn_chunked", "attn"),
    moe_pattern=(True, True, True, True),
    window_size=8192,        # attention chunk size (iRoPE)
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192,
                  num_shared_experts=1, d_ff_shared=8192, capacity_factor=1.5),
    ffn_activation="swiglu",
    rope_theta=500000.0,
    max_seq_len=10485760,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
).validate()
