"""Granite-3.0 2B base [hf:ibm-granite/granite-3.0-2b-base] — dense GQA."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    block_pattern=("attn",),
    moe_pattern=(False,),
    ffn_activation="swiglu",
    rope_theta=10000.0,
    max_seq_len=4096,
    source="hf:ibm-granite/granite-3.0-2b-base",
).validate()
