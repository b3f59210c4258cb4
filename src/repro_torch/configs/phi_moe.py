"""Phi-MoE (Phi-3.5-MoE) [arXiv:2404.14219] — the paper's second model.
16 experts/layer, top-2, 32 layers (HOBBIT Table 1)."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi-moe",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    block_pattern=("attn",),
    moe_pattern=(True,),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400, capacity_factor=1.25),
    ffn_activation="swiglu",
    rope_theta=10000.0,
    max_seq_len=131072,
    source="arXiv:2404.14219 (Phi-3.5-MoE); HOBBIT Table 1",
).validate()
