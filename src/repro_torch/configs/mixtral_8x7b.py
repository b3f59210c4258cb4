"""Mixtral-8x7B [arXiv:2401.04088] — the paper's primary evaluation model."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("attn",),
    moe_pattern=(True,),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336, capacity_factor=1.25),
    ffn_activation="swiglu",
    rope_theta=1000000.0,
    max_seq_len=32768,
    source="arXiv:2401.04088 (Mixtral of Experts); HOBBIT Table 1",
).validate()
