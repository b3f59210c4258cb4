"""Jamba v0.1 52B [arXiv:2403.19887] — hybrid Mamba+attention 1:7, MoE 16e top-2.

One Jamba block = 8 layers with a single attention layer (index 4 in the
released model) and MoE replacing the MLP every other layer (odd indices).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,           # 4 blocks of period 8
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm"),
    moe_pattern=(False, True, False, True, False, True, False, True),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336, capacity_factor=1.25),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    ffn_activation="swiglu",
    rope_theta=10000.0,      # jamba attention layers use no positional encoding;
    max_seq_len=262144,      # we keep rope off for them via use_rope=False in model
    source="arXiv:2403.19887 (Jamba)",
).validate()
