"""Mamba2-780m [arXiv:2405.21060] — attention-free SSM (state-space duality)."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=1,             # unused (attention-free); kept for config uniformity
    num_kv_heads=1,
    d_ff=0,                  # no FFN: mamba2 blocks are the whole layer
    vocab_size=50280,
    block_pattern=("ssm",),
    moe_pattern=(False,),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    max_seq_len=1048576,
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
).validate()
