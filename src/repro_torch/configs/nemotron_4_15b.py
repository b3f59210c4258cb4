"""Nemotron-4 15B [arXiv:2402.16819] — dense GQA, squared-ReLU MLP, layernorm."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    block_pattern=("attn",),
    moe_pattern=(False,),
    ffn_activation="sq_relu",
    norm_type="layernorm",
    tie_embeddings=False,
    rope_theta=10000.0,
    max_seq_len=4096,
    source="arXiv:2402.16819 (Nemotron-4 15B)",
).validate()
