"""InternVL2-26B [arXiv:2404.16821] — InternViT (stub) + InternLM2-20B backbone.

The vision tower is not modelled: callers pass precomputed patch embeddings
(256 tokens after pixel-shuffle) as ``Batch.prefix_embeds``, prepended to the
text embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    block_pattern=("attn",),
    moe_pattern=(False,),
    frontend="vision_patches",
    num_prefix_tokens=256,
    ffn_activation="swiglu",
    rope_theta=1000000.0,
    max_seq_len=32768,
    source="arXiv:2404.16821 (InternVL2; InternLM2 backbone)",
).validate()
