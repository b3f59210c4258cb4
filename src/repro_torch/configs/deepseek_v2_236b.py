"""DeepSeek-V2 236B [arXiv:2405.04434] — MoE 160e top-6, 2 shared, MLA kv_lora=512.

First layer uses a dense FFN (the paper's design); the remaining 59 are MoE.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,        # MLA: KV heads notionally = heads; cache is compressed
    head_dim=128,
    d_ff=12288,              # dense first-layer FFN width
    vocab_size=102400,
    prefix_pattern=("attn",),
    prefix_moe=(False,),
    block_pattern=("attn",),
    moe_pattern=(True,),
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        d_ff_expert=1536,
        num_shared_experts=2,
        d_ff_shared=1536,
        capacity_factor=1.25,
    ),
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    ffn_activation="swiglu",
    rope_theta=10000.0,
    max_seq_len=131072,
    source="arXiv:2405.04434 (DeepSeek-V2)",
).validate()
