"""Whisper-tiny [arXiv:2212.04356] — enc-dec audio; conv/mel frontend STUBBED.

input_specs provides precomputed frame embeddings (1500, 384) — the conv
feature extractor is the one allowed stub.  The decoder (what we build in
full) is a 4-layer transformer with cross-attention into the encoder states.
"""

from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    block_pattern=("attn",),
    moe_pattern=(False,),
    encoder=EncoderConfig(num_layers=4, d_model=384, num_heads=6, d_ff=1536, seq_len=1500),
    frontend="audio_frames",
    ffn_activation="gelu",
    norm_type="layernorm",
    rope_theta=0.0,          # whisper uses learned/sinusoidal positions, not rope
    max_seq_len=448,
    source="arXiv:2212.04356 (Whisper)",
).validate()
