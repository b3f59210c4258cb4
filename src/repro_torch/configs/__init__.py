"""Architecture registry of the PyTorch port: --arch <id> resolves here.

Registered: the all-"attn" MoE class the offload engine serves (the
paper's own evaluation models), the dense all-"attn" family: Granite-3.0-2B,
Nemotron-4-15B (layernorm, squared-ReLU FFN, untied LM head) and
InternVL2-26B (its InternLM2 backbone behind 256 precomputed vision-patch
embeddings), and the windowed family on ring caches: Gemma-2-27B
(alternating 4096-token sliding-window and global layers, softcaps,
sandwich norms), Gemma-3-27B (5 local : 1 global, qk-norm) and
Llama-4-Scout-17B-16E (3 chunked : 1 global, top-1 MoE beside a shared
expert), DeepSeek-V2-236B (multi-head latent attention over a 512-wide
latent cache; a dense first layer, then 160 experts at top-6 beside 2
shared experts), and the state-space class: Mamba2-780m (48 Mamba-2 SSD
layers, no attention, no FFN) and Jamba-v0.1-52B (periods of 7 SSD layers
and one attention layer without positional encoding, 16 experts at top-2
in every other layer), and the encoder-decoder Whisper-tiny (a 4-layer
bidirectional encoder over 1500 precomputed audio frames, the conv/mel
frontend stubbed as in the JAX package, and 4 decoder layers with
cross-attention into it, sinusoidal absolute positions): every
architecture of the JAX package."""

from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    smoke_variant,
)

from repro_torch.configs import (  # noqa: E402
    deepseek_v2_236b,
    gemma2_27b,
    gemma3_27b,
    granite_3_2b,
    internvl2_26b,
    jamba_v0_1_52b,
    llama4_scout_17b_a16e,
    mamba2_780m,
    mixtral_8x7b,
    nemotron_4_15b,
    phi_moe,
    whisper_tiny,
)

PAPER_ARCHS = {
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "phi-moe": phi_moe.CONFIG,
}

# the JAX package's assigned architectures
ASSIGNED_ARCHS = {
    "deepseek-v2-236b": deepseek_v2_236b.CONFIG,
    "gemma2-27b": gemma2_27b.CONFIG,
    "gemma3-27b": gemma3_27b.CONFIG,
    "granite-3-2b": granite_3_2b.CONFIG,
    "internvl2-26b": internvl2_26b.CONFIG,
    "jamba-v0.1-52b": jamba_v0_1_52b.CONFIG,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
    "nemotron-4-15b": nemotron_4_15b.CONFIG,
    "whisper-tiny": whisper_tiny.CONFIG,
}

ARCHS = {**ASSIGNED_ARCHS, **PAPER_ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


# (arch, shape) pairs excluded from the dry-run matrix, with reasons (the
# JAX package's table)
LONG_CONTEXT_SKIPS = {
    "deepseek-v2-236b": "pure full attention (MLA is still global); no sub-quadratic variant",
    "granite-3-2b": "pure full attention",
    "nemotron-4-15b": "pure full attention",
    "internvl2-26b": "pure full attention backbone",
    "whisper-tiny": "enc-dec decoder context is 448 by construction",
}


def shape_supported(arch: str, shape_name: str) -> bool:
    if shape_name == "long_500k" and arch in LONG_CONTEXT_SKIPS:
        return False
    return True


__all__ = ["ARCHS", "ASSIGNED_ARCHS", "PAPER_ARCHS", "INPUT_SHAPES", "InputShape",
           "LONG_CONTEXT_SKIPS", "ModelConfig", "MoEConfig", "get_config",
           "shape_supported", "smoke_variant"]
