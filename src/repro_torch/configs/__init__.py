"""Architecture registry of the PyTorch port: --arch <id> resolves here.

Registered so far: the all-"attn" MoE class the offload engine serves (the
paper's own evaluation models) and the dense Granite-3.0-2B; the other
architectures of the JAX package arrive with their model layers (ROADMAP,
Queue 1 item 7)."""

from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    smoke_variant,
)

from repro_torch.configs import granite_3_2b, mixtral_8x7b, phi_moe  # noqa: E402

PAPER_ARCHS = {
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "phi-moe": phi_moe.CONFIG,
}

# the JAX package's assigned architectures ported so far
ASSIGNED_ARCHS = {
    "granite-3-2b": granite_3_2b.CONFIG,
}

ARCHS = {**ASSIGNED_ARCHS, **PAPER_ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ASSIGNED_ARCHS", "PAPER_ARCHS", "INPUT_SHAPES", "InputShape",
           "ModelConfig", "MoEConfig", "get_config", "smoke_variant"]
