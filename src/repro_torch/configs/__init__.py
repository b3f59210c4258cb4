"""Architecture registry of the PyTorch port: --arch <id> resolves here.

Only the all-"attn" MoE class the offload engine serves is registered so
far (the paper's own evaluation models); the other architectures of the
JAX package arrive with their model layers (ROADMAP, Queue 1 item 7)."""

from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    smoke_variant,
)

from repro_torch.configs import mixtral_8x7b, phi_moe  # noqa: E402

PAPER_ARCHS = {
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "phi-moe": phi_moe.CONFIG,
}

ARCHS = dict(PAPER_ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "PAPER_ARCHS", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "MoEConfig", "get_config", "smoke_variant"]
