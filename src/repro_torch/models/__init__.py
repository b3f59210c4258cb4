from repro_torch.models.model import Model, build_model, unstack_layers

__all__ = ["Model", "build_model", "unstack_layers"]
