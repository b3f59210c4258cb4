from repro_torch.models.model import Batch, Model, build_model, unstack_layers

__all__ = ["Batch", "Model", "build_model", "unstack_layers"]
