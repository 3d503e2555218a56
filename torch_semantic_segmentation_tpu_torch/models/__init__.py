"""Model zoo of the PyTorch port. Only FastSCNN is ported so far."""

from torch_semantic_segmentation_tpu_torch.models.fastscnn import (
    FastSCNN,
    fastscnn,
)

_REGISTRY = {"fastscnn": fastscnn}


def get_model(name: str, num_classes: int = 19, **kwargs):
    """Build a zoo model by name; keyword arguments go to its constructor
    (`device`, `compute_dtype`, `seed`, ...)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](num_classes, **kwargs)


def available_models() -> list[str]:
    return sorted(_REGISTRY)


__all__ = ["FastSCNN", "fastscnn", "get_model", "available_models"]
