"""Model zoo of the PyTorch port: FastSCNN, UNet and DeepLabV3 so far."""

from torch_semantic_segmentation_tpu_torch.models.deeplab import (
    DeepLabV3,
    deeplabv3_resnet18,
    deeplabv3_resnet34,
    deeplabv3_resnet50,
    deeplabv3_resnet101,
)
from torch_semantic_segmentation_tpu_torch.models.fastscnn import (
    FastSCNN,
    fastscnn,
)
from torch_semantic_segmentation_tpu_torch.models.unet import UNet, unet

_REGISTRY = {"fastscnn": fastscnn, "unet": unet,
             "deeplabv3_resnet18": deeplabv3_resnet18,
             "deeplabv3_resnet34": deeplabv3_resnet34,
             "deeplabv3_resnet50": deeplabv3_resnet50,
             "deeplabv3_resnet101": deeplabv3_resnet101}


def get_model(name: str, num_classes: int = 19, **kwargs):
    """Build a zoo model by name; keyword arguments go to its constructor
    (`device`, `compute_dtype`, `seed`, ...)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](num_classes, **kwargs)


def available_models() -> list[str]:
    return sorted(_REGISTRY)


__all__ = ["DeepLabV3", "FastSCNN", "UNet", "available_models",
           "deeplabv3_resnet18", "deeplabv3_resnet34", "deeplabv3_resnet50",
           "deeplabv3_resnet101", "fastscnn", "get_model", "unet"]
