"""Model zoo of the PyTorch port: FastSCNN, UNet, DeepLabV3, ENet, BiSeNet
and ICNet so far."""

from torch_semantic_segmentation_tpu_torch.models.bisenet import (
    BiSeNet,
    bisenet,
)
from torch_semantic_segmentation_tpu_torch.models.deeplab import (
    DeepLabV3,
    deeplabv3_resnet18,
    deeplabv3_resnet34,
    deeplabv3_resnet50,
    deeplabv3_resnet101,
)
from torch_semantic_segmentation_tpu_torch.models.enet import ENet, enet
from torch_semantic_segmentation_tpu_torch.models.fastscnn import (
    FastSCNN,
    fastscnn,
)
from torch_semantic_segmentation_tpu_torch.models.icnet import ICNet, icnet
from torch_semantic_segmentation_tpu_torch.models.unet import UNet, unet

_REGISTRY = {"fastscnn": fastscnn, "unet": unet,
             "deeplabv3_resnet18": deeplabv3_resnet18,
             "deeplabv3_resnet34": deeplabv3_resnet34,
             "deeplabv3_resnet50": deeplabv3_resnet50,
             "deeplabv3_resnet101": deeplabv3_resnet101,
             "enet": enet, "bisenet": bisenet, "icnet": icnet}


def get_model(name: str, num_classes: int = 19, **kwargs):
    """Build a zoo model by name; keyword arguments go to its constructor
    (`device`, `compute_dtype`, `seed`, ...)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](num_classes, **kwargs)


def available_models() -> list[str]:
    return sorted(_REGISTRY)


__all__ = ["BiSeNet", "DeepLabV3", "ENet", "FastSCNN", "ICNet", "UNet",
           "available_models", "bisenet", "deeplabv3_resnet18",
           "deeplabv3_resnet34", "deeplabv3_resnet50", "deeplabv3_resnet101",
           "enet", "fastscnn", "get_model", "icnet", "unet"]
