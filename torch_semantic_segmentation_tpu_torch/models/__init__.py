"""Model zoo of the PyTorch port: the JAX package's 13 names (FastSCNN,
UNet, DeepLabV3 on four ResNets, ENet, BiSeNet, ICNet, ContextNet, LEDNet,
ERFNet and ESNet)."""

from torch_semantic_segmentation_tpu_torch.models.bisenet import (
    BiSeNet,
    bisenet,
)
from torch_semantic_segmentation_tpu_torch.models.contextnet import (
    ContextNet,
    contextnet,
)
from torch_semantic_segmentation_tpu_torch.models.deeplab import (
    DeepLabV3,
    deeplabv3_resnet18,
    deeplabv3_resnet34,
    deeplabv3_resnet50,
    deeplabv3_resnet101,
)
from torch_semantic_segmentation_tpu_torch.models.enet import ENet, enet
from torch_semantic_segmentation_tpu_torch.models.erfnet import ERFNet, erfnet
from torch_semantic_segmentation_tpu_torch.models.esnet import ESNet, esnet
from torch_semantic_segmentation_tpu_torch.models.fastscnn import (
    FastSCNN,
    fastscnn,
)
from torch_semantic_segmentation_tpu_torch.models.icnet import ICNet, icnet
from torch_semantic_segmentation_tpu_torch.models.lednet import LEDNet, lednet
from torch_semantic_segmentation_tpu_torch.models.unet import UNet, unet

_REGISTRY = {"fastscnn": fastscnn, "unet": unet,
             "deeplabv3_resnet18": deeplabv3_resnet18,
             "deeplabv3_resnet34": deeplabv3_resnet34,
             "deeplabv3_resnet50": deeplabv3_resnet50,
             "deeplabv3_resnet101": deeplabv3_resnet101,
             "enet": enet, "bisenet": bisenet, "icnet": icnet,
             "contextnet": contextnet, "lednet": lednet, "erfnet": erfnet,
             "esnet": esnet}


def get_model(name: str, num_classes: int = 19, **kwargs):
    """Build a zoo model by name; keyword arguments go to its constructor
    (`device`, `compute_dtype`, `seed`, ...)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](num_classes, **kwargs)


def available_models() -> list[str]:
    return sorted(_REGISTRY)


__all__ = ["BiSeNet", "ContextNet", "DeepLabV3", "ENet", "ERFNet", "ESNet",
           "FastSCNN", "ICNet", "LEDNet", "UNet", "available_models",
           "bisenet", "contextnet", "deeplabv3_resnet18",
           "deeplabv3_resnet34", "deeplabv3_resnet50", "deeplabv3_resnet101",
           "enet", "erfnet", "esnet", "fastscnn", "get_model", "icnet",
           "lednet", "unet"]
