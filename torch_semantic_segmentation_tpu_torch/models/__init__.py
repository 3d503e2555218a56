"""Model zoo of the PyTorch port: the JAX package's 13 names (FastSCNN,
UNet, DeepLabV3 on four ResNets, ENet, BiSeNet, ICNet, ContextNet, LEDNet,
ERFNet and ESNet)."""

import os

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
from torch_semantic_segmentation_tpu_torch.parallel import distributed

_REGISTRY = {"fastscnn": fastscnn, "unet": unet,
             "deeplabv3_resnet18": deeplabv3_resnet18,
             "deeplabv3_resnet34": deeplabv3_resnet34,
             "deeplabv3_resnet50": deeplabv3_resnet50,
             "deeplabv3_resnet101": deeplabv3_resnet101,
             "enet": enet, "bisenet": bisenet, "icnet": icnet,
             "contextnet": contextnet, "lednet": lednet, "erfnet": erfnet,
             "esnet": esnet}


def get_model(name: str, num_classes: int = 19, *, pretrained=None,
              **kwargs):
    """Build a zoo model by name; keyword arguments go to its constructor
    (`device`, `compute_dtype`, `seed`, ...).

    `pretrained` is a torch `.pth`/`.pt` file, or a directory holding
    `<name>.pth` or `<name>.pt`, loaded strictly after the build. Keys that
    do not match the canonical attribute paths are recovered by structural
    alignment (`compat.key_maps`), as in the JAX package."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    check_spatial_model(name)
    model = _REGISTRY[name](num_classes, **kwargs)
    if pretrained:
        from torch_semantic_segmentation_tpu_torch.compat.torch_loader import (
            load_torch_checkpoint)
        path = pretrained
        if os.path.isdir(path):
            path = os.path.join(path, f"{name}.pth")
            if not os.path.exists(path):
                path = path[:-4] + ".pt"
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"no {name}.pth / {name}.pt under '{pretrained}'")
        try:
            load_torch_checkpoint(model, path)
        except (KeyError, ValueError):
            # naming-scheme mismatch: fall back to structural alignment
            load_torch_checkpoint(model, path, auto_map=True)
    return model


def available_models() -> list[str]:
    return sorted(_REGISTRY)


# the models whose ops take H bands (spatial sharding), as classes and as
# zoo names
SPATIAL_MODELS = (FastSCNN, DeepLabV3, UNet, ENet, ERFNet, ESNet, BiSeNet,
                  ICNet)


def _spatial_name(name: str) -> bool:
    return (name in ("fastscnn", "unet", "enet", "erfnet", "esnet",
                     "bisenet", "icnet")
            or name.startswith("deeplabv3_"))


def check_spatial_model(model) -> None:
    """Raise NotImplementedError under spatial sharding
    (`distributed.initialize(num_spatial > 1)`) for any model but
    FastSCNN, DeepLabV3 (every depth), UNet, ENet, ERFNet, ESNet, BiSeNet
    and ICNet, the models whose ops take H bands so far (`model` is a module or a zoo
    name). The message names the zoo models still refused."""
    if not distributed.is_spatial():
        return
    if (_spatial_name(model) if isinstance(model, str)
            else isinstance(model, SPATIAL_MODELS)):
        return
    name = model if isinstance(model, str) else type(model).__name__
    refused = [n for n in sorted(_REGISTRY) if not _spatial_name(n)]
    raise NotImplementedError(
        f"spatial sharding (num_spatial={distributed.num_spatial()}) is "
        f"ported for FastSCNN, DeepLabV3, UNet, ENet, ERFNet, ESNet, "
        f"BiSeNet and ICNet; "
        f"{name} does not take H bands yet (still refused: "
        f"{', '.join(refused)})")


__all__ = ["BiSeNet", "ContextNet", "DeepLabV3", "ENet", "ERFNet", "ESNet",
           "FastSCNN", "ICNet", "LEDNet", "UNet", "available_models",
           "bisenet", "check_spatial_model", "contextnet", "deeplabv3_resnet18",
           "deeplabv3_resnet34", "deeplabv3_resnet50", "deeplabv3_resnet101",
           "enet", "erfnet", "esnet", "fastscnn", "get_model", "icnet",
           "lednet", "unet"]
