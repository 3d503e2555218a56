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

_ZOO = {"fastscnn": fastscnn, "unet": unet,
        "deeplabv3_resnet18": deeplabv3_resnet18,
        "deeplabv3_resnet34": deeplabv3_resnet34,
        "deeplabv3_resnet50": deeplabv3_resnet50,
        "deeplabv3_resnet101": deeplabv3_resnet101,
        "enet": enet, "bisenet": bisenet, "icnet": icnet,
        "contextnet": contextnet, "lednet": lednet, "erfnet": erfnet,
        "esnet": esnet}
_REGISTRY = dict(_ZOO)


def register(name: str):
    """Decorator: register a constructor `fn(num_classes, **kwargs)`
    under `name`, as the JAX package's `models.register` does;
    `get_model(name)` then builds it and `available_models()` lists it."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


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


# the models whose ops take H bands (spatial sharding): every zoo class
SPATIAL_MODELS = (FastSCNN, DeepLabV3, UNet, ENet, ERFNet, ESNet, BiSeNet,
                  ICNet, LEDNet, ContextNet)


def check_spatial_model(model) -> None:
    """Raise NotImplementedError under spatial sharding
    (`distributed.initialize(num_spatial > 1)`) for a module that is not
    one of the zoo's classes, or a name that is not a zoo name (`model` is
    a module or a zoo name): every zoo model's ops take H bands, and a
    module of another class has not been checked to."""
    if not distributed.is_spatial():
        return
    if (model in _ZOO if isinstance(model, str)
            else isinstance(model, SPATIAL_MODELS)):
        return
    name = model if isinstance(model, str) else type(model).__name__
    raise NotImplementedError(
        f"spatial sharding (num_spatial={distributed.num_spatial()}) takes "
        f"the zoo's models ({', '.join(sorted(_ZOO))}); {name} is not "
        "one of them, and its ops have not been checked on H bands")


__all__ = ["BiSeNet", "ContextNet", "DeepLabV3", "ENet", "ERFNet", "ESNet",
           "FastSCNN", "ICNet", "LEDNet", "UNet", "available_models",
           "bisenet", "check_spatial_model", "contextnet", "deeplabv3_resnet18",
           "deeplabv3_resnet34", "deeplabv3_resnet50", "deeplabv3_resnet101",
           "enet", "erfnet", "esnet", "fastscnn", "get_model", "icnet",
           "lednet", "register", "unet"]
