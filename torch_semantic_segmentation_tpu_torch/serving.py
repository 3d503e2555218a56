"""Serving path: uint8 NHWC frames → class ids, probabilities or logits.

`make_predict_fn(model)` puts the model in eval mode, folds BatchNorm into
the convs (`ops.fold.fold_batchnorm`), normalises the frames on the device
and runs under `torch.inference_mode()`. With the model's compute dtype set
to bfloat16 the convs run in bf16. Models built with
`upsample_logits=False` return 1/8-resolution logits; for `output="ids"`
the ×8 resize runs fused with the argmax (`ops.resize_argmax`).
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from torch_semantic_segmentation_tpu_torch.data.transforms import (
    CITYSCAPES_MEAN, CITYSCAPES_STD)
from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.ops.fold import fold_batchnorm
from torch_semantic_segmentation_tpu_torch.ops.upsample import (
    resize_argmax, resize_bilinear)

_OUTPUTS = ("ids", "probs", "logits")


def make_predict_fn(
    model: nn.Module,
    *,
    fold_bn: bool = True,
    mean: tp.Sequence[float] = CITYSCAPES_MEAN,
    std: tp.Sequence[float] = CITYSCAPES_STD,
    output: str = "ids",
    device: str | torch.device | None = None,
) -> tp.Callable[[tp.Any], torch.Tensor]:
    """Build the predictor: uint8 NHWC frames (a tensor or numpy array) →
    a tensor on `device` (the card unless the caller passes "cpu")."""
    if output not in _OUTPUTS:
        raise ValueError(f"output must be one of {_OUTPUTS}, got {output!r}")
    dev = resolve_device(device)
    model.to(dev).eval()
    if fold_bn:
        fold_batchnorm(model)
    mean_a = torch.tensor(mean, dtype=torch.float32, device=dev) * 255.0
    std_a = torch.tensor(std, dtype=torch.float32, device=dev) * 255.0
    # low-res-logit models upsample here, with the model's own convention
    align_corners = bool(getattr(model, "align_corners", False))

    @torch.inference_mode()
    def predict(frames) -> torch.Tensor:
        frames = torch.as_tensor(frames).to(dev)
        x = (frames.float() - mean_a) / std_a
        logits = model(x)
        if isinstance(logits, (tuple, list)):
            logits = logits[0]
        size = (frames.shape[1], frames.shape[2])
        low_res = (logits.shape[1], logits.shape[2]) != size
        if output == "ids":
            if low_res:
                return resize_argmax(logits, size, align_corners=align_corners)
            return torch.argmax(logits, dim=-1).to(torch.uint8)
        if low_res:
            logits = resize_bilinear(logits, size, align_corners=align_corners)
        if output == "probs":
            return F.softmax(logits.float(), dim=-1)
        return logits

    return predict
