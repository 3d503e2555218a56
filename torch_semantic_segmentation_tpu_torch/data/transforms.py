"""Eval-time input transform: uint8 NHWC frames → normalised float."""

from __future__ import annotations

import torch

# ImageNet statistics, which the reference uses for Cityscapes
CITYSCAPES_MEAN = (0.485, 0.456, 0.406)
CITYSCAPES_STD = (0.229, 0.224, 0.225)


def normalize_batch(images: torch.Tensor, *, mean=CITYSCAPES_MEAN,
                    std=CITYSCAPES_STD,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 → (x/255 − mean)/std in float32, cast to `out_dtype`, on the
    images' device."""
    x = images.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    return ((x - m) / s).to(out_dtype)
