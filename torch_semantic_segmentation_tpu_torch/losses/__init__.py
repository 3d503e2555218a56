"""Losses of the port: class-weighted cross-entropy with `ignore_index`,
and the same loss on low-res logits upsampled to the label grid inside the
loss (the JAX package's `losses/__init__.py`).

Conventions are torch's `F.cross_entropy(weight=..., ignore_index=...)`:
the mean is weighted by the pixel's class weight,
sum(w_i · l_i) / max(sum(w_i), 1e−12), and ignored pixels count in neither
sum. Labels may be uint8, int32 or int64.
"""

from __future__ import annotations

import torch

from torch_semantic_segmentation_tpu_torch.ops.resize_ce import (
    resize_cross_entropy)
from torch_semantic_segmentation_tpu_torch.ops.upsample import (
    resize_bilinear_nhcw)


def _per_pixel_ce(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel CE in float32 and the validity mask; logits (..., C)."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    return torch.where(valid, logz - true_logit, 0.0), valid


def _pixel_weights(labels: torch.Tensor, valid: torch.Tensor,
                   class_weights: torch.Tensor | None) -> torch.Tensor:
    """Per-pixel weight: the class weight (or 1) on valid pixels, else 0."""
    if class_weights is None:
        return valid.float()
    cw = torch.as_tensor(class_weights, dtype=torch.float32,
                         device=labels.device)
    safe = torch.where(valid, labels, 0).long()
    return torch.where(valid, cw[safe], 0.0)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       ignore_index: int = 255,
                       class_weights: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Class-weighted CE with `ignore_index`. logits NHWC, labels NHW;
    returns a float32 scalar."""
    loss, valid = _per_pixel_ce(logits, labels, ignore_index)
    w = _pixel_weights(labels, valid, class_weights)
    return (loss * w).sum() / torch.clamp(w.sum(), min=1e-12)


def resize_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                              ignore_index: int = 255,
                              class_weights: torch.Tensor | None = None,
                              align_corners: bool = False) -> torch.Tensor:
    """CE of LOW-RES logits (N,h,w,C) bilinearly upsampled to the label
    grid (N,OH,OW), for models built with `upsample_logits=False`.

    bf16 logits go to the fused resize + CE op (`ops.resize_ce`, the Hopper
    kernel K1 on the card) when the sizes differ, `ignore_index` lies
    outside [0, C) and the class weights need no gradient. Otherwise the
    resize runs in the (N,OH,C,OW) layout in the logits' dtype and the CE in
    float32, as in the JAX package."""
    c = logits.shape[-1]
    oh, ow = labels.shape[1], labels.shape[2]
    cw_const = class_weights is None or not (
        isinstance(class_weights, torch.Tensor) and class_weights.requires_grad)
    if (logits.dtype == torch.bfloat16
            and (logits.shape[1], logits.shape[2]) != (oh, ow)
            and not 0 <= ignore_index < c
            and cw_const):
        return resize_cross_entropy(logits, labels, class_weights,
                                    align_corners=align_corners)

    x = resize_bilinear_nhcw(logits, (oh, ow), align_corners=align_corners,
                             out_dtype=logits.dtype)       # (N, OH, C, OW)
    xf = x.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(xf, dim=2)
    true_logit = xf.gather(2, safe.unsqueeze(2)).squeeze(2)
    loss = torch.where(valid, logz - true_logit, 0.0)
    wts = _pixel_weights(labels, valid, class_weights)
    return (loss * wts).sum() / torch.clamp(wts.sum(), min=1e-12)


__all__ = ["cross_entropy_loss", "resize_cross_entropy_loss"]
