"""Confusion-matrix metrics on the device: the (C, C) matrix, mIoU and pixel
accuracy (the JAX package's `metrics/__init__.py`).

The matrix counts in int64, one `torch.bincount` of `t·C + p` over the
valid pixels an update, so every count is exact. The JAX package counts in
float32 with a scatter of 1.0 a pixel, and a cell stops growing at 2^24
(16,777,216) pixels; below that the two agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from torch_semantic_segmentation_tpu_torch.device import resolve_device


def new_confusion_matrix(num_classes: int,
                         device: str | torch.device | None = None
                         ) -> torch.Tensor:
    """A zero (C, C) int64 matrix on `device` (the card unless the caller
    passes "cpu")."""
    return torch.zeros((num_classes, num_classes), dtype=torch.int64,
                       device=resolve_device(device))


def update_confusion_matrix(cm: torch.Tensor, preds: torch.Tensor,
                            labels: torch.Tensor, *,
                            ignore_index: int = 255) -> torch.Tensor:
    """cm[t, p] + count(label == t and pred == p) over the valid pixels: a
    label other than `ignore_index` in [0, C). Returns a new matrix on cm's
    device."""
    c = cm.shape[0]
    labels = labels.to(cm.device).reshape(-1).long()
    preds = preds.to(cm.device).reshape(-1).long()
    valid = (labels != ignore_index) & (labels >= 0) & (labels < c)
    idx = labels[valid] * c + preds[valid]
    return cm + torch.bincount(idx, minlength=c * c).reshape(c, c)


def iou_from_confusion_matrix(cm) -> tuple[np.ndarray, float]:
    """Per-class IoU and mean IoU (the mean over classes with support), in
    float64 on the host, as the JAX package computes them."""
    cm = _host(cm)
    tp = np.diag(cm)
    denom = cm.sum(0) + cm.sum(1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(denom > 0, tp / denom, np.nan)
    miou = float(np.nanmean(iou)) if np.any(~np.isnan(iou)) else 0.0
    return iou, miou


def pixel_accuracy_from_confusion_matrix(cm) -> float:
    cm = _host(cm)
    total = cm.sum()
    return float(np.diag(cm).sum() / total) if total > 0 else 0.0


def _host(cm) -> np.ndarray:
    if isinstance(cm, torch.Tensor):
        cm = cm.detach().cpu().numpy()
    return np.asarray(cm, dtype=np.float64)


__all__ = [
    "new_confusion_matrix",
    "update_confusion_matrix",
    "iou_from_confusion_matrix",
    "pixel_accuracy_from_confusion_matrix",
]
