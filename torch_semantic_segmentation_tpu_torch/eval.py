"""Evaluation: the multi-scale (+ flip) eval step and the loop over
batches that gives mIoU (the JAX package's `eval.py`).

The multi-scale step resizes the input to each of a fixed set of scales
(sizes rounded to `size_divisor`), runs the model on it and on its mirror
image, resizes the softmax back to the label grid in the (N,H,C,W) layout
and sums it; the argmax over classes updates the int64 confusion matrix.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from torch_semantic_segmentation_tpu_torch import metrics
from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.ops.upsample import (
    resize_bilinear, resize_bilinear_nhcw)
from torch_semantic_segmentation_tpu_torch.parallel import distributed


def _main_logits(outputs) -> torch.Tensor:
    return outputs[0] if isinstance(outputs, (tuple, list)) else outputs


def make_multiscale_eval_step(
    model: nn.Module,
    *,
    num_classes: int,
    scales: tp.Sequence[float] = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75),
    flip: bool = True,
    ignore_index: int = 255,
    align_corners: bool = False,
    size_divisor: int = 32,
    device: str | torch.device | None = None,
) -> tp.Callable[[torch.Tensor, tp.Any, tp.Any], torch.Tensor]:
    """The multi-scale eval step: `step(cm, images, labels) -> cm`, on
    `device` (the card unless the caller passes "cpu"; the model must
    already be there), the model in eval mode under
    `torch.inference_mode()`. Images are normalised NHWC floats. Not
    under spatial sharding (`NotImplementedError`): its rescaled inputs
    are not bands of the frame."""
    dev = resolve_device(device)
    if distributed.is_spatial():
        raise NotImplementedError(
            "the multi-scale eval step under spatial sharding: the "
            "single-scale eval step (`train.make_eval_step`) takes H bands "
            "of FastSCNN, DeepLabV3, UNet, ENet, ERFNet, ESNet, BiSeNet and "
            "ICNet")

    def round_div(v: float) -> int:
        return max(int(round(v / size_divisor)) * size_divisor, size_divisor)

    def probs(logits, size):
        x = resize_bilinear_nhcw(logits, size, align_corners=align_corners)
        return torch.softmax(x, dim=2)

    @torch.inference_mode()
    def step(cm: torch.Tensor, images, labels) -> torch.Tensor:
        images = torch.as_tensor(images).to(dev)
        labels = torch.as_tensor(labels).to(dev)
        model.eval()
        n, h, w, _ = images.shape
        prob = torch.zeros((n, h, num_classes, w), dtype=torch.float32,
                           device=dev)
        for s in scales:
            xs = resize_bilinear(images, (round_div(h * s), round_div(w * s)),
                                 align_corners=align_corners)
            prob = prob + probs(_main_logits(model(xs)), (h, w))
            if flip:
                logits = _main_logits(model(xs.flip(2))).flip(2)
                prob = prob + probs(logits, (h, w))
        preds = torch.argmax(prob, dim=2)
        return metrics.update_confusion_matrix(cm, preds, labels,
                                               ignore_index=ignore_index)

    return step


def evaluate(eval_step, batches: tp.Iterable[tuple[tp.Any, tp.Any]], *,
             num_classes: int, device: str | torch.device | None = None):
    """Run an eval step over batches; returns (per-class IoU, mIoU, cm).
    Only the final (C, C) matrix leaves the device. Under a process group
    each rank runs its own batches (its rows of the global ones) and the
    int64 matrix is summed over ranks once, at the end, so every rank gets
    the single-process matrix."""
    cm = metrics.new_confusion_matrix(num_classes, device)
    for images, labels in batches:
        cm = eval_step(cm, images, labels)
    cm = distributed.reduce_sum(cm)
    iou, miou = metrics.iou_from_confusion_matrix(cm)
    return iou, miou, cm
