"""Evaluation: the multi-scale (+ flip) eval step and the loop over
batches that gives mIoU (the JAX package's `eval.py`).

The multi-scale step resizes the input to each of a fixed set of scales
(sizes rounded to `size_divisor`), runs the model on it and on its mirror
image, resizes the softmax back to the label grid in the (N,H,C,W) layout
and sums it; the argmax over classes updates the int64 confusion matrix.

Under spatial sharding the step takes the rank's H band of each image,
as the JAX package's jitted step takes a batch sharded on its 'spatial'
axis: the scaled sizes are rounded from the global H (`global_rows`),
each scale's image gets its own split of whole blocks of the model's
`max_stride` rows (`distributed.split_rows`, recorded while the model
runs on it), and both resizes take the bands' rows of the global resize
between the two splits (`ops.upsample`, any ratio, a halo from both
splits). The flip mirrors W, which no band splits; the softmax and the
argmax are per pixel; each rank counts its band's pixels and `evaluate`
sums the matrices.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from torch_semantic_segmentation_tpu_torch import metrics
from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.models import check_spatial_model
from torch_semantic_segmentation_tpu_torch.ops.upsample import (
    resize_bilinear, resize_bilinear_nhcw)
from torch_semantic_segmentation_tpu_torch.parallel import (
    check_spatial_extent, distributed)


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
    `torch.inference_mode()`. Images are normalised NHWC floats. Under
    spatial sharding they and the labels are the rank's band
    (`parallel.shard_batch(spatial=True)`, any zoo model), and every
    scale runs on its own split; a scale whose image is degenerate on the
    bands (`check_spatial_extent`), and a band that is not the rank's
    band of the split `shard_batch` recorded (`distributed.check_band`),
    raise ValueError."""
    dev = resolve_device(device)
    check_spatial_model(model)
    max_stride = getattr(model, "max_stride", size_divisor)

    @torch.inference_mode()
    def step(cm: torch.Tensor, images, labels) -> torch.Tensor:
        images = torch.as_tensor(images).to(dev)
        labels = torch.as_tensor(labels).to(dev)
        distributed.check_band(images.shape[1], "images")
        distributed.check_band(labels.shape[1], "labels")
        model.eval()
        prob = _summed_probs(model, images, scales, flip, align_corners,
                             size_divisor, max_stride)
        preds = torch.argmax(prob, dim=2)
        return metrics.update_confusion_matrix(cm, preds, labels,
                                               ignore_index=ignore_index)

    return step


def _summed_probs(model: nn.Module, images: torch.Tensor, scales,
                  flip: bool, align_corners: bool, size_divisor: int,
                  max_stride: int) -> torch.Tensor:
    """The multi-scale step's summed softmaxes (N, H, C, W) of `images`
    (the rank's band under spatial sharding), in float32 (float64 for a
    float64 model)."""
    n, h, w, _ = images.shape
    bands = distributed.num_spatial()
    rows_in = distributed.global_rows(h)

    def round_div(v: float) -> int:
        return max(int(round(v / size_divisor)) * size_divisor, size_divisor)

    prob = None
    for s in scales:
        rows, cols = round_div(rows_in * s), round_div(w * s)
        split = None
        if bands > 1:
            try:
                check_spatial_extent(rows, bands, max_stride)
            except ValueError as e:
                raise ValueError(f"multi-scale eval at scale {s}: {e}") from e
            split = distributed.split_rows(rows, bands, max_stride)
        mine = rows if split is None else split[distributed.spatial_rank()]
        xs = resize_bilinear(images, (mine, cols), align_corners=align_corners,
                             out_split=split)
        for mirror in (False, True) if flip else (False,):
            with distributed.recorded_split(split):
                logits = _main_logits(model(xs.flip(2) if mirror else xs))
            if mirror:
                logits = logits.flip(2)
            acc = (torch.float64 if logits.dtype == torch.float64
                   else torch.float32)
            p = torch.softmax(resize_bilinear_nhcw(
                logits, (h, w), align_corners=align_corners, out_dtype=acc,
                in_split=split), dim=2)
            prob = p if prob is None else prob + p
    return prob


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
