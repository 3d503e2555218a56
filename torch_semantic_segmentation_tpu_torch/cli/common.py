"""Shared CLI plumbing of the port: dataset and loss construction from flags
(the JAX package's `cli/common.py`)."""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.losses import (
    SegLoss, aux_weighted_loss, cross_entropy_loss, ohem_cross_entropy,
    resize_cross_entropy_loss, resize_ohem_cross_entropy)


@dataclasses.dataclass
class DatasetBundle:
    dataset: tp.Any                      # indexable -> (uint8 HWC, uint8 HW)
    num_classes: int
    ignore_index: int
    class_names: tuple[str, ...]
    label_lut: np.ndarray | None         # raw id -> train id, or None
    class_weights: np.ndarray | None
    mean: tuple[float, float, float]
    std: tuple[float, float, float]
    palette: np.ndarray | None = None    # (num_classes, 3) uint8 RGB, or None


class _SyntheticDataset:
    """In-memory synthetic dataset for smoke runs (config 1)."""

    def __init__(self, n: int, h: int, w: int, num_classes: int, seed: int = 0):
        from torch_semantic_segmentation_tpu_torch.data.synthetic import (
            synthetic_uint8_batch)
        self.images, self.labels = synthetic_uint8_batch(
            n, h, w, num_classes, seed=seed)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.labels[i]


def build_dataset(name: str, root: str | None, split: str, *,
                  synthetic_size: tuple[int, int, int] = (16, 128, 256)
                  ) -> DatasetBundle:
    """The dataset `name` at `root` (the file datasets need it) and its
    metadata. `synthetic` and `shapes` live in memory at `synthetic_size`
    = (n, h, w); `shapes` draws its train and other splits from disjoint
    seeds."""
    from torch_semantic_segmentation_tpu_torch.data import camvid, cityscapes
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        CITYSCAPES_MEAN, CITYSCAPES_STD)

    if name in ("cityscapes", "camvid", "bdd", "mapillary") and root is None:
        raise ValueError(f"--dataset-dir is required for {name}")
    if name == "cityscapes":
        return DatasetBundle(
            dataset=cityscapes.CityscapesDataset(root, split),
            num_classes=cityscapes.NUM_CLASSES,
            ignore_index=cityscapes.IGNORE_INDEX,
            class_names=cityscapes.CLASS_NAMES,
            label_lut=cityscapes.label_lookup_table(),
            class_weights=cityscapes.enet_class_weights(),
            mean=CITYSCAPES_MEAN, std=CITYSCAPES_STD,
            palette=cityscapes.PALETTE)
    if name == "camvid":
        return DatasetBundle(
            dataset=camvid.CamVidDataset(root, split),
            num_classes=camvid.NUM_CLASSES,
            ignore_index=camvid.IGNORE_INDEX,
            class_names=camvid.CLASS_NAMES,
            label_lut=None,
            class_weights=camvid.enet_class_weights(),
            mean=CITYSCAPES_MEAN, std=CITYSCAPES_STD,
            palette=camvid.PALETTE)
    if name == "bdd":
        from torch_semantic_segmentation_tpu_torch.data import bdd
        return DatasetBundle(
            dataset=bdd.BDDDataset(root, split),
            num_classes=bdd.NUM_CLASSES,
            ignore_index=bdd.IGNORE_INDEX,
            class_names=bdd.CLASS_NAMES,
            label_lut=None,                      # masks are train-id encoded
            class_weights=cityscapes.enet_class_weights(),
            mean=CITYSCAPES_MEAN, std=CITYSCAPES_STD,
            palette=cityscapes.PALETTE)
    if name == "mapillary":
        from torch_semantic_segmentation_tpu_torch.data import mapillary
        ds = mapillary.MapillaryDataset(root, split)
        return DatasetBundle(
            dataset=ds,
            num_classes=ds.num_classes,
            ignore_index=mapillary.IGNORE_INDEX,
            class_names=ds.class_names,
            label_lut=ds.label_lookup_table(),
            class_weights=None,
            mean=CITYSCAPES_MEAN, std=CITYSCAPES_STD)
    if name == "synthetic":
        n, h, w = synthetic_size
        num_classes = 19
        return DatasetBundle(
            dataset=_SyntheticDataset(n, h, w, num_classes),
            num_classes=num_classes,
            ignore_index=255,
            class_names=cityscapes.CLASS_NAMES,
            label_lut=None,
            class_weights=None,
            mean=CITYSCAPES_MEAN, std=CITYSCAPES_STD)
    if name == "shapes":
        # the learnable synthetic task of the accuracy recipe; the split
        # decides the sample seed
        from torch_semantic_segmentation_tpu_torch.data.synthetic import (
            ShapesDataset)
        n, h, w = synthetic_size
        ds = ShapesDataset(n, h, w, seed=0 if split == "train" else 10_000)
        return DatasetBundle(
            dataset=ds,
            num_classes=ShapesDataset.NUM_CLASSES,
            ignore_index=255,
            class_names=ShapesDataset.CLASS_NAMES,
            label_lut=None,
            class_weights=None,
            mean=CITYSCAPES_MEAN, std=CITYSCAPES_STD)
    raise ValueError(f"unknown dataset '{name}' "
                     f"(cityscapes | camvid | bdd | mapillary | synthetic "
                     f"| shapes)")


def val_batches(bundle: DatasetBundle, batch_size: int, *, device,
                max_batches: int | None = None, drop_last: bool = False,
                eval_size: tuple[int, int] | None = None):
    """The validation stream of `bundle` in order, one pass: host batches
    (the bundle's LUT applied) → pinned prefetch to `device` → normalised
    images (resized to `eval_size` = (H, W) where given) and int32 labels,
    stopping after `max_batches` where given. Under a process group
    `batch_size` is the global batch and the rank reads its rows of each;
    every rank needs whole batches then (`drop_last=True`)."""
    from torch_semantic_segmentation_tpu_torch.data.pipeline import (
        batch_iterator, prefetch_to_device)
    from torch_semantic_segmentation_tpu_torch.parallel import distributed
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        normalize_batch)
    from torch_semantic_segmentation_tpu_torch.ops.upsample import (
        resize_bilinear)

    sample_slice = None
    if distributed.is_initialized():
        if not drop_last:
            raise ValueError("under a process group every rank reads whole "
                             "batches: pass drop_last=True")
        sample_slice = distributed.local_shard_range(batch_size)
    host = batch_iterator(bundle.dataset, batch_size, shuffle=False,
                          drop_last=drop_last, epochs=1,
                          label_lut=bundle.label_lut,
                          sample_slice=sample_slice)
    for i, (imgs, lbls) in enumerate(
            prefetch_to_device(host, size=2, device=device)):
        if max_batches is not None and i >= max_batches:
            return
        imgs = normalize_batch(imgs, mean=bundle.mean, std=bundle.std)
        if eval_size is not None:
            imgs = resize_bilinear(imgs, tuple(eval_size))
        yield imgs, lbls.to(torch.int32)


def build_seg_loss(loss: str, *, ignore_index: int,
                   class_weights: np.ndarray | None,
                   ohem_thresh: float = 0.7, ohem_min_kept: int = 100_000,
                   fused_resize: bool = False,
                   device: str | torch.device | None = None) -> SegLoss:
    """Per-output SegLoss from CLI flags. `fused_resize=True` selects the
    variants that upsample each head's low-res logits to the label grid
    inside the loss (K1 for CE, K3 for OHEM on the card), for models built
    with `upsample_logits=False`. Class weights become a float32 tensor on
    `device` (the card unless the caller passes "cpu")."""
    if loss not in ("ce", "ohem"):
        raise ValueError(f"unknown loss '{loss}' (ce | ohem)")
    cw = None if class_weights is None else torch.as_tensor(
        np.asarray(class_weights), dtype=torch.float32,
        device=resolve_device(device))
    if loss == "ce":
        if fused_resize:
            return SegLoss(
                lambda lg, lb: resize_cross_entropy_loss(
                    lg, lb, ignore_index=ignore_index, class_weights=cw),
                handles_resize=True, name="resize_ce")
        return SegLoss(
            lambda lg, lb: cross_entropy_loss(
                lg, lb, ignore_index=ignore_index, class_weights=cw),
            name="ce")
    if fused_resize:
        return SegLoss(
            lambda lg, lb: resize_ohem_cross_entropy(
                lg, lb, ignore_index=ignore_index, class_weights=cw,
                thresh=ohem_thresh, min_kept=ohem_min_kept),
            handles_resize=True, name="resize_ohem")
    return SegLoss(
        lambda lg, lb: ohem_cross_entropy(
            lg, lb, ignore_index=ignore_index, class_weights=cw,
            thresh=ohem_thresh, min_kept=ohem_min_kept),
        name="ohem")


def build_loss(loss: str, *, ignore_index: int, aux_weight: float,
               class_weights: np.ndarray | None, ohem_thresh: float = 0.7,
               ohem_min_kept: int = 100_000, fused_resize: bool = False,
               device: str | torch.device | None = None):
    """loss_fn(model_outputs, labels) handling single or (main, *aux)
    outputs."""
    base = build_seg_loss(loss, ignore_index=ignore_index,
                          class_weights=class_weights,
                          ohem_thresh=ohem_thresh,
                          ohem_min_kept=ohem_min_kept,
                          fused_resize=fused_resize, device=device)

    def loss_fn(outputs, labels):
        outs = outputs if isinstance(outputs, (tuple, list)) else [outputs]
        return aux_weighted_loss(outs, labels, loss_fn=base,
                                 aux_weight=aux_weight)

    return loss_fn
