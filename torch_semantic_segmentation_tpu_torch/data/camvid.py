"""CamVid dataset of the port (the JAX package's `data/camvid.py`): 11
classes + void (BASELINE.json config 3 pairs it with UNet).

Supports the two common on-disk layouts:
- index masks (SegNet-tutorial style: `<root>/{train,val,test}` +
  `{split}annot` directories, masks are uint8 class indices, 11 = void)
- RGB-coded masks (original CamVid release) via the 11-class palette.

Files decode through the native codecs (`native_loader.decode_image`).
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from torch_semantic_segmentation_tpu_torch.data.native_loader import (
    decode_image)

NUM_CLASSES = 11
IGNORE_INDEX = 255

CLASS_NAMES = (
    "sky", "building", "pole", "road", "pavement", "tree", "sign",
    "fence", "car", "pedestrian", "bicyclist",
)

# RGB palette of the 11-class grouping (original CamVid colors)
PALETTE = np.array([
    (128, 128, 128),  # sky
    (128, 0, 0),      # building
    (192, 192, 128),  # pole
    (128, 64, 128),   # road
    (0, 0, 192),      # pavement
    (128, 128, 0),    # tree
    (192, 128, 128),  # sign
    (64, 64, 128),    # fence
    (64, 0, 128),     # car
    (64, 64, 0),      # pedestrian
    (0, 128, 192),    # bicyclist
], dtype=np.uint8)

# ENet-paper CamVid class weights (same 1/ln(c+p) scheme as Cityscapes)
_TRAIN_PIXEL_FREQ = np.array([
    0.1684, 0.2411, 0.0091, 0.2869, 0.0942, 0.1229, 0.0062, 0.0097, 0.0478,
    0.0085, 0.0052,
])


def enet_class_weights(freq: np.ndarray | None = None, c: float = 1.02) -> np.ndarray:
    freq = _TRAIN_PIXEL_FREQ if freq is None else freq
    return (1.0 / np.log(c + freq)).astype(np.float32)


def rgb_mask_to_index(mask_rgb: np.ndarray) -> np.ndarray:
    """RGB-coded mask -> class indices (unknown colors -> IGNORE_INDEX)."""
    out = np.full(mask_rgb.shape[:2], IGNORE_INDEX, dtype=np.uint8)
    for idx, color in enumerate(PALETTE):
        out[np.all(mask_rgb == color, axis=-1)] = idx
    return out


@dataclasses.dataclass
class CamVidDataset:
    root: str
    split: str = "train"

    def __post_init__(self):
        img_dir = os.path.join(self.root, self.split)
        ann_dir = os.path.join(self.root, self.split + "annot")
        if os.path.isdir(ann_dir):  # SegNet-tutorial index-mask layout
            self.rgb_masks = False
            self.image_paths = sorted(glob.glob(os.path.join(img_dir, "*.png")))
            self.label_paths = [os.path.join(ann_dir, os.path.basename(p))
                                for p in self.image_paths]
        else:  # `images/` + `labels/` RGB layout
            self.rgb_masks = True
            self.image_paths = sorted(
                glob.glob(os.path.join(self.root, "images", self.split, "*.png")))
            self.label_paths = [
                p.replace(os.sep + "images" + os.sep, os.sep + "labels" + os.sep)
                 .replace(".png", "_L.png")
                for p in self.image_paths
            ]

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        img = decode_image(self.image_paths[i], 3)
        if self.rgb_masks:
            lbl = rgb_mask_to_index(decode_image(self.label_paths[i], 3))
        else:
            lbl = decode_image(self.label_paths[i], 1)
            # SegNet layout uses 11 for void
            lbl = np.where(lbl == NUM_CLASSES, IGNORE_INDEX, lbl).astype(np.uint8)
        return img, lbl
