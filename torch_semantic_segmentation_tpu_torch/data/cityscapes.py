"""Cityscapes dataset of the port (the JAX package's `data/cityscapes.py`):
file pairing + 33→19 train-id label mapping.

Layout (official):
  <root>/leftImg8bit/<split>/<city>/<name>_leftImg8bit.png
  <root>/gtFine/<split>/<city>/<name>_gtFine_labelIds.png

The 33 raw label ids map to 19 train ids + 255 ignore per the official
cityscapesScripts `labels.py` table. The native loader applies it during
its copy (`label_lut=label_lookup_table()`); `batch_iterator` applies it to
each decoded mask. Files decode through the native codecs
(`native_loader.decode_image`), not cv2 or PIL.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from torch_semantic_segmentation_tpu_torch.data.native_loader import (
    decode_image)

NUM_CLASSES = 19
IGNORE_INDEX = 255

CLASS_NAMES = (
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
)

# Train-id colors (official cityscapesScripts labels.py, same order as
# CLASS_NAMES) — used by the predict CLI to colorize id masks.
PALETTE = np.array([
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
    (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
    (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
    (0, 0, 230), (119, 11, 32),
], dtype=np.uint8)

# raw label id -> train id (official cityscapesScripts mapping)
_ID_TO_TRAIN_ID = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}


def label_lookup_table() -> np.ndarray:
    """(256,) uint8 LUT: raw id -> train id (255 = ignore): `lut[labels]`."""
    lut = np.full((256,), IGNORE_INDEX, dtype=np.uint8)
    for k, v in _ID_TO_TRAIN_ID.items():
        lut[k] = v
    return lut


def encode_labels(raw: np.ndarray) -> np.ndarray:
    """Map raw labelIds to train ids (host-side convenience; the loaders
    apply `label_lookup_table` themselves)."""
    return label_lookup_table()[raw]


# ENet-style class weights w = 1/ln(c + p_class), c=1.02, computed from the
# official train-split pixel frequencies (SURVEY.md §2.5 "Class-weight
# computation"). Precomputed so training needs no dataset scan.
_TRAIN_PIXEL_FREQ = np.array([
    0.32721, 0.05413, 0.20264, 0.00582, 0.00781, 0.01091, 0.00184, 0.00490,
    0.14102, 0.01027, 0.03554, 0.01077, 0.00119, 0.06196, 0.00235, 0.00207,
    0.00205, 0.00087, 0.00365,
])


def enet_class_weights(freq: np.ndarray | None = None, c: float = 1.02) -> np.ndarray:
    freq = _TRAIN_PIXEL_FREQ if freq is None else freq
    return (1.0 / np.log(c + freq)).astype(np.float32)


@dataclasses.dataclass
class CityscapesDataset:
    """File-pairing dataset: index -> (image_path, label_path), decoded on
    demand on the host by the native codecs; augmentation runs on the
    card."""

    root: str
    split: str = "train"

    def __post_init__(self):
        img_glob = os.path.join(self.root, "leftImg8bit", self.split, "*",
                                "*_leftImg8bit.png")
        self.image_paths = sorted(glob.glob(img_glob))
        self.label_paths = [
            p.replace(os.sep + "leftImg8bit" + os.sep,
                      os.sep + "gtFine" + os.sep)
             .replace("_leftImg8bit.png", "_gtFine_labelIds.png")
            for p in self.image_paths
        ]
        missing = [p for p in self.label_paths if not os.path.exists(p)]
        if self.image_paths and missing:
            raise FileNotFoundError(
                f"{len(missing)} gtFine labels missing, e.g. {missing[0]}")

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (image uint8 HWC RGB, raw labelIds uint8 HW)."""
        return (decode_image(self.image_paths[i], 3),
                decode_image(self.label_paths[i], 1))
