"""Mapillary Vistas dataset of the port (the JAX package's
`data/mapillary.py`).

Layout (Vistas v1.x/v2.0 research release):
  <root>/{training,validation,testing}/images/<name>.jpg
  <root>/{training,validation}/{labels,v2.0/labels}/<name>.png
  <root>/config.json  (or config_v2.0.json): {"labels": [{"name", "color",
                       "readable", "evaluate"}, ...]}

Masks store the label id in the PNG palette index (readable directly as a
grayscale index image). The class table is read from config.json, so
`num_classes` and `class_names` adapt to the release version (66 for v1.2,
124 for v2.0); non-`evaluate` classes map to `IGNORE_INDEX` through
`label_lookup_table()` — the same on-device LUT-gather mechanism as
Cityscapes' 33→19 mapping. Files decode through the native codecs
(`native_loader.decode_image`): a palette mask by libpng's palette-index
path, which keeps the index as the JAX package's PIL read does.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os

import numpy as np

from torch_semantic_segmentation_tpu_torch.data.native_loader import (
    decode_image)

IGNORE_INDEX = 255

_SPLIT_DIRS = {"train": "training", "val": "validation", "test": "testing"}


@dataclasses.dataclass
class MapillaryDataset:
    root: str
    split: str = "train"
    version: str = ""          # "" = v1.x layout, "v2.0" = v2 labels

    def __post_init__(self):
        cfg_name = ("config.json" if not self.version
                    else f"config_{self.version}.json")
        cfg_path = os.path.join(self.root, cfg_name)
        with open(cfg_path) as f:
            cfg = json.load(f)
        labels = cfg["labels"]
        # evaluated classes keep their order; the rest become ignore
        self.class_names = tuple(
            l["readable"] for l in labels if l.get("evaluate", True))
        self._eval_ids = [i for i, l in enumerate(labels)
                          if l.get("evaluate", True)]
        self.num_classes = len(self._eval_ids)

        sdir = _SPLIT_DIRS[self.split]
        img_dir = os.path.join(self.root, sdir, "images")
        lbl_sub = os.path.join(self.version, "labels") if self.version else "labels"
        lbl_dir = os.path.join(self.root, sdir, lbl_sub)
        self.image_paths = sorted(glob.glob(os.path.join(img_dir, "*.jpg")))
        if not self.image_paths:
            raise FileNotFoundError(f"no images under {img_dir}")
        self.label_paths = [
            os.path.join(lbl_dir,
                         os.path.splitext(os.path.basename(p))[0] + ".png")
            for p in self.image_paths
        ]

    def label_lookup_table(self) -> np.ndarray:
        """(256,) uint8 LUT raw-id → train-id (255 = ignore); applied as an
        on-device gather in the input pipeline."""
        lut = np.full((256,), IGNORE_INDEX, dtype=np.uint8)
        for train_id, raw_id in enumerate(self._eval_ids):
            lut[raw_id] = train_id
        return lut

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(image uint8 HWC RGB, raw label-id mask uint8 HW)."""
        img = decode_image(self.image_paths[i], 3)
        # Masks are palette-indexed PNGs where the palette INDEX is the label
        # id: the one-channel path keeps it (and a gray mask's value, alpha
        # dropped). A non-palette RGB(A) mask collapses to its first channel,
        # as the JAX package's read does.
        if _png_color_type(self.label_paths[i]) in (_PNG_RGB, _PNG_RGBA):
            return img, decode_image(self.label_paths[i], 3)[..., 0].copy()
        return img, decode_image(self.label_paths[i], 1)


_PNG_RGB, _PNG_RGBA = 2, 6


def _png_color_type(path: str) -> int:
    """The colour type of a PNG's IHDR chunk (byte 25 of the file)."""
    with open(path, "rb") as f:
        head = f.read(26)
    if len(head) < 26 or head[:8] != b"\x89PNG\r\n\x1a\n":
        raise IOError(f"not a PNG file: {path}")
    return head[25]
