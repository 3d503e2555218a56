"""BDD100K / DeepDrive segmentation dataset of the port (the JAX package's
`data/bdd.py`).

Layout (official BDD100K seg release):
  <root>/images/10k/{train,val,test}/<name>.jpg
  <root>/labels/sem_seg/masks/{train,val}/<name>.png   (train-id masks)
Older drivable/seg releases use <root>/seg/images/<split> +
<root>/seg/labels/<split>; both are probed.

Masks are already Cityscapes-train-id encoded (19 classes, 255 = void), so
no LUT is needed — the label space matches `data.cityscapes`. Files decode
through the native codecs (`native_loader.decode_image`; JPEG by libjpeg).
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from torch_semantic_segmentation_tpu_torch.data.cityscapes import (
    CLASS_NAMES, IGNORE_INDEX, NUM_CLASSES)
from torch_semantic_segmentation_tpu_torch.data.native_loader import (
    decode_image)

__all__ = ["BDDDataset", "NUM_CLASSES", "IGNORE_INDEX", "CLASS_NAMES"]


@dataclasses.dataclass
class BDDDataset:
    root: str
    split: str = "train"

    def __post_init__(self):
        candidates = [
            (os.path.join(self.root, "images", "10k", self.split),
             os.path.join(self.root, "labels", "sem_seg", "masks", self.split)),
            (os.path.join(self.root, "seg", "images", self.split),
             os.path.join(self.root, "seg", "labels", self.split)),
        ]
        for img_dir, lbl_dir in candidates:
            imgs = sorted(glob.glob(os.path.join(img_dir, "*.jpg")))
            if imgs:
                break
        else:
            raise FileNotFoundError(
                f"no BDD images under {self.root} (tried "
                f"{[c[0] for c in candidates]})")
        self.image_paths = imgs
        self.label_paths = []
        for p in imgs:
            name = os.path.splitext(os.path.basename(p))[0]
            for suffix in (".png", "_train_id.png"):
                lp = os.path.join(lbl_dir, name + suffix)
                if os.path.exists(lp):
                    self.label_paths.append(lp)
                    break
            else:
                raise FileNotFoundError(f"no mask for {p} in {lbl_dir}")

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(image uint8 HWC RGB, train-id mask uint8 HW)."""
        return (decode_image(self.image_paths[i], 3),
                decode_image(self.label_paths[i], 1))
