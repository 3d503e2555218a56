"""Synthetic Cityscapes-shaped data (the JAX package's `data/synthetic.py`,
numpy only, the same arrays for a seed): structured random images with
blob-wise label masks that include ignore_index regions, and
`ShapesDataset`, a learnable task for the accuracy recipe.
"""

from __future__ import annotations

import numpy as np


def synthetic_batch(
    batch: int,
    height: int,
    width: int,
    num_classes: int = 19,
    *,
    ignore_index: int = 255,
    ignore_frac: float = 0.05,
    seed: int = 0,
    dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images NHWC float normalised-ish, labels NHW int32)."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0.0, 1.0, (batch, height, width, 3)).astype(dtype)
    # blobby labels: low-res random classes upsampled (nearest)
    gh, gw = max(height // 32, 1), max(width // 32, 1)
    grid = rng.integers(0, num_classes, (batch, gh, gw)).astype(np.int32)
    labels = np.repeat(np.repeat(grid, height // gh + 1, 1), width // gw + 1, 2)
    labels = labels[:, :height, :width]
    if ignore_frac > 0:
        mask = rng.random((batch, height, width)) < ignore_frac
        labels = np.where(mask, ignore_index, labels).astype(np.int32)
    return images, labels


def synthetic_uint8_batch(batch: int, height: int, width: int,
                          num_classes: int = 19, *, seed: int = 0
                          ) -> tuple[np.ndarray, np.ndarray]:
    """uint8 images + labels — the raw form the augmentation pipeline eats."""
    images, labels = synthetic_batch(batch, height, width, num_classes,
                                     ignore_frac=0.0, seed=seed)
    images = ((images - images.min()) / (np.ptp(images) + 1e-6) * 255).astype(np.uint8)
    return images, labels.astype(np.uint8 if num_classes < 255 else np.int32)


class ShapesDataset:
    """Structured, *learnable* synthetic segmentation task: colored geometric
    shapes on a noisy background: accuracy and convergence evidence
    without a real dataset on disk.

    4 classes: 0 background, 1 rectangle, 2 disk, 3 diagonal stripe. Each
    class has a distinct (noisy) color, so a segmentation net must learn
    color + shape context; a correctly-wired model/loss/metric stack reaches
    val mIoU well above 0.8 within a few hundred small-crop steps, while a
    broken gradient path / label mapping / confusion-matrix stays near
    chance (~0.15). Samples are generated deterministically per (seed,
    index); use different seeds for train/val splits.
    """

    NUM_CLASSES = 4
    CLASS_NAMES = ("background", "rectangle", "disk", "stripe")
    _COLORS = np.array([[60, 60, 60],     # background: dark gray
                        [200, 70, 60],    # rectangle: red-ish
                        [60, 190, 80],    # disk: green-ish
                        [70, 90, 210]],   # stripe: blue-ish
                       np.int16)
    _NOISE = 28                           # per-pixel uniform color jitter

    def __init__(self, n: int, height: int = 64, width: int = 64, *,
                 seed: int = 0):
        self.n, self.h, self.w, self.seed = n, height, width, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, i))
        h, w = self.h, self.w
        lbl = np.zeros((h, w), np.uint8)
        ys, xs = np.mgrid[0:h, 0:w]

        # diagonal stripe (drawn first so shapes overlap it)
        off = rng.integers(-h, w)
        width_s = max(3, int(0.08 * (h + w) / 2))
        lbl[np.abs(xs - ys - off) < width_s] = 3
        # rectangle
        rh, rw = (int(rng.integers(h // 6, h // 2)),
                  int(rng.integers(w // 6, w // 2)))
        ry, rx = (int(rng.integers(0, h - rh)), int(rng.integers(0, w - rw)))
        lbl[ry:ry + rh, rx:rx + rw] = 1
        # disk
        r = int(rng.integers(min(h, w) // 8, min(h, w) // 3))
        cy, cx = (int(rng.integers(r, h - r)), int(rng.integers(r, w - r)))
        lbl[(ys - cy) ** 2 + (xs - cx) ** 2 < r * r] = 2

        img = self._COLORS[lbl].astype(np.int16)
        img = img + rng.integers(-self._NOISE, self._NOISE + 1,
                                 (h, w, 3), np.int16)
        return np.clip(img, 0, 255).astype(np.uint8), lbl
