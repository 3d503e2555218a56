"""Class weights from label-pixel frequencies (the JAX package's
`data/class_weights.py`, numpy only): ENet's w_c = 1 / ln(c + p_c)
(Paszke et al. 2016 §5.2), for the class-weighted cross-entropy of
`losses.cross_entropy_loss(class_weights=...)`."""

from __future__ import annotations

import numpy as np


def pixel_frequencies(dataset, num_classes: int, *,
                      label_lut: np.ndarray | None = None,
                      ignore_index: int = 255,
                      max_samples: int | None = None,
                      seed: int = 0) -> np.ndarray:
    """Each class's share of the valid label pixels over the dataset, or
    over `max_samples` items of it drawn from `seed`. `dataset[i]` returns
    (image, label); `label_lut` maps raw label ids first."""
    n = len(dataset)
    idxs = np.arange(n)
    if max_samples is not None and max_samples < n:
        idxs = np.random.default_rng(seed).choice(n, max_samples,
                                                  replace=False)
    counts = np.zeros(num_classes, dtype=np.int64)
    total = 0
    for i in idxs:
        _, lbl = dataset[int(i)]
        lbl = np.asarray(lbl)
        if label_lut is not None:
            lbl = label_lut[lbl]
        valid = lbl != ignore_index
        counts += np.bincount(lbl[valid].ravel().astype(np.int64),
                              minlength=num_classes)[:num_classes]
        total += int(valid.sum())
    return counts / max(total, 1)


def enet_class_weights(freq: np.ndarray, c: float = 1.02) -> np.ndarray:
    """w = 1 / ln(c + p), float32."""
    return (1.0 / np.log(c + np.asarray(freq))).astype(np.float32)


def compute_class_weights(dataset, num_classes: int, **kwargs) -> np.ndarray:
    """Frequencies over the dataset (`pixel_frequencies`' keywords), then
    ENet's weights."""
    return enet_class_weights(pixel_frequencies(dataset, num_classes,
                                                **kwargs))
