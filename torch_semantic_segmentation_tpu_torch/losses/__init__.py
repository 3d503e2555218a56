"""Losses of the port: class-weighted cross-entropy and OHEM cross-entropy
with `ignore_index`, and both on low-res logits upsampled to the label grid
inside the loss (the JAX package's `losses/__init__.py`).

Conventions are torch's `F.cross_entropy(weight=..., ignore_index=...)`:
the mean is weighted by the pixel's class weight,
sum(w_i · l_i) / max(sum(w_i), 1e−12), and ignored pixels count in neither
sum. Labels may be uint8, int32 or int64.

OHEM keeps the pixels whose true-class probability is below `thresh`, or,
where fewer than `min_kept` qualify, the `min_kept` hardest: the threshold
is min(−log thresh, the k-th largest valid loss). The k-th largest comes
from `torch.topk` for maps of at most 2^20 pixels, and above that from a
bisection of 26 steps on the value range that stays on the device (no host
sync). Its count of pixels at or above a candidate is an integer, where
the JAX package sums a float32: the two agree below 2^24 valid pixels. The
threshold takes no gradient.
"""

from __future__ import annotations

import math

import torch

from torch_semantic_segmentation_tpu_torch.ops.resize_ce import (
    per_pixel_resize_ce, resize_cross_entropy)
from torch_semantic_segmentation_tpu_torch.ops.upsample import (
    resize_bilinear_nhcw)


def _one_hot_pick(values: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor, dim: int) -> torch.Tensor:
    """`values` picked at each valid pixel's label along `dim` (`labels`
    has `values`' shape without `dim`), as the JAX package's one-hot
    product picks it: 0 where the label lies outside [0, C), which no
    class matches. So a label in [C, ignore_index) counts with true logit
    0, and with weight 0 under class weights, where a gather would raise."""
    inside = valid & (labels >= 0) & (labels < values.shape[dim])
    safe = torch.where(inside, labels, 0).long().unsqueeze(dim)
    return torch.where(inside, values.gather(dim, safe).squeeze(dim), 0.0)


def _per_pixel_ce(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel CE in float32 and the validity mask; logits (..., C)."""
    logits = logits.float()
    valid = labels != ignore_index
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = _one_hot_pick(logits, labels, valid, -1)
    return torch.where(valid, logz - true_logit, 0.0), valid


def _pixel_weights(labels: torch.Tensor, valid: torch.Tensor,
                   class_weights: torch.Tensor | None) -> torch.Tensor:
    """Per-pixel weight: the class weight (or 1) on valid pixels, else 0."""
    if class_weights is None:
        return valid.float()
    cw = torch.as_tensor(class_weights, dtype=torch.float32,
                         device=labels.device)
    return _one_hot_pick(cw.expand(*labels.shape, -1), labels, valid, -1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       ignore_index: int = 255,
                       class_weights: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Class-weighted CE with `ignore_index`. logits NHWC, labels NHW;
    returns a float32 scalar."""
    loss, valid = _per_pixel_ce(logits, labels, ignore_index)
    w = _pixel_weights(labels, valid, class_weights)
    return (loss * w).sum() / torch.clamp(w.sum(), min=1e-12)


def resize_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                              ignore_index: int = 255,
                              class_weights: torch.Tensor | None = None,
                              align_corners: bool = False) -> torch.Tensor:
    """CE of LOW-RES logits (N,h,w,C) bilinearly upsampled to the label
    grid (N,OH,OW), for models built with `upsample_logits=False`.

    bf16 logits go to the fused resize + CE op (`ops.resize_ce`, the Hopper
    kernel K1 on the card) when the sizes differ, `ignore_index` lies
    outside [0, C) and the class weights need no gradient. Otherwise the
    resize runs in the (N,OH,C,OW) layout in the logits' dtype and the CE in
    float32, as in the JAX package."""
    c = logits.shape[-1]
    oh, ow = labels.shape[1], labels.shape[2]
    if (logits.dtype == torch.bfloat16
            and (logits.shape[1], logits.shape[2]) != (oh, ow)
            and not 0 <= ignore_index < c
            and _class_weights_constant(class_weights)):
        return resize_cross_entropy(logits, labels, class_weights,
                                    align_corners=align_corners)

    x = resize_bilinear_nhcw(logits, (oh, ow), align_corners=align_corners,
                             out_dtype=logits.dtype)       # (N, OH, C, OW)
    xf = x.float()
    valid = labels != ignore_index
    logz = torch.logsumexp(xf, dim=2)
    true_logit = _one_hot_pick(xf, labels, valid, 2)
    loss = torch.where(valid, logz - true_logit, 0.0)
    wts = _pixel_weights(labels, valid, class_weights)
    return (loss * wts).sum() / torch.clamp(wts.sum(), min=1e-12)


def _class_weights_constant(class_weights) -> bool:
    return class_weights is None or not (
        isinstance(class_weights, torch.Tensor) and class_weights.requires_grad)


def _threshold_topk_exact(losses: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest of a 1-D tensor."""
    return torch.topk(losses, k, sorted=True).values[-1]


def _threshold_topk_histogram(losses: torch.Tensor, valid: torch.Tensor,
                              k: int, iters: int = 26) -> torch.Tensor:
    """A threshold t at most the k-th largest valid loss, with at least k
    valid losses ≥ t: `iters` halvings of [0, max + 1e−3], each a count of
    the losses at or above the midpoint, all on the device."""
    lossv = torch.where(valid, losses.float(), -1.0)
    lo = torch.zeros((), dtype=torch.float32, device=losses.device)
    hi = torch.clamp(lossv.max(), min=1e-6) + 1e-3
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ge = (lossv >= mid).sum() >= k
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    return lo


def _ohem_keep(flat: torch.Tensor, vflat: torch.Tensor, thresh: float,
               min_kept: int, exact: bool | None) -> torch.Tensor:
    """The mask of kept pixels of a flat loss map (no gradient)."""
    with torch.no_grad():
        n = flat.shape[0]
        k = min(int(min_kept), n)
        threshold = torch.tensor(-math.log(thresh), dtype=torch.float32,
                                 device=flat.device)
        if exact is None:
            exact = n <= (1 << 20)
        if k > 0:
            if exact:
                kth = _threshold_topk_exact(
                    torch.where(vflat, flat, -math.inf), k)
            else:
                kth = _threshold_topk_histogram(flat, vflat, k)
            threshold = torch.minimum(threshold, kth)
        return vflat & (flat >= threshold)


def _ohem_mean(flat: torch.Tensor, keep: torch.Tensor, labels: torch.Tensor,
               class_weights) -> torch.Tensor:
    w = _pixel_weights(labels.reshape(-1), keep, class_weights)
    return (flat * w).sum() / torch.clamp(w.sum(), min=1e-12)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                       ignore_index: int = 255, thresh: float = 0.7,
                       min_kept: int = 10_000,
                       class_weights: torch.Tensor | None = None,
                       exact: bool | None = None) -> torch.Tensor:
    """OHEM cross-entropy of full-resolution logits (N,H,W,C): the
    (class-weighted) mean of the kept pixels' losses. `min_kept` counts
    over the whole batch; `exact=None` takes the exact top-k for at most
    2^20 pixels and the bisection above."""
    loss, valid = _per_pixel_ce(logits, labels, ignore_index)
    flat, vflat = loss.reshape(-1), valid.reshape(-1)
    keep = _ohem_keep(flat, vflat, thresh, min_kept, exact)
    return _ohem_mean(flat, keep, labels, class_weights)


def resize_ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                              ignore_index: int = 255, thresh: float = 0.7,
                              min_kept: int = 10_000,
                              class_weights: torch.Tensor | None = None,
                              align_corners: bool = False) -> torch.Tensor:
    """OHEM cross-entropy of LOW-RES logits (N,h,w,C) bilinearly upsampled
    to the label grid (N,OH,OW), for models built with
    `upsample_logits=False`.

    The per-pixel loss map comes from the fused resize + CE op
    (`ops.resize_ce.per_pixel_resize_ce`, the Hopper kernel K3 on the
    card) under the rule by which `resize_cross_entropy_loss` takes K1:
    bf16 logits, sizes that differ, `ignore_index` outside [0, C) and
    class weights that need no gradient. Otherwise the resize runs in the
    (N,OH,C,OW) layout in the logits' dtype and the CE in float32, as in
    the JAX package. The selection and the mean follow on the map."""
    c = logits.shape[-1]
    oh, ow = labels.shape[1], labels.shape[2]
    valid = labels != ignore_index
    if (logits.dtype == torch.bfloat16
            and (logits.shape[1], logits.shape[2]) != (oh, ow)
            and not 0 <= ignore_index < c
            and _class_weights_constant(class_weights)):
        loss = per_pixel_resize_ce(logits, labels, align_corners=align_corners)
    else:
        x = resize_bilinear_nhcw(logits, (oh, ow), align_corners=align_corners,
                                 out_dtype=logits.dtype)   # (N, OH, C, OW)
        xf = x.float()
        logz = torch.logsumexp(xf, dim=2)
        true_logit = _one_hot_pick(xf, labels, valid, 2)
        loss = torch.where(valid, logz - true_logit, 0.0)
    flat, vflat = loss.reshape(-1), valid.reshape(-1)
    keep = _ohem_keep(flat, vflat, thresh, min_kept, None)
    return _ohem_mean(flat, keep, labels, class_weights)


__all__ = ["cross_entropy_loss", "ohem_cross_entropy",
           "resize_cross_entropy_loss", "resize_ohem_cross_entropy"]
