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

Under a process group (`parallel.distributed`) each rank holds its rows
of the global batch and every loss returns the rank's share of the global
batch's loss: its own Σ w·l over the global Σ w, so the shares sum over
ranks to the single-process loss. OHEM's route, its k-th largest loss and
`min_kept` are the global batch's too (an all-gather for the exact top-k,
a max and 26 counts reduced over ranks for the bisection). The fused K1
returns the rank's own ratio, rescaled by its Σ w over the global one.
Without a group none of this runs.

Under spatial sharding the logits and labels are an H band of the
images. A full-resolution loss needs nothing more: the band's pixels over
the global Σ w. A loss of low-res logits takes one halo row of logits each
side (none at the image's global top and bottom) and pads the labels with
k rows of `ignore_index` for each: the ×k resize of band + halo gives
every band pixel its global logits (`ops.upsample`), the padded pixels
weigh 0, and the halo rows' gradients go back to their bands. The fused
kernels run as they are.

`aux_weighted_loss` sums a main head's loss and the aux heads' (BiSeNet,
ICNet). A loss that upsamples low-res logits itself declares
`handles_resize` (`resize_cross_entropy_loss`, `resize_ohem_cross_entropy`,
or a `SegLoss` built with it); any other gets each head resized to the
label grid first.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch

from torch_semantic_segmentation_tpu_torch.ops.resize_ce import (
    _label_weights, per_pixel_resize_ce, resize_cross_entropy)
from torch_semantic_segmentation_tpu_torch.parallel import distributed
from torch_semantic_segmentation_tpu_torch.ops.upsample import (
    _resize_nhcw, resize_bilinear)


@dataclasses.dataclass(frozen=True)
class SegLoss:
    """The loss of one output head, `fn(logits, labels) -> scalar`, with
    its resize contract: `handles_resize=True` declares that `fn`
    upsamples low-res logits to the label grid itself, so
    `aux_weighted_loss` passes mixed-resolution heads on as they are."""

    fn: tp.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    handles_resize: bool = False
    name: str = "loss"

    def __call__(self, logits: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        return self.fn(logits, labels)


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


def _weighted_mean(loss: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ w·l / max(Σ w, 1e−12), the denominator over the global batch."""
    return (loss * w).sum() / torch.clamp(distributed.all_reduce_sum(w.sum()),
                                          min=1e-12)


def _rank_share(loss: torch.Tensor, labels: torch.Tensor,
                class_weights, c: int) -> torch.Tensor:
    """The fused K1's ratio, Σ w·l / Σ w over the rank's own pixels, as
    the rank's share of the global batch's: scaled by its Σ w (the
    kernel's pixel weights: cw[label] for a label in [0, C), else 0) over
    the global Σ w. Without a group the loss itself."""
    if not distributed.is_initialized():
        return loss
    with torch.no_grad():
        cw = (torch.ones(c, device=labels.device) if class_weights is None
              else torch.as_tensor(class_weights, dtype=torch.float32,
                                   device=labels.device))
        sw = _label_weights(labels, cw)[2].sum()
        scale = sw / torch.clamp(distributed.reduce_sum(sw), min=1e-12)
    return loss * scale


def _band_and_halo(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int):
    """Under spatial sharding: (the band's low-res logits with one halo row
    each side, the band's labels padded with k rows of `ignore_index` for
    each halo row, the padding's rows above the band). Without it, the
    inputs and 0."""
    if not distributed.is_spatial():
        return logits, labels, 0
    h, oh = logits.shape[1], labels.shape[1]
    if oh % h:
        raise NotImplementedError(
            f"a loss of {h} logit rows on {oh} label rows of an H band: "
            "spatial sharding takes an integer upsampling")
    k = oh // h
    top = k if distributed.spatial_rank() > 0 else 0
    bottom = k if distributed.spatial_rank() < distributed.num_spatial() - 1 \
        else 0
    pad = [labels.new_full((labels.shape[0], r, labels.shape[2]),
                           ignore_index) for r in (top, bottom)]
    return (distributed.halo(logits, 1, 1),
            torch.cat([pad[0], labels, pad[1]], dim=1), top)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       ignore_index: int = 255,
                       class_weights: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Class-weighted CE with `ignore_index`. logits NHWC, labels NHW;
    returns a float32 scalar."""
    loss, valid = _per_pixel_ce(logits, labels, ignore_index)
    return _weighted_mean(loss, _pixel_weights(labels, valid, class_weights))


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
    if (logits.shape[1], logits.shape[2]) != (oh, ow):
        logits, labels, _ = _band_and_halo(logits, labels, ignore_index)
        oh = labels.shape[1]
    if (logits.dtype == torch.bfloat16
            and (logits.shape[1], logits.shape[2]) != (oh, ow)
            and not 0 <= ignore_index < c
            and _class_weights_constant(class_weights)):
        return _rank_share(resize_cross_entropy(
            logits, labels, class_weights, align_corners=align_corners),
            labels, class_weights, c)

    x = _resize_nhcw(logits, (oh, ow), None, align_corners,
                     logits.dtype)                         # (N, OH, C, OW)
    xf = x.float()
    valid = labels != ignore_index
    logz = torch.logsumexp(xf, dim=2)
    true_logit = _one_hot_pick(xf, labels, valid, 2)
    loss = torch.where(valid, logz - true_logit, 0.0)
    return _weighted_mean(loss, _pixel_weights(labels, valid, class_weights))


resize_cross_entropy_loss.handles_resize = True


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
    the losses at or above the midpoint, all on the device (the max and
    each count over every rank's losses under a process group)."""
    lossv = torch.where(valid, losses.float(), -1.0)
    lo = torch.zeros((), dtype=torch.float32, device=losses.device)
    hi = torch.clamp(distributed.reduce_max(lossv.max()), min=1e-6) + 1e-3
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ge = distributed.reduce_sum((lossv >= mid).sum()) >= k
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    return lo


def _ohem_keep(flat: torch.Tensor, vflat: torch.Tensor, thresh: float,
               min_kept: int, exact: bool | None) -> torch.Tensor:
    """The mask of kept pixels of a flat loss map (no gradient). The route
    and `min_kept` go by the global batch's pixel count, and the exact
    route takes the top-k of every rank's valid losses."""
    with torch.no_grad():
        n = flat.shape[0] * distributed.world_size()
        k = min(int(min_kept), n)
        threshold = torch.tensor(-math.log(thresh), dtype=torch.float32,
                                 device=flat.device)
        if exact is None:
            exact = n <= (1 << 20)
        if k > 0:
            if exact:
                kth = _threshold_topk_exact(distributed.all_gather(
                    torch.where(vflat, flat, -math.inf)), k)
            else:
                kth = _threshold_topk_histogram(flat, vflat, k)
            threshold = torch.minimum(threshold, kth)
        return vflat & (flat >= threshold)


def _ohem_mean(flat: torch.Tensor, keep: torch.Tensor, labels: torch.Tensor,
               class_weights) -> torch.Tensor:
    return _weighted_mean(flat, _pixel_weights(labels.reshape(-1), keep,
                                               class_weights))


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
    band_labels = labels
    oh, ow = labels.shape[1], labels.shape[2]
    top = 0
    if (logits.shape[1], logits.shape[2]) != (oh, ow):
        logits, labels, top = _band_and_halo(logits, labels, ignore_index)
    valid = labels != ignore_index
    if (logits.dtype == torch.bfloat16
            and (logits.shape[1], logits.shape[2]) != (oh, ow)
            and not 0 <= ignore_index < c
            and _class_weights_constant(class_weights)):
        loss = per_pixel_resize_ce(logits, labels, align_corners=align_corners)
    else:
        x = _resize_nhcw(logits, (labels.shape[1], ow), None,
                         align_corners, logits.dtype)      # (N, OH, C, OW)
        xf = x.float()
        logz = torch.logsumexp(xf, dim=2)
        true_logit = _one_hot_pick(xf, labels, valid, 2)
        loss = torch.where(valid, logz - true_logit, 0.0)
    # the band's rows of the map (the padding's rows are the halo's)
    loss, valid, labels = (loss.narrow(1, top, oh), valid.narrow(1, top, oh),
                           band_labels)
    flat, vflat = loss.reshape(-1), valid.reshape(-1)
    keep = _ohem_keep(flat, vflat, thresh, min_kept, None)
    return _ohem_mean(flat, keep, labels, class_weights)


resize_ohem_cross_entropy.handles_resize = True


def aux_weighted_loss(main_and_aux_logits: tp.Sequence[torch.Tensor],
                      labels: torch.Tensor, *,
                      loss_fn: tp.Callable[..., torch.Tensor] = (
                          cross_entropy_loss),
                      aux_weight: float = 0.4, align_corners: bool = False,
                      **loss_kwargs) -> torch.Tensor:
    """loss(main) + aux_weight · Σ loss(aux), a float32 scalar. Where
    `loss_fn` lacks `handles_resize`, a head whose size differs from the
    labels' is bilinearly resized to the label grid first (in its own
    dtype); otherwise each head goes to `loss_fn` at its own resolution,
    so low-res bf16 heads reach the fused resize + CE kernels."""
    lh, lw = labels.shape[1], labels.shape[2]
    handles_resize = getattr(loss_fn, "handles_resize", False)
    total = torch.zeros((), dtype=torch.float32, device=labels.device)
    for i, lg in enumerate(main_and_aux_logits):
        if (lg.shape[1], lg.shape[2]) != (lh, lw) and not handles_resize:
            lg = resize_bilinear(lg, (lh, lw), align_corners=align_corners)
        li = loss_fn(lg, labels, **loss_kwargs)
        total = total + (li if i == 0 else aux_weight * li)
    return total


__all__ = ["SegLoss", "aux_weighted_loss", "cross_entropy_loss",
           "ohem_cross_entropy", "resize_cross_entropy_loss",
           "resize_ohem_cross_entropy"]
