"""Bilinear resize on NHWC tensors as two matrix products, with torch's
`F.interpolate(mode='bilinear')` weights for both `align_corners`
conventions.

The matrix form and the accumulation types are the JAX package's, so that
class ids after `resize_argmax` match it: float32 inputs accumulate in
float32; bfloat16 inputs round to bfloat16 after each pass (the matrices are
2-hot, so at most two terms meet in a sum).

Under spatial sharding (`parallel.distributed`) `resize_bilinear` and
`resize_argmax` take an H band of the image and give the band's rows of
the global resize. For an integer ×k in H with align_corners=False the
local grid is the global one shifted by whole rows: one halo row each
side (none at the image's global top and bottom, where the clamp is the
global one) and k rows cropped each side give exactly the global rows.
An integer ×1/k (ICNet's input and sub2 at 1/2) takes no halo: output
row i reads source row k·i + (k−1)/2, between rows k·i and k·i + k − 1,
so a band of k·oh rows holds every row its oh output rows read, the
clamp never acts, and the band's own resize is exactly the global rows,
forward and backward. An input that is the same on every band (the
PPM's bins, `source="replicated"`) takes the band's rows of the global
matrix. Any other resize of a band raises `NotImplementedError`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from torch_semantic_segmentation_tpu_torch.parallel import distributed


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense 1-D linear-interpolation matrix W (out_size, in_size), float32.

      align_corners=True : src = i * (in-1) / (out-1)
      align_corners=False: src = (i + 0.5) * in/out - 0.5, clamped to [0, in-1]
    """
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = i * (in_size - 1) / max(out_size - 1, 1)
    else:
        src = (i + 0.5) * (in_size / out_size) - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float64)
    w = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(w, (rows, lo), 1.0 - frac)
    np.add.at(w, (rows, hi), frac)
    return w.astype(np.float32)


def _matrix(in_size: int, out_size: int, align_corners: bool,
            like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    m = _interp_matrix(in_size, out_size, align_corners)
    return torch.from_numpy(m).to(device=like.device, dtype=dtype)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int], *,
                    align_corners: bool = False,
                    source: str = "band") -> torch.Tensor:
    """Bilinear-resize NHWC `x` to `size` = (H_out, W_out); accumulates in
    float32 (float64 for a float64 x, as the pools do) and casts back to
    x's dtype. Under spatial sharding `size` is the band's and `x` an H
    band of the image (`source="band"`), or the same on every band
    (`source="replicated"`)."""
    if not distributed.is_spatial():
        return _resize_bilinear(x, size, None, align_corners)
    n, h, w, c = x.shape
    oh, ow = size
    if source == "replicated":
        rows = oh * distributed.num_spatial()
        return _resize_bilinear(x, size, (rows, distributed.spatial_rank()
                                          * oh), align_corners)
    halo, up, down = _band_scale(h, oh, align_corners)
    if (up, down, ow) == (1, 1, w):
        return x
    return distributed.on_band(
        lambda xh: _resize_bilinear(xh, (xh.shape[1] * up // down, ow),
                                    None, align_corners),
        x, halo, halo, up=up, down=down)


def _band_scale(h: int, oh: int,
                align_corners: bool) -> tuple[int, int, int]:
    """(halo, up, down) of an H band's resize from h to oh rows: an
    integer ×k (1, k, 1), whose band takes one halo row each side, or ×1/k
    (0, 1, k), which takes none; raises where the band's rows are not a
    translate of the global grid."""
    if not align_corners:
        if oh >= h and oh % h == 0:
            return 1, oh // h, 1
        if 0 < oh < h and h % oh == 0:
            return 0, 1, h // oh
    raise NotImplementedError(
        f"a resize of an H band from {h} to {oh} rows"
        + (" with align_corners=True" if align_corners else "")
        + ": spatial sharding takes an integer upsampling, or an integer "
        "downsampling whose factor divides the band's rows, with "
        "align_corners=False")


def _resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                     rows: tuple[int, int] | None,
                     align_corners: bool) -> torch.Tensor:
    """The resize itself; `rows` = (global H_out, first row) takes the
    rows [first, first + H_out) of a resize to the global H_out."""
    n, h, w, c = x.shape
    oh, ow = size
    if rows is None and (oh, ow) == (h, w):
        return x
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    if rows is None:
        wh = _matrix(h, oh, align_corners, x, acc)
    else:
        wh = _matrix(h, rows[0], align_corners, x, acc)
        wh = wh[rows[1]:rows[1] + oh]
    ww = _matrix(w, ow, align_corners, x, acc)
    y = torch.einsum("nhwc,oh->nowc", x.to(acc), wh)
    y = torch.einsum("nhwc,ow->nhoc", y, ww)
    return y.to(x.dtype)


def resize_bilinear_nhcw(x: torch.Tensor, size: tuple[int, int], *,
                         align_corners: bool = False,
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Bilinear-resize NHWC `x` to `size`, returned as (N, OH, C, OW), in
    float32 unless `out_dtype` says otherwise. The products run in x's
    dtype; the intermediate between the W and H passes is kept in x's
    dtype."""
    n, h, w, c = x.shape
    oh, ow = size
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if (oh, ow) == (h, w):
        return x.permute(0, 1, 3, 2).to(out_dtype)
    ww = _matrix(w, ow, align_corners, x, x.dtype)
    wh = _matrix(h, oh, align_corners, x, x.dtype)
    y = torch.einsum("nhwc,kw->nhck", x, ww)
    return torch.einsum("nhck,oh->nock", y, wh).to(out_dtype)


def resize_argmax(logits: torch.Tensor, size: tuple[int, int], *,
                  align_corners: bool = False,
                  out_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """argmax over classes of the bilinearly upsampled NHWC logits, in the
    (N, H, C, W) layout: the serving tail for models built with
    `upsample_logits=False`. Under spatial sharding the logits and `size`
    are an H band's."""
    oh, ow = size
    if (oh, ow) == (logits.shape[1], logits.shape[2]):
        return torch.argmax(logits, dim=-1).to(out_dtype)
    if distributed.is_spatial():
        halo, up, down = _band_scale(logits.shape[1], oh, align_corners)
        x = distributed.on_band(
            lambda xh: resize_bilinear_nhcw(
                xh, (xh.shape[1] * up // down, ow),
                align_corners=align_corners),
            logits, halo, halo, up=up, down=down)
    else:
        x = resize_bilinear_nhcw(logits, size, align_corners=align_corners)
    return torch.argmax(x, dim=2).to(out_dtype)
