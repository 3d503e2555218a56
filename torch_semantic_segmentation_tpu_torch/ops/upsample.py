"""Bilinear resize on NHWC tensors as two matrix products (or two-tap
passes, below), with torch's `F.interpolate(mode='bilinear')` weights for
both `align_corners` conventions.

The matrix form and the accumulation types are the JAX package's, so that
class ids after `resize_argmax` match it: float32 inputs accumulate in
float32; bfloat16 inputs round to bfloat16 after each pass (the matrices are
2-hot, so at most two terms meet in a sum).

Under spatial sharding (`parallel.distributed`) `resize_bilinear`,
`resize_bilinear_nhcw` and `resize_argmax` take an H band of the image
and give the band's rows of the global resize. For an integer ×k in H
with align_corners=False the local grid is the global one shifted by
whole rows: one halo row each side (none at the image's global top and
bottom, where the clamp is the global one) and k rows cropped each side
give exactly the global rows.
An integer ×1/k (ICNet's input and sub2 at 1/2) takes no halo: output
row i reads source row k·i + (k−1)/2, between rows k·i and k·i + k − 1,
so a band of k·oh rows holds every row its oh output rows read, the
clamp never acts, and the band's own resize is exactly the global rows,
forward and backward. An input that is the same on every band (the
PPM's bins, `source="replicated"`) takes the band's rows of the global
matrix.

Any other ratio of a band with align_corners=False (the multi-scale eval
step's 1024 → 768 or 160 → 1024 rows: global sizes h·S → oh·S) takes the
general route: output row o reads src(o) = (o + ½)·H/OH − ½, and for the
band's rows [r·oh, (r+1)·oh) that lies within half a row of the band's
source rows [r·h, (r+1)·h), so the band takes one halo row each side
(none at the image's edges) and applies the global matrix's rows
[r·oh, (r+1)·oh), restricted to the source rows band + halo hold: the
global matrix's other columns are zero there. It is autograd-able (the
halo sends its rows' gradients back), but only its forward is tested.
align_corners=True on a band raises `NotImplementedError`.

A pass whose ratio is no integer ×k or ×1/k (align_corners=False) runs
as its two taps, w_lo·x[lo] + w_hi·x[hi] in the accumulation type, with
the matrix's own float32 weights, on the band as on the whole image: a
matrix product sums the two taps in an order its blocking picks for the
shape, so the band's rows of a product would differ from the whole
image's in the last bit, where the taps' sum is the same bits on both.
Its backward is the product with the matrix, as a product's is, so that
it sums in a fixed order on the card (index_select's own backward adds
by atomics there). Each pass's matrix and taps go to the device once.
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


def _as_taps(h: int, oh: int, align_corners: bool) -> bool:
    """Whether a pass from h to oh (global) rows or columns runs as its
    two taps: a ratio that is no integer ×k or ×1/k, align_corners=False."""
    return not align_corners and oh % h != 0 and h % oh != 0


def _whole(h: int, oh: int, align_corners: bool) -> tuple:
    """The pass (`_rows_matrix`'s arguments) of a whole resize from h to
    oh rows or columns."""
    return h, oh, 0, oh, 0, h, align_corners


@functools.lru_cache(maxsize=None)
def _rows_matrix(h: int, rows: int, first: int, oh: int, lo: int, hi: int,
                 align_corners: bool) -> np.ndarray:
    """The rows [first, first + oh) of the interpolation matrix from h to
    `rows` rows, restricted to the source rows [lo, hi); raises where one
    of them reads a source row outside."""
    m = _interp_matrix(h, rows, align_corners)[first:first + oh]
    if m[:, :lo].any() or m[:, hi:].any():
        raise ValueError(f"output rows [{first}, {first + oh}) of a resize "
                         f"from {h} to {rows} rows read source rows outside "
                         f"[{lo}, {hi})")
    return m[:, lo:hi]


def _taps(m: np.ndarray) -> tuple[np.ndarray, ...]:
    """(lo, hi, w_lo, w_hi) of each row of an interpolation matrix: its
    first and last nonzero columns and their weights (w_hi 0 where they
    are one)."""
    nz = m != 0
    rows = np.arange(m.shape[0])
    lo = nz.argmax(axis=1)
    hi = m.shape[1] - 1 - nz[:, ::-1].argmax(axis=1)
    return lo, hi, m[rows, lo], np.where(hi != lo, m[rows, hi], 0.0)


@functools.lru_cache(maxsize=None)
def _pass_tensors(spec: tuple, device: torch.device, dtype: torch.dtype):
    """The matrix of the pass `spec` on `device` in `dtype`, and its taps
    (lo, hi, w_lo, w_hi) where the pass runs as two taps (else None):
    copied to the device once, and made outside inference mode, so that
    a training step may keep them for its backward."""
    m = _rows_matrix(*spec)
    with torch.inference_mode(False):
        mt = torch.from_numpy(m).to(device=device, dtype=dtype)
        if not _as_taps(spec[0], spec[1], spec[-1]):
            return mt, None
        lo, hi, wlo, whi = (torch.from_numpy(np.ascontiguousarray(a)).to(
            device) for a in _taps(m))
        return mt, (lo, hi, wlo.to(dtype), whi.to(dtype))


class _Taps(torch.autograd.Function):
    """A pass along `dim` as its two taps a row, w_lo·x[lo] + w_hi·x[hi].
    Its backward is the product with the pass's matrix, as the einsum's
    is: index_select's own backward scatters by atomics on the card, so
    its sums would vary from run to run."""

    @staticmethod
    def forward(ctx, x, dim, m, lo, hi, wlo, whi):
        ctx.dim, ctx.m = dim, m
        shape = [1] * x.dim()
        shape[dim] = -1
        return (x.index_select(dim, lo) * wlo.view(shape)
                + x.index_select(dim, hi) * whi.view(shape))

    @staticmethod
    def backward(ctx, g):
        dx = torch.matmul(g.movedim(ctx.dim, -1), ctx.m).movedim(-1, ctx.dim)
        return dx, None, None, None, None, None, None


def _pass(x: torch.Tensor, eq: str, spec: tuple, dtype: torch.dtype,
          acc: torch.dtype) -> torch.Tensor:
    """One pass of a resize: the einsum `eq` of x and the matrix (out, in)
    of the pass `spec`, in `dtype`; or, where the pass runs as two taps,
    the same by its taps summed in `acc`, rounded to `dtype` and laid out
    as `eq`'s output."""
    src, rest = eq.split(",")
    mat, out = rest.split("->")
    if not _as_taps(spec[0], spec[1], spec[-1]):
        m, _ = _pass_tensors(spec, x.device, dtype)
        return torch.einsum(eq, x.to(dtype), m)
    m, taps = _pass_tensors(spec, x.device, acc)
    y = _Taps.apply(x.to(acc), src.index(mat[1]), m, *taps).to(dtype)
    got = src.replace(mat[1], mat[0])
    return y.permute([got.index(ch) for ch in out])


def resize_bilinear(x: torch.Tensor, size: tuple[int, int], *,
                    align_corners: bool = False,
                    source: str = "band") -> torch.Tensor:
    """Bilinear-resize NHWC `x` to `size` = (H_out, W_out); accumulates in
    float32 (float64 for a float64 x, as the pools do) and casts back to
    x's dtype. Under spatial sharding `size` is the band's and `x` an H
    band of the image (`source="band"`, any ratio), or the same on every
    band (`source="replicated"`)."""
    if not distributed.is_spatial():
        return _resize_bilinear(x, size, None, align_corners)
    n, h, w, c = x.shape
    oh, ow = size
    if source == "replicated":
        rows = oh * distributed.num_spatial()
        return _resize_bilinear(x, size, (
            h, rows, distributed.spatial_rank() * oh, oh, 0, h,
            align_corners), align_corners)
    scale = _band_scale(h, oh, align_corners)
    if scale is None:
        xh, hpass = _band_window(x, oh)
        return _resize_bilinear(xh, size, hpass, align_corners)
    halo, up, down = scale
    if (up, down, ow) == (1, 1, w):
        return x
    return distributed.on_band(
        lambda xh: _resize_bilinear(xh, (xh.shape[1] * up // down, ow),
                                    None, align_corners),
        x, halo, halo, up=up, down=down)


def _band_scale(h: int, oh: int,
                align_corners: bool) -> tuple[int, int, int] | None:
    """(halo, up, down) of an H band's resize from h to oh rows: an
    integer ×k (1, k, 1), whose band takes one halo row each side, or ×1/k
    (0, 1, k), which takes none; None for any other ratio (the general
    route, `_band_window`). Raises for align_corners=True."""
    if align_corners:
        raise NotImplementedError(
            f"a resize of an H band from {h} to {oh} rows with "
            "align_corners=True: spatial sharding takes align_corners=False")
    if oh >= h and oh % h == 0:
        return 1, oh // h, 1
    if 0 < oh < h and h % oh == 0:
        return 0, 1, h // oh
    return None


def _band_window(x: torch.Tensor, oh: int) -> tuple[torch.Tensor, tuple]:
    """The general route's band + one halo row each side, and its H pass:
    the global matrix's rows of the band, restricted to the source rows
    that band and halo hold, for an H band x resized to oh rows."""
    h, s, n = x.shape[1], distributed.spatial_rank(), distributed.num_spatial()
    top, bottom = distributed.halo_rows(1, 1, h)
    return distributed.halo(x, 1, 1), (
        h * n, oh * n, s * oh, oh, s * h - top, (s + 1) * h + bottom, False)


def _resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                     hpass: tuple | None,
                     align_corners: bool) -> torch.Tensor:
    """The resize itself; `hpass`, where given, is the H pass
    (`_rows_matrix`'s arguments): the band's rows of the global one
    (`resize_bilinear`)."""
    n, h, w, c = x.shape
    oh, ow = size
    if hpass is None and (oh, ow) == (h, w):
        return x
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = _pass(x, "nhwc,oh->nowc", hpass or _whole(h, oh, align_corners),
              acc, acc)
    y = _pass(y, "nhwc,ow->nhoc", _whole(w, ow, align_corners), acc, acc)
    return y.to(x.dtype)


def resize_bilinear_nhcw(x: torch.Tensor, size: tuple[int, int], *,
                         align_corners: bool = False,
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Bilinear-resize NHWC `x` to `size`, returned as (N, OH, C, OW), in
    float32 unless `out_dtype` says otherwise. The products run in x's
    dtype; the intermediate between the W and H passes is kept in x's
    dtype. Under spatial sharding `size` is the band's and `x` an H band
    of the image (any ratio, as `resize_bilinear`)."""
    h, oh = x.shape[1], size[0]
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if tuple(size) == (h, x.shape[2]) or not distributed.is_spatial():
        return _resize_nhcw(x, size, None, align_corners, out_dtype)
    scale = _band_scale(h, oh, align_corners)
    if scale is None:
        xh, hpass = _band_window(x, oh)
        return _resize_nhcw(xh, size, hpass, align_corners, out_dtype)
    halo, up, down = scale
    return distributed.on_band(
        lambda xh: _resize_nhcw(xh, (xh.shape[1] * up // down, size[1]),
                                None, align_corners, out_dtype),
        x, halo, halo, up=up, down=down)


def _resize_nhcw(x: torch.Tensor, size: tuple[int, int],
                 hpass: tuple | None, align_corners: bool,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """`resize_bilinear_nhcw` of x itself (the resize losses call it on
    their band + halo rows); `hpass`, where given, is the H pass. A pass
    as two taps sums them in float32 (float64 for float64) and rounds to
    x's dtype, as a product in x's dtype does."""
    n, h, w, c = x.shape
    oh, ow = size
    if hpass is None and (oh, ow) == (h, w):
        return x.permute(0, 1, 3, 2).to(out_dtype)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = _pass(x, "nhwc,kw->nhck", _whole(w, ow, align_corners), x.dtype, acc)
    y = _pass(y, "nhck,oh->nock", hpass or _whole(h, oh, align_corners),
              x.dtype, acc)
    return y.to(out_dtype)


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
    x = resize_bilinear_nhcw(logits, size, align_corners=align_corners)
    return torch.argmax(x, dim=2).to(out_dtype)
