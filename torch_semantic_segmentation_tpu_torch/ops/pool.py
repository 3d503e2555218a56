"""Pooling on NHWC tensors: max pooling (UNet's encoder, the ResNet stem),
average pooling (the JAX package's `avg_pool2d`, which no zoo model
calls), the 2×2 max pool with window indices and its unpool (ENet), adaptive
average pooling (the PPM bins) and global average pooling, the averages
accumulated in float32 (in float64 for a float64 input: the CPU tests
hold the bands in float64 at 1e-10, where a float32 sum of the bands'
parts in another order would leave them 1e-7 apart). Under spatial sharding the max pool takes an H
band with its halo, the 2×2 pool with indices and its unpool a band of
even rows as it is, and the two averages the band's part of the global
average, summed over the data row's bands (`distributed.spatial_sum`)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from torch_semantic_segmentation_tpu_torch.ops.conv import band_halo
from torch_semantic_segmentation_tpu_torch.parallel import distributed


@functools.lru_cache(maxsize=None)
def _pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Per-bin averaging matrix (out_size, in_size). torch's bin rule: bin b
    averages [floor(b·in/out), ceil((b+1)·in/out))."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for b in range(out_size):
        lo = (b * in_size) // out_size
        hi = -(-((b + 1) * in_size) // out_size)  # ceil
        m[b, lo:hi] = 1.0 / (hi - lo)
    return m


@functools.lru_cache(maxsize=None)
def _pool_tensor(in_size: int, out_size: int, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """`_pool_matrix` on `device` in `dtype`: copied to the device once
    for a shape (a band takes a view of its columns), and made outside
    inference mode, so that a training step may keep it for its backward.
    A CUDA graph holds no copy from the host: the first call, outside
    the capture, makes it."""
    with torch.inference_mode(False):
        return torch.from_numpy(_pool_matrix(in_size, out_size)).to(
            device=device, dtype=dtype)


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None,
               padding: int = 0) -> torch.Tensor:
    """Max pool of NHWC `x` (the JAX package's `ops/pool.max_pool2d`): a
    square window, the stride (the window by default) and symmetric
    padding with −inf. The gradient of a window whose maximum is tied goes
    to its first maximum in row-major order, as in the JAX package. On an
    H band the pool runs on band + the halo a conv of its geometry takes
    (`band_halo`; none for the 2×2/s2 pool), so the −inf padding falls at
    the image's global edges only and the halo rows are real rows."""
    stride = stride or window

    def pool(t: torch.Tensor) -> torch.Tensor:
        y = F.max_pool2d(t.permute(0, 3, 1, 2), window, stride, padding)
        return y.permute(0, 2, 3, 1)

    return distributed.on_band(pool, x, *band_halo(window, stride, padding),
                               down=stride)


def avg_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None,
               padding: int = 0) -> torch.Tensor:
    """Average pool of NHWC `x` (the JAX package's `ops/pool.avg_pool2d`):
    each window's sum in float32 (float64 for a float64 x) over window²,
    zero padding counted, cast back to x's dtype. On an H band it takes
    its halo as `max_pool2d` does, so the zero padding falls at the
    image's global edges only."""
    stride = stride or window

    def pool(t: torch.Tensor) -> torch.Tensor:
        y = F.avg_pool2d(_accumulate(t).permute(0, 3, 1, 2), window, stride,
                         padding, count_include_pad=True)
        return y.permute(0, 2, 3, 1).to(x.dtype)

    return distributed.on_band(pool, x, *band_halo(window, stride, padding),
                               down=stride)


def max_pool2x2_with_indices(x: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """2×2/s2 max pool of NHWC `x` (even H and W): (pooled, the index in
    [0, 4) of each window's first maximum in row-major order, int64). As
    in the JAX package the value is the max over the window's 4-wide
    axis, so a tied window splits its gradient equally among its maxima
    (`torch.amax`), where `nn.MaxPool2d(return_indices=True)` gives it
    all to one. Each window is its own: an H band of even rows takes no
    halo."""
    n, h, w, c = x.shape
    xr = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    xr = xr.reshape(n, h // 2, w // 2, 4, c)       # windows, row-major
    return torch.amax(xr, dim=3), torch.argmax(xr, dim=3)


def max_unpool2x2(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Each value of NHWC `x` placed at its window index (from
    `max_pool2x2_with_indices`, possibly of another tensor) in its 2×2
    output window, zeros elsewhere: a one-hot product, no scatter. Each
    window is its own: an H band takes no halo."""
    n, h2, w2, c = x.shape
    slots = torch.arange(4, device=x.device).view(1, 1, 1, 4, 1)
    y = x.unsqueeze(3) * (indices.unsqueeze(3) == slots).to(x.dtype)
    y = y.reshape(n, h2, w2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * h2, 2 * w2, c)


def _accumulate(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or as it is in float64."""
    return x if x.dtype == torch.float64 else x.float()


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Mean over H and W in float32, cast back to x's dtype (of the whole
    image for an H band)."""
    if not distributed.is_spatial():
        return _accumulate(x).mean(dim=(1, 2), keepdim=keepdims).to(x.dtype)
    total = _accumulate(x).sum(dim=(1, 2), keepdim=keepdims)
    rows = distributed.global_rows(x.shape[1])
    return (distributed.spatial_sum(total) / (rows * x.shape[2])).to(x.dtype)


def adaptive_avg_pool2d(x: torch.Tensor,
                        output_size: int | tuple[int, int]) -> torch.Tensor:
    """torch AdaptiveAvgPool2d on NHWC `x`, as two small float32 matmuls.
    For an H band, the band's columns of the global pool matrix, summed
    over the data row's bands before the W pass."""
    if isinstance(output_size, int):
        oh = ow = output_size
    else:
        oh, ow = output_size
    n, h, w, c = x.shape
    if not distributed.is_spatial() and (oh, ow) == (h, w):
        return x
    xf = _accumulate(x)
    mh = _pool_tensor(distributed.global_rows(h), oh, xf.device, xf.dtype)
    if distributed.is_spatial():
        mh = mh[:, distributed.band_start(h):][:, :h]
    mw = _pool_tensor(w, ow, xf.device, xf.dtype)
    y = distributed.spatial_sum(torch.einsum("nhwc,oh->nowc", xf, mh))
    y = torch.einsum("nhwc,ow->nhoc", y, mw)
    return y.to(x.dtype)
