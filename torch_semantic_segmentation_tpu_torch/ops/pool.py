"""Pooling on NHWC tensors: max pooling (UNet's encoder, the ResNet stem),
adaptive average pooling (the PPM bins) and global average pooling, the
averages accumulated in float32."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


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


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None,
               padding: int = 0) -> torch.Tensor:
    """Max pool of NHWC `x` (the JAX package's `ops/pool.max_pool2d`): a
    square window, the stride (the window by default) and symmetric
    padding with −inf. The gradient of a window whose maximum is tied goes
    to its first maximum in row-major order, as in the JAX package."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride or window, padding)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Mean over H and W in float32, cast back to x's dtype."""
    return x.float().mean(dim=(1, 2), keepdim=keepdims).to(x.dtype)


def adaptive_avg_pool2d(x: torch.Tensor,
                        output_size: int | tuple[int, int]) -> torch.Tensor:
    """torch AdaptiveAvgPool2d on NHWC `x`, as two small float32 matmuls."""
    if isinstance(output_size, int):
        oh = ow = output_size
    else:
        oh, ow = output_size
    n, h, w, c = x.shape
    if (oh, ow) == (h, w):
        return x
    mh = torch.from_numpy(_pool_matrix(h, oh)).to(x.device)
    mw = torch.from_numpy(_pool_matrix(w, ow)).to(x.device)
    y = torch.einsum("nhwc,oh->nowc", x.float(), mh)
    y = torch.einsum("nhwc,ow->nhoc", y, mw)
    return y.to(x.dtype)
