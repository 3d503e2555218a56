"""Fused ×2 bilinear upsample + skip concat (UNet's bilinear decoder), with
its Hopper kernel.

`upsample2x_concat(low, skip)` returns `concat([up2x(low), skip], -1)`:
low (N,H,W,Cl), skip (N,2H,2W,Cs), the result (N,2H,2W,Cl+Cs) in skip's
dtype. The upsample is align_corners=False with the edge clamped (the JAX
package's `ops/pallas_upsample.py`, `_up2x_rows` and `_up2x_lanes`): even
output rows are 0.25·x[i−1] + 0.75·x[i], odd ones 0.75·x[i] + 0.25·x[i+1],
first along H, then along W, in float32, rounded once to the output type.

On an H band (spatial sharding) `low` takes one halo row from each
neighbouring band (none at the image's global top and bottom, where the
clamp is the global one) and the kernel writes only the band's 2·rows
output rows, from output row 2·t of the band + halo's upsample (t the top
halo rows), with the band's skip: each output row has the taps, and the
bits, of the whole image's. The backward is the adjoint of that cropped
upsample, and the halo rows' gradients go back to their bands.

`upsample_concat_forward` launches the CUDA kernel (`csrc/upsample_concat.cu`)
for tensors on the card and runs the plain PyTorch version for tensors on
the CPU; the two give the same bits. The backward is the JAX package's
`_fused_bwd`: d(skip) is the cotangent's channel tail, d(low) the adjoint
resize as two float32 products with the transposed interpolation matrices,
cast to low's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from torch_semantic_segmentation_tpu_torch import kernels
from torch_semantic_segmentation_tpu_torch.ops.upsample import _matrix
from torch_semantic_segmentation_tpu_torch.parallel import distributed

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _up2x(x: torch.Tensor, dim: int) -> torch.Tensor:
    """×2 along `dim` of a float32 tensor: even outputs
    0.25·x[i−1] + 0.75·x[i], odd ones 0.75·x[i] + 0.25·x[i+1], indices
    clamped; each product and the sum rounded on their own."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    y = torch.stack([even, odd], dim + 1)
    shape = list(x.shape)
    shape[dim] = 2 * n
    return y.reshape(shape)


def upsample2x_reference(low: torch.Tensor) -> torch.Tensor:
    """The ×2 upsample of NHWC `low`, float32: the H pass, then the W pass."""
    return _up2x(_up2x(low.float(), 1), 2)


def upsample_concat_reference(low: torch.Tensor, skip: torch.Tensor,
                              row0: int = 0) -> torch.Tensor:
    """Plain PyTorch forward: concat([up2x(low) rows [row0, row0 + OH),
    skip], -1) in skip's dtype, OH skip's rows."""
    up = upsample2x_reference(low).narrow(1, row0, skip.shape[1])
    return torch.cat([up.to(skip.dtype), skip], dim=-1)


def _library() -> ctypes.CDLL:
    lib = kernels.load("upsample_concat")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.upsample2x_concat.argtypes = [p, p, p] + [i] * 9 + [p]
        lib.upsample2x_concat.restype = i
        lib.upsample2x_concat_error_string.argtypes = [i]
        lib.upsample2x_concat_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_shapes(low: torch.Tensor, skip: torch.Tensor, row0: int):
    if low.dim() != 4 or skip.dim() != 4:
        raise ValueError("upsample_concat takes NHWC low and skip")
    n, h, w, _ = low.shape
    if (skip.shape[0], skip.shape[2]) != (n, 2 * w) or not (
            0 <= row0 and row0 + skip.shape[1] <= 2 * h):
        raise ValueError(f"upsample_concat: skip {tuple(skip.shape)} for low "
                         f"{tuple(low.shape)} from output row {row0}, "
                         f"expected (N, OH, 2W, Cs) with row0 + OH within "
                         f"the upsample's 2H, 2W = {2 * h}, {2 * w}")


def upsample_concat_forward(low: torch.Tensor, skip: torch.Tensor,
                            row0: int = 0) -> torch.Tensor:
    """The forward, output rows [row0, row0 + OH) of the upsample with
    skip's OH rows: the kernel on the card, `upsample_concat_reference`
    on the CPU."""
    _check_shapes(low, skip, row0)
    if low.device.type == "cpu":
        return upsample_concat_reference(low, skip, row0)
    if low.device.type != "cuda":
        raise ValueError(f"upsample_concat: no kernel for device {low.device}")
    if skip.device != low.device:
        raise ValueError(f"upsample_concat kernel: all tensors must be on "
                         f"{low.device}, got skip on {skip.device}")
    if low.dtype not in _DTYPES or skip.dtype != low.dtype:
        raise TypeError(f"upsample_concat kernel takes bfloat16 or float32 "
                        f"low and skip of one dtype, got {low.dtype} and "
                        f"{skip.dtype}")
    if not (low.is_contiguous() and skip.is_contiguous()):
        raise ValueError("upsample_concat kernel takes contiguous tensors")
    n, h, w, cl = low.shape
    oh, cs = skip.shape[1], skip.shape[-1]
    out = torch.empty((n, oh, 2 * w, cl + cs), dtype=skip.dtype,
                      device=low.device)
    lib = _library()
    err = lib.upsample2x_concat(
        low.data_ptr(), skip.data_ptr(), out.data_ptr(), _DTYPES[low.dtype],
        n, h, w, cl, cs, row0, oh, low.device.index or 0,
        torch.cuda.current_stream(low.device).cuda_stream)
    if err != 0:
        raise RuntimeError("upsample_concat kernel launch failed: "
                           + lib.upsample2x_concat_error_string(err).decode())
    upsample_concat_forward.launches += 1
    kernels.check_finite("upsample_concat", out)
    return out


upsample_concat_forward.launches = 0


def upsample2x_adjoint(g: torch.Tensor, h: int, row0: int) -> torch.Tensor:
    """The transpose of the output rows [row0, row0 + OH) of the ×2
    upsample of `h` rows: (N,OH,2W,C) → (N,h,W,C) in float32, as two
    products with the transposed interpolation matrices (the H one cut to
    those rows)."""
    n, oh, ow, c = g.shape
    wh = _matrix(h, 2 * h, False, g, torch.float32)[row0:row0 + oh]
    ww = _matrix(ow // 2, ow, False, g, torch.float32)       # (2W, W)
    d = torch.einsum("nhwc,ho->nowc", g.float(), wh)
    return torch.einsum("nhwc,wo->nhoc", d, ww)


class _UpsampleConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, low, skip, row0):
        ctx.c_low, ctx.low_dtype = low.shape[-1], low.dtype
        ctx.h, ctx.row0 = low.shape[1], row0
        return upsample_concat_forward(low, skip, row0)

    @staticmethod
    def backward(ctx, g):
        cl = ctx.c_low
        dlow = upsample2x_adjoint(g[..., :cl], ctx.h, ctx.row0)
        return dlow.to(ctx.low_dtype), g[..., cl:], None


def upsample2x_concat(low: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """concat([up2x(low), skip], -1): low (N,H,W,Cl), skip (N,2H,2W,Cs);
    returns (N,2H,2W,Cl+Cs) in skip's dtype. On an H band, the band's rows
    of the whole image's result, from band + one halo row each side."""
    if skip.shape[1] != 2 * low.shape[1]:
        raise ValueError(f"upsample2x_concat: skip {tuple(skip.shape)} for "
                         f"low {tuple(low.shape)}, expected (N, 2H, 2W, Cs)")
    if not distributed.is_spatial():
        return _UpsampleConcat.apply(low.contiguous(), skip.contiguous(), 0)
    t, _ = distributed.halo_rows(1, 1, low.shape[1])
    return _UpsampleConcat.apply(distributed.halo(low, 1, 1).contiguous(),
                                 skip.contiguous(), 2 * t)
