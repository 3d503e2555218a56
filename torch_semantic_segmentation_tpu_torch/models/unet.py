"""UNet (Ronneberger et al. 2015) in PyTorch, with same-padded convs and
BatchNorm, and the JAX package's module names and attribute paths so that
its weights map one to one.

- encoder: DoubleConv at base·(1, 2, 4, 8) channels, each followed by a
  2×2/s2 max pool, then a DoubleConv at base·16 (1/16);
- decoder: four UpBlocks, each a ×2 upsample, a concat with the encoder's
  skip at that resolution and a DoubleConv; then a 1×1 conv to logits.

The upsample is a 2×2/s2 transposed conv (`upsample="deconv"`) or a 1×1
conv at the low resolution followed by a ×2 bilinear resize
(`upsample="bilinear"`). With align_corners=False the bilinear resize and
the concat run as one op (`ops.upsample_concat`, the Hopper kernel K4 on
the card). Input and output are NHWC full-resolution tensors, as in the
JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.ops import (
    ConvBNAct,
    ConvTranspose2d,
    make_conv,
    max_pool2d,
    resize_bilinear,
)
from torch_semantic_segmentation_tpu_torch.ops.upsample_concat import (
    upsample2x_concat)


class DoubleConv(nn.Module):
    """(conv 3×3 → BN → ReLU) ×2."""

    def __init__(self, in_ch: int, out_ch: int, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv1 = ConvBNAct(in_ch, out_ch, 3, act="relu", **kw)
        self.conv2 = ConvBNAct(out_ch, out_ch, 3, act="relu", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class UpBlock(nn.Module):
    """×2 upsample (deconv, or 1×1 conv then bilinear), concat the skip,
    DoubleConv."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, *,
                 upsample: str = "deconv", align_corners: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        if upsample not in ("deconv", "bilinear"):
            raise ValueError(f"upsample must be 'deconv' or 'bilinear', got "
                             f"{upsample!r}")
        self.upsample = upsample
        self.align_corners = align_corners
        if upsample == "deconv":
            self.up = ConvTranspose2d(in_ch, out_ch, 2, stride=2, **kw)
        else:
            self.up = make_conv(in_ch, out_ch, 1, use_bias=True, **kw)
        self.conv = DoubleConv(out_ch + skip_ch, out_ch, **kw)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.up(x)
        if self.upsample == "deconv":
            return self.conv(torch.cat([x, skip], dim=-1))
        if self.align_corners:             # K4 is align_corners=False only
            x = resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2),
                                align_corners=True)
            return self.conv(torch.cat([x, skip], dim=-1))
        return self.conv(upsample2x_concat(x, skip))


class UNet(nn.Module):
    """UNet. Input NHWC float with H, W % 16 == 0; returns full-resolution
    logits (N, H, W, num_classes)."""

    def __init__(self, num_classes: int = 19, in_ch: int = 3, *,
                 base_ch: int = 64, upsample: str = "deconv",
                 align_corners: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.align_corners = align_corners
        b = base_ch
        self.enc1 = DoubleConv(in_ch, b, **kw)
        self.enc2 = DoubleConv(b, 2 * b, **kw)
        self.enc3 = DoubleConv(2 * b, 4 * b, **kw)
        self.enc4 = DoubleConv(4 * b, 8 * b, **kw)
        self.bottom = DoubleConv(8 * b, 16 * b, **kw)
        up = dict(upsample=upsample, align_corners=align_corners, **kw)
        self.up4 = UpBlock(16 * b, 8 * b, 8 * b, **up)
        self.up3 = UpBlock(8 * b, 4 * b, 4 * b, **up)
        self.up2 = UpBlock(4 * b, 2 * b, 2 * b, **up)
        self.up1 = UpBlock(2 * b, b, b, **up)
        self.head = make_conv(b, num_classes, 1, use_bias=True, **kw)

    def remat_segments(self) -> list[nn.Module]:
        """The modules a rematerialised train step checkpoints one by one
        (`train.make_train_step(remat=True)`): the four encoder
        DoubleConvs, the bottom one, the four UpBlocks and the head."""
        return [self.enc1, self.enc2, self.enc3, self.enc4, self.bottom,
                self.up4, self.up3, self.up2, self.up1, self.head]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        if h % 16 or w % 16:
            raise ValueError(
                f"UNet needs H and W divisible by 16 (4 pooling stages); "
                f"got {h}x{w}")
        s1 = self.enc1(x)
        s2 = self.enc2(max_pool2d(s1, 2))
        s3 = self.enc3(max_pool2d(s2, 2))
        s4 = self.enc4(max_pool2d(s3, 2))
        y = self.bottom(max_pool2d(s4, 2))
        y = self.up4(y, s4)
        y = self.up3(y, s3)
        y = self.up2(y, s2)
        y = self.up1(y, s1)
        return self.head(y)


def unet(num_classes: int = 19, *, base_ch: int = 64,
         upsample: str = "deconv", align_corners: bool = False,
         compute_dtype: torch.dtype | None = None, seed: int = 0,
         device: str | torch.device | None = None) -> UNet:
    """Build UNet with float32 parameters drawn from
    `torch.Generator().manual_seed(seed)`, on `device` (the card unless the
    caller passes "cpu")."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = UNet(num_classes, base_ch=base_ch, upsample=upsample,
                 align_corners=align_corners, compute_dtype=compute_dtype,
                 generator=gen)
    return model.to(dev)
