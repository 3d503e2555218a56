"""ICNet (Zhao et al. 2018) in PyTorch: a cascade over three input
resolutions with cascade feature fusion and label guidance, with the JAX
package's module names and attribute paths so that its weights map one to
one.

- sub1, the full-resolution input: three stride-2 conv-BN-ReLUs (1/8, 64);
- sub2, the input at 1/2: a ResNet's stem, max pool, stage 1 and stage 2
  (1/16);
- sub4, sub2's features at 1/2: the same ResNet's dilated stages 3 and 4
  and pyramid pooling (1/32, 256); the trunk runs once;
- CFF(sub4 → sub2) at 1/16, CFF(→ sub1) at 1/8, a ×2 upsample and the
  classifier (1/4); aux classifiers on the two CFFs' upsampled low inputs
  (1/16 and 1/8).

With `aux=True` the model returns (main, aux at 1/8, aux at 1/16) in
training and in eval mode; the main head is upsampled to full resolution
unless `upsample_logits=False`, and the aux heads stay at their own.
Input and output are NHWC, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.models.resnet import ResNet
from torch_semantic_segmentation_tpu_torch.ops import (
    ConvBNAct, PyramidPooling, make_conv, max_pool2d, resize_bilinear)


class CascadeFeatureFusion(nn.Module):
    """CFF: the low-res input upsampled to the high one's size → dilated
    3×3 conv-BN; the high input → 1×1 conv-BN; sum → ReLU. Returns the
    fused map and the upsampled low input (for the aux classifier)."""

    def __init__(self, low_ch: int, high_ch: int, out_ch: int, *,
                 align_corners: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.align_corners = align_corners
        self.low_conv = ConvBNAct(low_ch, out_ch, 3, dilation=2, act=None,
                                  **kw)
        self.high_conv = ConvBNAct(high_ch, out_ch, 1, act=None, **kw)

    def forward(self, low: torch.Tensor, high: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        low_up = resize_bilinear(low, (high.shape[1], high.shape[2]),
                                 align_corners=self.align_corners)
        fused = F.relu(self.low_conv(low_up) + self.high_conv(high))
        return fused, low_up


class ICNet(nn.Module):
    """ICNet. Input NHWC float with H, W % 32 == 0 (an H band's rows too,
    under spatial sharding). Returns (main, aux1, aux2) logits with
    `aux=True`, else main. `max_stride` is its deepest map's stride (the
    1/2 input, the stem, the max pool, stage 2 and sub2's 1/2 reach
    1/32), for the spatial guards (`parallel.shard_batch(spatial=True,
    max_stride=...)`).

    On an H band the forward reads h from the band, so `h // 2`, `h // 4`
    and (h, w) are the band's rows of the global sizes: the guards make
    every band a multiple of 32 rows starting on a multiple of 32, so
    each of those sizes is the band's exact share of the global one, and
    the ×1/2 resizes (no halo), the ×2 and ×4 upsamples (one halo row)
    and the stride-2 convs all stay on the global grid."""

    max_stride = 32

    def __init__(self, num_classes: int = 19, *, depth: int = 50,
                 aux: bool = True, align_corners: bool = False,
                 upsample_logits: bool = True,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.aux = aux
        self.align_corners = align_corners
        self.upsample_logits = upsample_logits
        self.sub1 = nn.ModuleList([
            ConvBNAct(3, 32, 3, stride=2, act="relu", **kw),
            ConvBNAct(32, 32, 3, stride=2, act="relu", **kw),
            ConvBNAct(32, 64, 3, stride=2, act="relu", **kw)])
        self.backbone = ResNet(depth, output_stride=8, **kw)
        c2_ch = self.backbone.stage_channels[1]
        self.ppm = PyramidPooling(self.backbone.out_channels, 256,
                                  align_corners=align_corners, **kw)
        self.cff24 = CascadeFeatureFusion(256, c2_ch, 128,
                                          align_corners=align_corners, **kw)
        self.cff12 = CascadeFeatureFusion(128, 64, 128,
                                          align_corners=align_corners, **kw)
        self.classifier = make_conv(128, num_classes, 1, use_bias=True, **kw)
        if aux:
            self.aux_cls2 = make_conv(256, num_classes, 1, use_bias=True,
                                      **kw)
            self.aux_cls1 = make_conv(128, num_classes, 1, use_bias=True,
                                      **kw)

    def _trunk_to_stage2(self, x: torch.Tensor) -> torch.Tensor:
        bb = self.backbone
        x = max_pool2d(bb.stem(x), 3, stride=2, padding=1)
        return bb.stage2(bb.stage1(x))

    def _trunk_tail(self, x: torch.Tensor) -> torch.Tensor:
        bb = self.backbone
        return self.ppm(bb.stage4(bb.stage3(x)))

    def forward(self, x: torch.Tensor):
        h, w = x.shape[1], x.shape[2]
        if h % 32 or w % 32:
            raise ValueError(f"ICNet needs H and W divisible by 32; got "
                             f"{h}x{w}")
        ac = self.align_corners
        f1 = x
        for blk in self.sub1:
            f1 = blk(f1)                                        # 1/8, 64
        f2 = self._trunk_to_stage2(resize_bilinear(
            x, (h // 2, w // 2), align_corners=ac))             # 1/16, C2
        f4 = self._trunk_tail(resize_bilinear(
            f2, (f2.shape[1] // 2, f2.shape[2] // 2),
            align_corners=ac))                                  # 1/32, 256
        fused2, low_up2 = self.cff24(f4, f2)                    # 1/16, 128
        fused1, low_up1 = self.cff12(fused2, f1)                # 1/8, 128
        y = self.classifier(resize_bilinear(fused1, (h // 4, w // 4),
                                            align_corners=ac))
        if self.upsample_logits:
            y = resize_bilinear(y, (h, w), align_corners=ac)
        if self.aux:
            return y, self.aux_cls1(low_up1), self.aux_cls2(low_up2)
        return y


def icnet(num_classes: int = 19, *, depth: int = 50, aux: bool = True,
          upsample_logits: bool = True,
          compute_dtype: torch.dtype | None = None, seed: int = 0,
          device: str | torch.device | None = None) -> ICNet:
    """Build ICNet on a ResNet-`depth` with float32 parameters drawn from
    `torch.Generator().manual_seed(seed)`, on `device` (the card unless
    the caller passes "cpu")."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = ICNet(num_classes, depth=depth, aux=aux,
                  upsample_logits=upsample_logits,
                  compute_dtype=compute_dtype, generator=gen)
    return model.to(dev)
