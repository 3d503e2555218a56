"""BiSeNet (Yu et al. 2018) in PyTorch, with the JAX package's module names
and attribute paths so that its weights map one to one.

- spatial path: three stride-2 conv-BN-ReLUs (7×7, 3×3, 3×3) and a 1×1
  (1/8, 128 channels);
- context path: a ResNet-18/34 at output stride 32; its global mean
  through a 1×1 conv; attention refinement (ARM: a 3×3 conv gated by a
  sigmoid of its global mean through a 1×1 conv and BN) on the 1/32 and
  1/16 features, each refined after a ×2 upsample (1/16 and 1/8);
- feature fusion (FFM): concat both paths → 1×1 conv → squeeze-excite
  gate, scale and add;
- the main head on the fused 1/8 features, aux heads on the context
  path's 1/8 and 1/16 features.

With `aux=True` the model returns (main, aux16, aux32) in training and in
eval mode; with `upsample_logits=False` the heads stay at 1/8, 1/8 and
1/16, for `losses.aux_weighted_loss` with a loss that upsamples inside
(the fused resize + CE kernels). Input and output are NHWC, as in the JAX
package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.models.resnet import ResNet
from torch_semantic_segmentation_tpu_torch.ops import (
    ConvBNAct, global_avg_pool, make_conv, make_norm, resize_bilinear)
from torch_semantic_segmentation_tpu_torch.parallel import distributed


class AttentionRefinement(nn.Module):
    """ARM: 3×3 conv-BN-ReLU, gated by sigmoid(BN(1×1 conv(global mean)))."""

    def __init__(self, in_ch: int, out_ch: int, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv = ConvBNAct(in_ch, out_ch, 3, act="relu", **kw)
        self.gate_conv = make_conv(out_ch, out_ch, 1, use_bias=False, **kw)
        self.gate_bn = make_norm(out_ch, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        pooled = global_avg_pool(x)
        with distributed.replicated():
            g = self.gate_bn(self.gate_conv(pooled))
        return x * torch.sigmoid(g)


class SpatialPath(nn.Module):
    def __init__(self, in_ch: int = 3, out_ch: int = 128, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv1 = ConvBNAct(in_ch, 64, 7, stride=2, padding=3, act="relu",
                               **kw)
        self.conv2 = ConvBNAct(64, 64, 3, stride=2, act="relu", **kw)
        self.conv3 = ConvBNAct(64, 64, 3, stride=2, act="relu", **kw)
        self.conv4 = ConvBNAct(64, out_ch, 1, act="relu", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv4(self.conv3(self.conv2(self.conv1(x))))


class ContextPath(nn.Module):
    """Backbone, global tail and ARMs; returns the refined 1/8 and 1/16
    features, `out_ch` each."""

    def __init__(self, depth: int = 18, out_ch: int = 128, *,
                 align_corners: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.align_corners = align_corners
        self.backbone = ResNet(depth, output_stride=32, **kw)
        _, _, c16, c32 = self.backbone.stage_channels
        self.tail = ConvBNAct(c32, out_ch, 1, act="relu", **kw)
        self.arm32 = AttentionRefinement(c32, out_ch, **kw)
        self.refine32 = ConvBNAct(out_ch, out_ch, 3, act="relu", **kw)
        self.arm16 = AttentionRefinement(c16, out_ch, **kw)
        self.refine16 = ConvBNAct(out_ch, out_ch, 3, act="relu", **kw)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        _, _, f16, f32 = self.backbone(x)
        ac = self.align_corners
        pooled = global_avg_pool(f32)
        with distributed.replicated():
            tail = self.tail(pooled)
        y32 = self.arm32(f32) + tail
        y32 = self.refine32(resize_bilinear(
            y32, (f16.shape[1], f16.shape[2]), align_corners=ac))
        y16 = self.arm16(f16) + y32
        y16 = self.refine16(resize_bilinear(
            y16, (f16.shape[1] * 2, f16.shape[2] * 2), align_corners=ac))
        return y16, y32


class FeatureFusionModule(nn.Module):
    """Concat → 1×1 conv-BN-ReLU → x + x·sigmoid(SE(global mean))."""

    def __init__(self, in_ch: int, out_ch: int, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv = ConvBNAct(in_ch, out_ch, 1, act="relu", **kw)
        self.se1 = make_conv(out_ch, out_ch // 4, 1, use_bias=True, **kw)
        self.se2 = make_conv(out_ch // 4, out_ch, 1, use_bias=True, **kw)

    def forward(self, sp: torch.Tensor, cp: torch.Tensor) -> torch.Tensor:
        x = self.conv(torch.cat([sp, cp], dim=-1))
        pooled = global_avg_pool(x)
        with distributed.replicated():
            g = torch.sigmoid(self.se2(F.relu(self.se1(pooled))))
        return x + x * g


class BiSeNetHead(nn.Module):
    """3×3 conv-BN-ReLU → 1×1 logits."""

    def __init__(self, in_ch: int, mid_ch: int, num_classes: int, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv = ConvBNAct(in_ch, mid_ch, 3, act="relu", **kw)
        self.cls = make_conv(mid_ch, num_classes, 1, use_bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cls(self.conv(x))


class BiSeNet(nn.Module):
    """BiSeNet. Input NHWC float with H, W % 32 == 0 (an H band's rows
    too, under spatial sharding). Returns (main, aux16, aux32) logits with
    `aux=True`, else main; at full resolution, or at 1/8, 1/8 and 1/16
    with `upsample_logits=False`. `max_stride` is its deepest map's
    stride (the context path's ResNet at output stride 32), for the
    spatial guards (`parallel.shard_batch(spatial=True,
    max_stride=...)`).

    On an H band the three global means (the ARMs' gates, the context
    tail, the FFM's squeeze-excite) are the whole image's: each band's
    part summed over its data row (`global_avg_pool`), the same on every
    band, whose gradient the sum sends back to every band's part; the
    gates' BNs take their moments over the global batch as any BN does."""

    max_stride = 32

    def __init__(self, num_classes: int = 19, *, depth: int = 18,
                 aux: bool = True, align_corners: bool = False,
                 upsample_logits: bool = True,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.aux = aux
        self.align_corners = align_corners
        self.upsample_logits = upsample_logits
        ch = 128
        self.spatial = SpatialPath(3, ch, **kw)
        self.context = ContextPath(depth, ch, align_corners=align_corners,
                                   **kw)
        self.ffm = FeatureFusionModule(ch * 2, ch * 2, **kw)
        self.head = BiSeNetHead(ch * 2, ch * 2, num_classes, **kw)
        if aux:
            self.aux_head16 = BiSeNetHead(ch, 64, num_classes, **kw)
            self.aux_head32 = BiSeNetHead(ch, 64, num_classes, **kw)

    def forward(self, x: torch.Tensor):
        h, w = x.shape[1], x.shape[2]
        if h % 32 or w % 32:
            raise ValueError(
                f"BiSeNet needs H and W divisible by 32; got {h}x{w}")
        sp = self.spatial(x)
        cp8, cp16 = self.context(x)
        heads = [self.head(self.ffm(sp, cp8))]
        if self.aux:
            heads += [self.aux_head16(cp8), self.aux_head32(cp16)]
        if self.upsample_logits:
            heads = [resize_bilinear(y, (h, w),
                                     align_corners=self.align_corners)
                     for y in heads]
        return tuple(heads) if self.aux else heads[0]


def bisenet(num_classes: int = 19, *, depth: int = 18, aux: bool = True,
            upsample_logits: bool = True,
            compute_dtype: torch.dtype | None = None, seed: int = 0,
            device: str | torch.device | None = None) -> BiSeNet:
    """Build BiSeNet on a ResNet-`depth` with float32 parameters drawn from
    `torch.Generator().manual_seed(seed)`, on `device` (the card unless
    the caller passes "cpu")."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = BiSeNet(num_classes, depth=depth, aux=aux,
                    upsample_logits=upsample_logits,
                    compute_dtype=compute_dtype, generator=gen)
    return model.to(dev)
