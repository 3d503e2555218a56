"""ContextNet (Poudel et al. 2018) in PyTorch, with the JAX package's
module names and attribute paths so that its weights map one to one.
FastSCNN's predecessor: the same separable detail stem and feature fusion,
but the context comes from a MobileNetV2-style trunk run on a ×1/4 input.

- DetailBranch: conv s2 → separable convs s2, s2, s1 (1/8, 128 channels);
- ContextBranch on the bilinearly ×1/4-resized input: conv s2 → six
  inverted-residual stages → 3×3 tail (1/32, 128 channels);
- FastSCNN's FeatureFusion (×4 upsample of the context) and Classifier.

Returns full-resolution logits, or the classifier's 1/8 logits with
`upsample_logits=False` (for the loss that fuses the ×8 resize); with
`aux=True`, also an aux head's logits on each branch. Input and output
are NHWC, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.models.fastscnn import (
    Classifier, FeatureFusion)
from torch_semantic_segmentation_tpu_torch.ops import (
    ConvBNAct, InvertedResidual, SegHead, SeparableConv, resize_bilinear)


class DetailBranch(nn.Module):
    """Full-resolution branch: conv s2 → 3 separable convs → 1/8, 128
    channels."""

    def __init__(self, in_ch: int = 3, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv = ConvBNAct(in_ch, 32, 3, stride=2, act="relu", **kw)
        self.ds1 = SeparableConv(32, 64, 3, stride=2, **kw)
        self.ds2 = SeparableConv(64, 128, 3, stride=2, **kw)
        self.ds3 = SeparableConv(128, 128, 3, stride=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ds3(self.ds2(self.ds1(self.conv(x))))


class ContextBranch(nn.Module):
    """Deep branch on the ×1/4 input (Poudel 2018, table 1): conv s2, then
    inverted residuals (cout, n, stride, t) = (32, 1, 1, 1), (32, 1, 1, 6),
    (48, 3, 2, 6), (64, 3, 2, 6), (96, 2, 1, 6), (128, 2, 1, 6), then a
    3×3 conv."""

    def __init__(self, in_ch: int = 3, out_ch: int = 128, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv = ConvBNAct(in_ch, 32, 3, stride=2, act="relu", **kw)
        body: list[nn.Module] = []
        cin = 32
        for cout, n, stride, t in ((32, 1, 1, 1), (32, 1, 1, 6),
                                   (48, 3, 2, 6), (64, 3, 2, 6),
                                   (96, 2, 1, 6), (128, 2, 1, 6)):
            for i in range(n):
                body.append(InvertedResidual(
                    cin, cout, stride=stride if i == 0 else 1,
                    expand_ratio=t, **kw))
                cin = cout
        self.body = nn.ModuleList(body)
        self.tail = ConvBNAct(128, out_ch, 3, act="relu", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        for blk in self.body:
            x = blk(x)
        return self.tail(x)


class ContextNet(nn.Module):
    """ContextNet. Input NHWC float with H, W % 32 == 0.

    Returns logits (N, H, W, num_classes), or at 1/8 resolution with
    `upsample_logits=False`; with `aux=True`, (main, aux_detail,
    aux_context). `generator` draws the initial weights;
    `dropout_generator`, on the device the model runs on, draws every
    train-mode dropout mask."""

    def __init__(self, num_classes: int = 19, *, aux: bool = False,
                 align_corners: bool = False, upsample_logits: bool = True,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.dropout_generator = dropout_generator
        self.aux = aux
        self.align_corners = align_corners
        self.upsample_logits = upsample_logits
        self.detail = DetailBranch(3, **kw)
        self.context = ContextBranch(3, 128, **kw)
        self.ffm = FeatureFusion(128, 128, 128, align_corners=align_corners,
                                 **kw)
        self.classifier = Classifier(128, num_classes,
                                     dropout_generator=dropout_generator, **kw)
        if aux:
            self.aux_detail = SegHead(128, 32, num_classes,
                                      dropout_generator=dropout_generator,
                                      **kw)
            self.aux_context = SegHead(128, 32, num_classes,
                                       dropout_generator=dropout_generator,
                                       **kw)

    def forward(self, x: torch.Tensor):
        h, w = x.shape[1], x.shape[2]
        if h % 32 or w % 32:
            raise ValueError(
                f"ContextNet needs H and W divisible by 32; got {h}x{w}")
        ac = self.align_corners
        detail = self.detail(x)                                  # 1/8
        context = self.context(resize_bilinear(x, (h // 4, w // 4),
                                               align_corners=ac))  # 1/32
        y = self.classifier(self.ffm(detail, context))           # 1/8
        if self.upsample_logits:
            y = resize_bilinear(y, (h, w), align_corners=ac)
        if self.aux:
            return y, self.aux_detail(detail), self.aux_context(context)
        return y


def contextnet(num_classes: int = 19, *, aux: bool = False,
               upsample_logits: bool = True,
               compute_dtype: torch.dtype | None = None, seed: int = 0,
               device: str | torch.device | None = None) -> ContextNet:
    """Build ContextNet with float32 parameters drawn from
    `torch.Generator().manual_seed(seed)`, on `device` (the card unless
    the caller passes "cpu"). Its dropout masks come from a generator on
    that device, seeded with `seed` (`model.dropout_generator`)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    drop_gen = torch.Generator(device=dev).manual_seed(seed)
    model = ContextNet(num_classes, aux=aux, upsample_logits=upsample_logits,
                       compute_dtype=compute_dtype, generator=gen,
                       dropout_generator=drop_gen)
    return model.to(dev)
