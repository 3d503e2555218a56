"""Fast-SCNN (Poudel et al. 2019) in PyTorch, with the JAX package's module
names and attribute paths so that its weights map one to one.

- LearningToDownsample: conv s2 → 2× ds-separable conv s2          (1/8)
- GlobalFeatureExtractor: 3 inverted-residual stages (s2, s2, s1)
  + pyramid pooling                                                (1/32)
- FeatureFusion: ×4 bilinear upsample of the low-res branch → dilated
  dw conv → 1×1, plus a 1×1 of the 1/8 branch, summed → ReLU
- Classifier: 2× ds-separable conv → dropout → 1×1 logits

Input and output are NHWC, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.ops import (
    ConvBNAct,
    InvertedResidual,
    PyramidPooling,
    SegHead,
    SeparableConv,
    make_conv,
    resize_bilinear,
)
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout
from torch_semantic_segmentation_tpu_torch.ops.sepconv import fuse_conv_pair


class LearningToDownsample(nn.Module):
    """conv(3→32, s2) → dsconv(32→48, s2) → dsconv(48→64, s2)."""

    def __init__(self, in_ch: int = 3, chs=(32, 48, 64), *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        c1, c2, c3 = chs
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv = ConvBNAct(in_ch, c1, 3, stride=2, act="relu", **kw)
        self.ds1 = SeparableConv(c1, c2, 3, stride=2, **kw)
        self.ds2 = SeparableConv(c2, c3, 3, stride=2, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ds2(self.ds1(self.conv(x)))


class GlobalFeatureExtractor(nn.Module):
    """Inverted-residual stages (64, 96, 128; t=6; n=3 each; s=2, 2, 1) + PPM."""

    def __init__(self, in_ch: int = 64, chs=(64, 96, 128), out_ch: int = 128,
                 *, expand_ratio: int = 6, num_blocks=(3, 3, 3),
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)

        def stage(cin, cout, n, stride):
            blocks = [InvertedResidual(cin, cout, stride=stride,
                                       expand_ratio=expand_ratio, **kw)]
            blocks += [InvertedResidual(cout, cout, stride=1,
                                        expand_ratio=expand_ratio, **kw)
                       for _ in range(n - 1)]
            return nn.ModuleList(blocks)

        self.stage1 = stage(in_ch, chs[0], num_blocks[0], 2)
        self.stage2 = stage(chs[0], chs[1], num_blocks[1], 2)
        self.stage3 = stage(chs[1], chs[2], num_blocks[2], 1)
        self.ppm = PyramidPooling(chs[2], out_ch, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for st in (self.stage1, self.stage2, self.stage3):
            for blk in st:
                x = blk(x)
        return self.ppm(x)


class FeatureFusion(nn.Module):
    """Low-res path: bilinear ×4 → dilated depthwise 3×3 BN ReLU → 1×1 BN.
    High-res path: 1×1 BN. Sum → ReLU."""

    def __init__(self, high_ch: int = 64, low_ch: int = 128, out_ch: int = 128,
                 *, scale: int = 4, align_corners: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.scale = scale
        self.align_corners = align_corners
        self.dwconv = ConvBNAct(low_ch, out_ch, 3, dilation=scale,
                                groups=low_ch if low_ch == out_ch else 1,
                                act="relu", **kw)
        self.low_proj = ConvBNAct(out_ch, out_ch, 1, act=None, use_bias=True,
                                  **kw)
        self.high_proj = ConvBNAct(high_ch, out_ch, 1, act=None, use_bias=True,
                                   **kw)

    def forward(self, high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        h, w = high.shape[1], high.shape[2]
        low = resize_bilinear(low, (h, w), align_corners=self.align_corners)
        # folded BN: the dilated dw + 1×1 pair runs as one fused kernel
        fused = fuse_conv_pair(self.dwconv, self.low_proj, low)
        if fused is None:
            fused = self.low_proj(self.dwconv(low))
        return F.relu(fused + self.high_proj(high))


class Classifier(nn.Module):
    """dsconv ×2 → dropout → 1×1 conv logits (at 1/8 resolution). The
    train-mode dropout mask comes from `dropout_generator`."""

    def __init__(self, in_ch: int, num_classes: int, *, dropout: float = 0.1,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.ds1 = SeparableConv(in_ch, in_ch, 3, **kw)
        self.ds2 = SeparableConv(in_ch, in_ch, 3, **kw)
        self.dropout = Dropout(dropout, generator=dropout_generator)
        self.conv = make_conv(in_ch, num_classes, 1, use_bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.dropout(self.ds2(self.ds1(x))))


class FastSCNN(nn.Module):
    """Fast-SCNN. Input NHWC float with H, W % 32 == 0.

    Returns logits (N, H, W, num_classes), or at 1/8 resolution with
    `upsample_logits=False`; with `aux=True`, (main, aux_lds, aux_gfe).
    `generator` draws the initial weights; `dropout_generator`, on the
    device the model runs on, draws every train-mode dropout mask.
    """

    def __init__(self, num_classes: int = 19, in_ch: int = 3, *,
                 aux: bool = False, align_corners: bool = False,
                 upsample_logits: bool = True,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.dropout_generator = dropout_generator
        self.aux = aux
        self.align_corners = align_corners
        self.upsample_logits = upsample_logits
        self.lds = LearningToDownsample(in_ch, (32, 48, 64), **kw)
        self.gfe = GlobalFeatureExtractor(64, (64, 96, 128), 128, **kw)
        self.ffm = FeatureFusion(64, 128, 128, align_corners=align_corners,
                                 **kw)
        self.classifier = Classifier(128, num_classes,
                                     dropout_generator=dropout_generator, **kw)
        if aux:
            self.aux_lds = SegHead(64, 32, num_classes,
                                   dropout_generator=dropout_generator, **kw)
            self.aux_gfe = SegHead(128, 32, num_classes,
                                   dropout_generator=dropout_generator, **kw)

    def remat_segments(self) -> list[nn.Module]:
        """The modules a rematerialised train step checkpoints one by one
        (`train.make_train_step(remat=True)`): the LDS's three convs, each
        GFE block, the PPM, the FFM, the classifier and the aux heads."""
        g = self.gfe
        heads = [self.aux_lds, self.aux_gfe] if self.aux else []
        return [self.lds.conv, self.lds.ds1, self.lds.ds2, *g.stage1,
                *g.stage2, *g.stage3, g.ppm, self.ffm, self.classifier,
                *heads]

    def forward(self, x: torch.Tensor):
        h, w = x.shape[1], x.shape[2]
        if h % 32 or w % 32:
            raise ValueError(
                f"FastSCNN needs H and W divisible by 32 (5 stride-2 stages); "
                f"got {h}x{w}")
        hi = self.lds(x)               # 1/8
        lo = self.gfe(hi)              # 1/32
        logits = self.classifier(self.ffm(hi, lo))
        if self.upsample_logits:
            logits = resize_bilinear(logits, (h, w),
                                     align_corners=self.align_corners)
        if self.aux:
            return logits, self.aux_lds(hi), self.aux_gfe(lo)
        return logits


def fastscnn(num_classes: int = 19, *, aux: bool = False,
             upsample_logits: bool = True,
             compute_dtype: torch.dtype | None = None, seed: int = 0,
             device: str | torch.device | None = None) -> FastSCNN:
    """Build FastSCNN with float32 parameters drawn from
    `torch.Generator().manual_seed(seed)`, on `device` (the card unless
    the caller passes "cpu"). Its dropout masks come from a generator on
    that device, seeded with `seed` (`model.dropout_generator`)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    drop_gen = torch.Generator(device=dev).manual_seed(seed)
    model = FastSCNN(num_classes, aux=aux, upsample_logits=upsample_logits,
                     compute_dtype=compute_dtype, generator=gen,
                     dropout_generator=drop_gen)
    return model.to(dev)
