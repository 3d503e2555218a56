"""ResNet backbones with dilated final stages (output stride 8, 16 or 32),
in PyTorch, with the JAX package's module names and attribute paths
(torchvision's structure: a 7×7/s2 stem → 3×3/s2 max pool → four stages).

Stages whose stride the output stride drops are dilated instead (DeepLabV3
§4.1); the final stage, when dilated, applies the multi-grid (1, 2, 4) to
its blocks. Every conv is a `ConvBNAct`, so `ops.fold` folds them all for
serving.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.ops import ConvBNAct, max_pool2d


class BasicBlock(nn.Module):
    """ResNet-18/34 block: 3×3 → 3×3, identity or projection shortcut."""

    expansion = 1

    def __init__(self, in_ch: int, ch: int, *, stride: int = 1,
                 dilation: int = 1, compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv1 = ConvBNAct(in_ch, ch, 3, stride=stride, dilation=dilation,
                               act="relu", **kw)
        self.conv2 = ConvBNAct(ch, ch, 3, dilation=dilation, act=None, **kw)
        self.down = (ConvBNAct(in_ch, ch, 1, stride=stride, act=None, **kw)
                     if stride != 1 or in_ch != ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        skip = self.down(x) if self.down is not None else x
        return F.relu(y + skip)


class BottleneckBlock(nn.Module):
    """ResNet-50+ block: 1×1 reduce → 3×3 → 1×1 expand (×4)."""

    expansion = 4

    def __init__(self, in_ch: int, ch: int, *, stride: int = 1,
                 dilation: int = 1, compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        out_ch = ch * self.expansion
        self.conv1 = ConvBNAct(in_ch, ch, 1, act="relu", **kw)
        self.conv2 = ConvBNAct(ch, ch, 3, stride=stride, dilation=dilation,
                               act="relu", **kw)
        self.conv3 = ConvBNAct(ch, out_ch, 1, act=None, **kw)
        self.down = (ConvBNAct(in_ch, out_ch, 1, stride=stride, act=None, **kw)
                     if stride != 1 or in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        skip = self.down(x) if self.down is not None else x
        return F.relu(y + skip)


_LAYOUTS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (BottleneckBlock, (3, 4, 6, 3)),
    101: (BottleneckBlock, (3, 4, 23, 3)),
}

# (stage strides, stage dilations) for each output stride
_DILATION_PLANS = {8: ((1, 2, 1, 1), (1, 1, 2, 4)),
                   16: ((1, 2, 2, 1), (1, 1, 1, 2)),
                   32: ((1, 2, 2, 2), (1, 1, 1, 1))}


class ResNet(nn.Module):
    """Dilated ResNet feature extractor: returns the four stage outputs
    (c1, c2, c3, c4). Their channel counts are `stage_channels`."""

    def __init__(self, depth: int = 50, in_ch: int = 3, *,
                 output_stride: int = 16, multi_grid=(1, 2, 4),
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if depth not in _LAYOUTS:
            raise ValueError(f"depth must be one of {sorted(_LAYOUTS)}")
        if output_stride not in _DILATION_PLANS:
            raise ValueError("output_stride must be 8, 16 or 32")
        block, counts = _LAYOUTS[depth]
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.stem = ConvBNAct(in_ch, 64, 7, stride=2, padding=3, act="relu",
                              **kw)
        strides, dils = _DILATION_PLANS[output_stride]
        chans = (64, 128, 256, 512)
        in_c = 64
        stages = []
        for si, (ch, n, st, dl) in enumerate(zip(chans, counts, strides, dils)):
            blocks = []
            for bi in range(n):
                mg = (multi_grid[min(bi, len(multi_grid) - 1)]
                      if si == 3 and dl > 1 else 1)
                blocks.append(block(in_c, ch, stride=st if bi == 0 else 1,
                                    dilation=dl * mg, **kw))
                in_c = ch * block.expansion
            stages.append(nn.Sequential(*blocks))
        self.stage1, self.stage2, self.stage3, self.stage4 = stages
        self.out_channels = in_c
        self.stage_channels = tuple(c * block.expansion for c in chans)
        self.c3_channels = self.stage_channels[2]

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        x = max_pool2d(self.stem(x), 3, stride=2, padding=1)
        feats = []
        for stage in (self.stage1, self.stage2, self.stage3, self.stage4):
            x = stage(x)
            feats.append(x)
        return tuple(feats)


def resnet(depth: int = 50, *, seed: int = 0,
           device: str | torch.device | None = None, **kwargs) -> ResNet:
    """The JAX package's `models.resnet.resnet(depth)`: a dilated ResNet
    feature extractor (`ResNet`'s keywords: `in_ch`, `output_stride`,
    `multi_grid`, `compute_dtype`) with float32 parameters drawn from
    `torch.Generator().manual_seed(seed)`, on `device` (the card unless
    the caller passes "cpu")."""
    dev = resolve_device(device)
    model = ResNet(depth, generator=torch.Generator().manual_seed(seed),
                   **kwargs)
    return model.to(dev)
