"""ERFNet (Romera et al. 2017) in PyTorch, with the JAX package's module
names and attribute paths so that its weights map one to one.

- DownsamplerBlock: a 3×3/s2 conv (out − in channels) beside a 2×2 max
  pool of the input, concatenated → BN → ReLU;
- NonBottleneck1d: factorised 3×1/1×3 pairs (the second pair dilated),
  dropout and the residual;
- UpsamplerBlock: a 3×3/s2 transposed conv → BN → ReLU;
- encoder to 1/8 (128 channels), decoder back to 1/2, and a 2×2/s2
  transposed conv to full-resolution logits.

ESNet and LEDNet take their down- and upsamplers from here. Dropout masks
come from the model's `dropout_generator`. Input and output are NHWC, as
in the JAX package, whose packed TPU body and head are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.ops import (
    ConvTranspose2d, make_conv, make_norm, max_pool2d)
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout


class DownsamplerBlock(nn.Module):
    """3×3/s2 conv with bias (out_ch − in_ch channels) concat 2×2 max pool
    → BN → ReLU."""

    def __init__(self, in_ch: int, out_ch: int, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = make_conv(in_ch, out_ch - in_ch, 3, stride=2, padding=1,
                              use_bias=True, compute_dtype=compute_dtype,
                              generator=generator)
        self.bn = make_norm(out_ch, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.conv(x), max_pool2d(x, 2)], dim=-1)
        return F.relu(self.bn(y))


class NonBottleneck1d(nn.Module):
    """3×1 → 1×3 → BN ReLU → 3×1 → 1×3 dilated → BN → dropout, + residual →
    ReLU."""

    def __init__(self, ch: int, *, dilation: int = 1, dropout: float = 0.3,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(use_bias=True, compute_dtype=compute_dtype,
                  generator=generator)
        d = dilation
        self.conv3x1_1 = make_conv(ch, ch, (3, 1), padding=(1, 0), **kw)
        self.conv1x3_1 = make_conv(ch, ch, (1, 3), padding=(0, 1), **kw)
        self.bn1 = make_norm(ch, compute_dtype=compute_dtype)
        self.conv3x1_2 = make_conv(ch, ch, (3, 1), padding=(d, 0),
                                   dilation=(d, 1), **kw)
        self.conv1x3_2 = make_conv(ch, ch, (1, 3), padding=(0, d),
                                   dilation=(1, d), **kw)
        self.bn2 = make_norm(ch, compute_dtype=compute_dtype)
        self.dropout = Dropout(dropout, generator=dropout_generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.conv3x1_1(x))
        y = F.relu(self.bn1(self.conv1x3_1(y)))
        y = F.relu(self.conv3x1_2(y))
        y = self.dropout(self.bn2(self.conv1x3_2(y)))
        return F.relu(y + x)


class UpsamplerBlock(nn.Module):
    """3×3/s2 transposed conv (padding 1, output padding 1) → BN → ReLU."""

    def __init__(self, in_ch: int, out_ch: int, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = ConvTranspose2d(in_ch, out_ch, 3, stride=2, padding=1,
                                    output_padding=1, use_bias=True,
                                    compute_dtype=compute_dtype,
                                    generator=generator)
        self.bn = make_norm(out_ch, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class ERFNet(nn.Module):
    """ERFNet. Input NHWC float with H, W % 8 == 0 (an H band's rows too,
    under spatial sharding); returns full-resolution logits (N, H, W,
    num_classes). `generator` draws the initial weights;
    `dropout_generator`, on the device the model runs on, draws every
    train-mode dropout mask. `max_stride` is its deepest map's stride,
    for the spatial guards (`parallel.shard_batch(spatial=True,
    max_stride=...)`)."""

    max_stride = 8

    def __init__(self, num_classes: int = 19, in_ch: int = 3, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        bk = dict(dropout_generator=dropout_generator, **kw)
        self.dropout_generator = dropout_generator
        enc: list[nn.Module] = [DownsamplerBlock(in_ch, 16, **kw),
                                DownsamplerBlock(16, 64, **kw)]
        enc += [NonBottleneck1d(64, dropout=0.03, **bk) for _ in range(5)]
        enc.append(DownsamplerBlock(64, 128, **kw))
        for _ in range(2):
            enc += [NonBottleneck1d(128, dilation=d, dropout=0.3, **bk)
                    for d in (2, 4, 8, 16)]
        self.encoder = nn.ModuleList(enc)
        self.decoder = nn.ModuleList([
            UpsamplerBlock(128, 64, **kw),
            NonBottleneck1d(64, dropout=0.0, **bk),
            NonBottleneck1d(64, dropout=0.0, **bk),
            UpsamplerBlock(64, 16, **kw),
            NonBottleneck1d(16, dropout=0.0, **bk),
            NonBottleneck1d(16, dropout=0.0, **bk)])
        self.output_conv = ConvTranspose2d(16, num_classes, 2, stride=2,
                                           use_bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        if h % 8 or w % 8:
            raise ValueError(f"ERFNet needs H and W divisible by 8; got {h}x{w}")
        for blk in (*self.encoder, *self.decoder):
            x = blk(x)
        return self.output_conv(x)


def erfnet(num_classes: int = 19, *, compute_dtype: torch.dtype | None = None,
           seed: int = 0, device: str | torch.device | None = None) -> ERFNet:
    """Build ERFNet with float32 parameters drawn from
    `torch.Generator().manual_seed(seed)`, on `device` (the card unless
    the caller passes "cpu"). Its dropout masks come from a generator on
    that device, seeded with `seed` (`model.dropout_generator`)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    drop_gen = torch.Generator(device=dev).manual_seed(seed)
    model = ERFNet(num_classes, compute_dtype=compute_dtype, generator=gen,
                   dropout_generator=drop_gen)
    return model.to(dev)
