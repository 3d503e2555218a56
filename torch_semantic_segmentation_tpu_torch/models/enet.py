"""ENet (Paszke et al. 2016) in PyTorch, with the JAX package's module
names and attribute paths so that its weights map one to one.

- initial block: a 3×3/s2 conv (13 channels) beside a 2×2 max pool of the
  input, concatenated → BN → PReLU (16 channels, 1/2);
- encoder: a down bottleneck and 4 regular ones (64, 1/4); a down
  bottleneck and two runs of 8 (regular, dilated, asymmetric 5×1/1×5)
  (128, 1/8);
- decoder: up bottlenecks that unpool with the encoder's max-pool
  indices, a few regular ones, and a 3×3/s2 transposed conv to
  full-resolution logits.

Every bottleneck ends in spatial dropout (one mask value an image and a
channel), drawn from the model's `dropout_generator`. Input and output are
NHWC, as in the JAX package, whose packed TPU layouts are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.ops import (
    ConvBNAct, ConvTranspose2d, make_conv, make_norm, max_pool2d)
from torch_semantic_segmentation_tpu_torch.ops.conv import PReLU
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout
from torch_semantic_segmentation_tpu_torch.ops.pool import (
    max_pool2x2_with_indices, max_unpool2x2)


class InitialBlock(nn.Module):
    """3×3/s2 conv (out_ch − in_ch channels) concat 2×2 max pool of the
    input → BN → PReLU."""

    def __init__(self, in_ch: int = 3, out_ch: int = 16, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = make_conv(in_ch, out_ch - in_ch, 3, stride=2, padding=1,
                              use_bias=False, compute_dtype=compute_dtype,
                              generator=generator)
        self.bn = make_norm(out_ch, compute_dtype=compute_dtype)
        self.act = PReLU(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.conv(x), max_pool2d(x, 2)], dim=-1)
        return self.act(self.bn(y))


class Bottleneck(nn.Module):
    """ENet bottleneck, `kind` one of regular, dilated, asymmetric, down
    and up. Main branch: 1×1 projection (a 2×2/s2 conv for down) → the
    middle conv → 1×1 expansion → spatial dropout. Skip: the input; for
    down its 2×2 max pool, zero-padded in channels, whose indices the
    block returns too; for up a 1×1 conv, unpooled with the encoder's
    indices. Sum → PReLU."""

    def __init__(self, in_ch: int, out_ch: int, *, kind: str = "regular",
                 dilation: int = 1, dropout: float = 0.1,
                 projection_ratio: int = 4,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.kind = kind
        self.in_ch, self.out_ch = in_ch, out_ch
        mid = in_ch // projection_ratio
        if kind == "down":
            self.proj = ConvBNAct(in_ch, mid, 2, stride=2, padding=0,
                                  prelu=True, **kw)
        else:
            self.proj = ConvBNAct(in_ch, mid, 1, prelu=True, **kw)
        if kind == "asymmetric":
            self.mid_a = ConvBNAct(mid, mid, (5, 1), padding=(2, 0),
                                   prelu=True, **kw)
            self.mid_b = ConvBNAct(mid, mid, (1, 5), padding=(0, 2),
                                   prelu=True, **kw)
        elif kind == "up":
            self.mid_deconv = ConvTranspose2d(mid, mid, 3, stride=2,
                                              padding=1, output_padding=1,
                                              use_bias=False, **kw)
            self.mid_bn = make_norm(mid, compute_dtype=compute_dtype)
            self.mid_act = PReLU(mid)
        else:
            self.mid = ConvBNAct(mid, mid, 3, dilation=dilation, prelu=True,
                                 **kw)
        self.expand = ConvBNAct(mid, out_ch, 1, act=None, **kw)
        self.dropout = Dropout(dropout, broadcast_dims=(1, 2),
                               generator=dropout_generator)
        if kind == "up":
            self.skip_conv = ConvBNAct(in_ch, out_ch, 1, act=None, **kw)
        self.out_act = PReLU(out_ch)

    def forward(self, x: torch.Tensor, indices: torch.Tensor | None = None):
        y = self.proj(x)
        if self.kind == "asymmetric":
            y = self.mid_b(self.mid_a(y))
        elif self.kind == "up":
            y = self.mid_act(self.mid_bn(self.mid_deconv(y)))
        else:
            y = self.mid(y)
        y = self.dropout(self.expand(y))
        if self.kind == "down":
            skip, idx = max_pool2x2_with_indices(x)
            if self.out_ch > self.in_ch:
                skip = F.pad(skip, (0, self.out_ch - self.in_ch))
            return self.out_act(y + skip), idx
        if self.kind == "up":
            if indices is None:
                raise ValueError("an up bottleneck needs the encoder's "
                                 "max-pool indices")
            return self.out_act(y + max_unpool2x2(self.skip_conv(x), indices))
        return self.out_act(y + x)


class ENet(nn.Module):
    """ENet. Input NHWC float with H, W % 8 == 0 (an H band's rows too,
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
        self.initial = InitialBlock(in_ch, 16, **kw)
        # stage 1: 16 -> 64, a down bottleneck and 4 regular ones, p = 0.01
        self.down1 = Bottleneck(16, 64, kind="down", dropout=0.01, **bk)
        self.stage1 = nn.ModuleList([
            Bottleneck(64, 64, kind="regular", dropout=0.01, **bk)
            for _ in range(4)])
        # stage 2: 64 -> 128, a down bottleneck and the 8-block run, p = 0.1
        self.down2 = Bottleneck(64, 128, kind="down", dropout=0.1, **bk)

        def run():
            return nn.ModuleList([
                Bottleneck(128, 128, kind="regular", dropout=0.1, **bk),
                Bottleneck(128, 128, kind="dilated", dilation=2, dropout=0.1,
                           **bk),
                Bottleneck(128, 128, kind="asymmetric", dropout=0.1, **bk),
                Bottleneck(128, 128, kind="dilated", dilation=4, dropout=0.1,
                           **bk),
                Bottleneck(128, 128, kind="regular", dropout=0.1, **bk),
                Bottleneck(128, 128, kind="dilated", dilation=8, dropout=0.1,
                           **bk),
                Bottleneck(128, 128, kind="asymmetric", dropout=0.1, **bk),
                Bottleneck(128, 128, kind="dilated", dilation=16,
                           dropout=0.1, **bk)])

        self.stage2 = run()
        self.stage3 = run()    # the same run, no downsampling
        self.up4 = Bottleneck(128, 64, kind="up", dropout=0.1, **bk)
        self.stage4 = nn.ModuleList([
            Bottleneck(64, 64, kind="regular", dropout=0.1, **bk)
            for _ in range(2)])
        self.up5 = Bottleneck(64, 16, kind="up", dropout=0.1, **bk)
        self.stage5 = nn.ModuleList([
            Bottleneck(16, 16, kind="regular", dropout=0.1, **bk)])
        self.fullconv = ConvTranspose2d(16, num_classes, 3, stride=2,
                                        padding=1, output_padding=1,
                                        use_bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # on an H band these are the band's rows: its pool windows and
        # stride-2 grids must be the image's, so a band needs H % 8 too
        # (`distributed.split_rows` deals bands of whole blocks of 8)
        h, w = x.shape[1], x.shape[2]
        if h % 8 or w % 8:
            raise ValueError(
                f"ENet needs H and W divisible by 8 (3 stride-2 stages with "
                f"max-unpool index forwarding); got {h}x{w}")
        x = self.initial(x)
        x, idx1 = self.down1(x)
        for blk in self.stage1:
            x = blk(x)
        x, idx2 = self.down2(x)
        for blk in (*self.stage2, *self.stage3):
            x = blk(x)
        x = self.up4(x, idx2)
        for blk in self.stage4:
            x = blk(x)
        x = self.up5(x, idx1)
        for blk in self.stage5:
            x = blk(x)
        return self.fullconv(x)


def enet(num_classes: int = 19, *, compute_dtype: torch.dtype | None = None,
         seed: int = 0, device: str | torch.device | None = None) -> ENet:
    """Build ENet with float32 parameters drawn from
    `torch.Generator().manual_seed(seed)`, on `device` (the card unless
    the caller passes "cpu"). Its dropout masks come from a generator on
    that device, seeded with `seed` (`model.dropout_generator`)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    drop_gen = torch.Generator(device=dev).manual_seed(seed)
    model = ENet(num_classes, compute_dtype=compute_dtype, generator=gen,
                 dropout_generator=drop_gen)
    return model.to(dev)
