"""LEDNet (Wang et al. 2019) in PyTorch, with the JAX package's module
names and attribute paths so that its weights map one to one.

- SSnbt (split-shuffle non-bottleneck): the channels split in halves;
  the left half runs 3×1 → 1×3 pairs, the right half 1×3 → 3×1 pairs (the
  second pair dilated); concatenated → dropout → residual → ReLU →
  channel shuffle;
- APN (attention pyramid network): a 3×3 / 5×5 / 7×7 stride-2 pyramid
  whose 1×1 projections, added coarse to fine through bilinear resizes,
  make a per-pixel attention map that scales the 1×1-projected features;
  plus a global-pool branch, broadcast;
- ERFNet's downsamplers, to 1/8 and 128 channels.

Returns full-resolution logits, or the APN's 1/8 logits with
`upsample_logits=False` (for the loss that fuses the ×8 resize). Dropout
masks come from the model's `dropout_generator`. Input and output are
NHWC, as in the JAX package, whose packed TPU body is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.models.erfnet import (
    DownsamplerBlock)
from torch_semantic_segmentation_tpu_torch.ops import (
    ConvBNAct, global_avg_pool, make_conv, make_norm, resize_bilinear)
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout
from torch_semantic_segmentation_tpu_torch.parallel import distributed


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """ShuffleNet's channel shuffle on NHWC `x`: the groups-major
    interleave (channel g·(C/groups) + i goes to i·groups + g)."""
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(3, 4).reshape(
        n, h, w, c)


class SSnbt(nn.Module):
    """Split-shuffle non-bottleneck block (LEDNet §3.1)."""

    def __init__(self, ch: int, *, dilation: int = 1, dropout: float = 0.03,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None):
        super().__init__()
        half = ch // 2
        d = dilation
        kw = dict(use_bias=True, compute_dtype=compute_dtype,
                  generator=generator)

        def branch():
            return nn.ModuleList([
                make_conv(half, half, (3, 1), padding=(1, 0), **kw),
                make_conv(half, half, (1, 3), padding=(0, 1), **kw),
                make_conv(half, half, (3, 1), padding=(d, 0),
                          dilation=(d, 1), **kw),
                make_conv(half, half, (1, 3), padding=(0, d),
                          dilation=(1, d), **kw)])

        self.left = branch()
        self.right = branch()
        self.bn_left1 = make_norm(half, compute_dtype=compute_dtype)
        self.bn_left2 = make_norm(half, compute_dtype=compute_dtype)
        self.bn_right1 = make_norm(half, compute_dtype=compute_dtype)
        self.bn_right2 = make_norm(half, compute_dtype=compute_dtype)
        self.dropout = Dropout(dropout, generator=dropout_generator)

    @staticmethod
    def _run(branch, bn1, bn2, x, *, transposed: bool) -> torch.Tensor:
        c1, c2, c3, c4 = branch
        # the right branch runs each 1×3 before its 3×1 (the paper's fig. 2)
        order = (c2, c1, c4, c3) if transposed else (c1, c2, c3, c4)
        y = F.relu(order[0](x))
        y = F.relu(bn1(order[1](y)))
        y = F.relu(order[2](y))
        return bn2(order[3](y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = x.shape[-1] // 2
        yl = self._run(self.left, self.bn_left1, self.bn_left2, x[..., :half],
                       transposed=False)
        yr = self._run(self.right, self.bn_right1, self.bn_right2,
                       x[..., half:], transposed=True)
        y = self.dropout(torch.cat([yl, yr], dim=-1))
        return channel_shuffle(F.relu(y + x), 2)


class APN(nn.Module):
    """Attention pyramid network, LEDNet's decoder head (§3.2):
    `main(x) · a + pool_proj(global_avg_pool(x))`, where `a` adds the
    pyramid levels' projections coarse to fine."""

    def __init__(self, in_ch: int, num_classes: int, *,
                 align_corners: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.align_corners = align_corners
        self.down1 = ConvBNAct(in_ch, in_ch, 3, stride=2, act="relu", **kw)
        self.down2 = ConvBNAct(in_ch, in_ch, 5, stride=2, padding=2,
                               act="relu", **kw)
        self.down3 = ConvBNAct(in_ch, in_ch, 7, stride=2, padding=3,
                               act="relu", **kw)
        self.level1 = ConvBNAct(in_ch, num_classes, 1, act=None, **kw)
        self.level2 = ConvBNAct(in_ch, num_classes, 1, act=None, **kw)
        self.level3 = ConvBNAct(in_ch, num_classes, 1, act=None, **kw)
        self.main = ConvBNAct(in_ch, num_classes, 1, act=None, **kw)
        self.pool_proj = ConvBNAct(in_ch, num_classes, 1, act=None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ac = self.align_corners
        d1 = self.down1(x)
        d2 = self.down2(d1)
        d3 = self.down3(d2)
        a = resize_bilinear(self.level3(d3), tuple(d2.shape[1:3]),
                            align_corners=ac)
        a = resize_bilinear(a + self.level2(d2), tuple(d1.shape[1:3]),
                            align_corners=ac)
        a = resize_bilinear(a + self.level1(d1), tuple(x.shape[1:3]),
                            align_corners=ac)
        y = self.main(x) * a
        pooled = global_avg_pool(x)
        with distributed.replicated():
            return y + self.pool_proj(pooled)


class LEDNet(nn.Module):
    """LEDNet. Input NHWC float with H, W % 16 == 0 (the APN pyramid needs
    an even 1/8 grid).

    Returns logits (N, H, W, num_classes), or at 1/8 resolution with
    `upsample_logits=False`. `generator` draws the initial weights;
    `dropout_generator`, on the device the model runs on, draws every
    train-mode dropout mask. `max_stride` is its deepest map's stride, for
    the spatial guards (`parallel.shard_batch(spatial=True,
    max_stride=...)`): the APN's three stride-2 convs take the encoder's
    1/8 map to 1/64. On an H band the forward checks the band's rows,
    and `h % 16` is right there: the guards make every band a multiple of
    64 rows starting on a multiple of 64, so every stage of the band lies
    on the global grid."""

    max_stride = 64

    def __init__(self, num_classes: int = 19, in_ch: int = 3, *,
                 align_corners: bool = False, upsample_logits: bool = True,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        bk = dict(dropout_generator=dropout_generator, **kw)
        self.dropout_generator = dropout_generator
        self.align_corners = align_corners
        self.upsample_logits = upsample_logits
        self.encoder = nn.ModuleList(
            [DownsamplerBlock(in_ch, 32, **kw)]
            + [SSnbt(32, **bk) for _ in range(3)]
            + [DownsamplerBlock(32, 64, **kw)]
            + [SSnbt(64, **bk) for _ in range(2)]
            + [DownsamplerBlock(64, 128, **kw)]
            + [SSnbt(128, dilation=d, dropout=0.3, **bk)
               for d in (1, 2, 5, 9, 2, 5, 9, 17)])
        self.apn = APN(128, num_classes, align_corners=align_corners, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        if h % 16 or w % 16:
            raise ValueError(
                f"LEDNet needs H and W divisible by 16; got {h}x{w}")
        for blk in self.encoder:
            x = blk(x)
        y = self.apn(x)
        if self.upsample_logits:
            return resize_bilinear(y, (h, w), align_corners=self.align_corners)
        return y


def lednet(num_classes: int = 19, *, upsample_logits: bool = True,
           compute_dtype: torch.dtype | None = None, seed: int = 0,
           device: str | torch.device | None = None) -> LEDNet:
    """Build LEDNet with float32 parameters drawn from
    `torch.Generator().manual_seed(seed)`, on `device` (the card unless
    the caller passes "cpu"). Its dropout masks come from a generator on
    that device, seeded with `seed` (`model.dropout_generator`)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    drop_gen = torch.Generator(device=dev).manual_seed(seed)
    model = LEDNet(num_classes, upsample_logits=upsample_logits,
                   compute_dtype=compute_dtype, generator=gen,
                   dropout_generator=drop_gen)
    return model.to(dev)
