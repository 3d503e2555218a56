"""ESNet (Wang et al. 2019) in PyTorch, with the JAX package's module
names and attribute paths so that its weights map one to one.

- FCU: (K×1 → 1×K → BN ReLU) twice, dropout and the residual, K = 3 in
  the shallow stage and 5 in the middle one;
- PFCU: a shared 3×1/1×3 stem, then three branches dilated at 2, 5 and 9,
  each through BN and dropout and summed onto the residual;
- ERFNet's down- and upsamplers, and a 2×2/s2 transposed conv to
  full-resolution logits.

Dropout masks come from the model's `dropout_generator`. Input and output
are NHWC, as in the JAX package, whose packed TPU body and head are not
ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.models.erfnet import (
    DownsamplerBlock, UpsamplerBlock)
from torch_semantic_segmentation_tpu_torch.ops import (
    ConvTranspose2d, make_conv, make_norm)
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout


class FCU(nn.Module):
    """Factorised conv unit: (K×1 → 1×K → BN ReLU) ×2, the second without
    its ReLU, → dropout, + residual → ReLU."""

    def __init__(self, ch: int, k: int = 3, *, dropout: float = 0.03,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(use_bias=True, compute_dtype=compute_dtype,
                  generator=generator)
        p = (k - 1) // 2
        self.conv_a1 = make_conv(ch, ch, (k, 1), padding=(p, 0), **kw)
        self.conv_a2 = make_conv(ch, ch, (1, k), padding=(0, p), **kw)
        self.bn1 = make_norm(ch, compute_dtype=compute_dtype)
        self.conv_b1 = make_conv(ch, ch, (k, 1), padding=(p, 0), **kw)
        self.conv_b2 = make_conv(ch, ch, (1, k), padding=(0, p), **kw)
        self.bn2 = make_norm(ch, compute_dtype=compute_dtype)
        self.dropout = Dropout(dropout, generator=dropout_generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.conv_a1(x))
        y = F.relu(self.bn1(self.conv_a2(y)))
        y = F.relu(self.conv_b1(y))
        y = self.dropout(self.bn2(self.conv_b2(y)))
        return F.relu(y + x)


class PFCU(nn.Module):
    """Parallel FCU: a shared 3×1 → 1×3 → BN ReLU stem, then per rate a
    dilated 3×1 → ReLU → 1×3 → BN → dropout branch; the branches summed
    onto the residual → ReLU."""

    def __init__(self, ch: int, *, rates=(2, 5, 9), dropout: float = 0.3,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(use_bias=True, compute_dtype=compute_dtype,
                  generator=generator)
        self.stem1 = make_conv(ch, ch, (3, 1), padding=(1, 0), **kw)
        self.stem2 = make_conv(ch, ch, (1, 3), padding=(0, 1), **kw)
        self.bn_stem = make_norm(ch, compute_dtype=compute_dtype)
        self.branch_a = nn.ModuleList([
            make_conv(ch, ch, (3, 1), padding=(r, 0), dilation=(r, 1), **kw)
            for r in rates])
        self.branch_b = nn.ModuleList([
            make_conv(ch, ch, (1, 3), padding=(0, r), dilation=(1, r), **kw)
            for r in rates])
        self.branch_bn = nn.ModuleList([
            make_norm(ch, compute_dtype=compute_dtype) for _ in rates])
        self.dropout = Dropout(dropout, generator=dropout_generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.stem1(x))
        y = F.relu(self.bn_stem(self.stem2(y)))
        out = x
        for ca, cb, bn in zip(self.branch_a, self.branch_b, self.branch_bn):
            out = out + self.dropout(bn(cb(F.relu(ca(y)))))
        return F.relu(out)


class ESNet(nn.Module):
    """ESNet. Input NHWC float with H, W % 8 == 0 (an H band's rows too,
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
        self.encoder = nn.ModuleList(
            [DownsamplerBlock(in_ch, 16, **kw)]
            + [FCU(16, 3, **bk) for _ in range(3)]
            + [DownsamplerBlock(16, 64, **kw)]
            + [FCU(64, 5, **bk) for _ in range(2)]
            + [DownsamplerBlock(64, 128, **kw)]
            + [PFCU(128, **bk) for _ in range(3)])
        self.decoder = nn.ModuleList([
            UpsamplerBlock(128, 64, **kw),
            FCU(64, 5, dropout=0.0, **bk),
            FCU(64, 5, dropout=0.0, **bk),
            UpsamplerBlock(64, 16, **kw),
            FCU(16, 3, dropout=0.0, **bk),
            FCU(16, 3, dropout=0.0, **bk)])
        self.output_conv = ConvTranspose2d(16, num_classes, 2, stride=2,
                                           use_bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        if h % 8 or w % 8:
            raise ValueError(f"ESNet needs H and W divisible by 8; got {h}x{w}")
        for blk in (*self.encoder, *self.decoder):
            x = blk(x)
        return self.output_conv(x)


def esnet(num_classes: int = 19, *, compute_dtype: torch.dtype | None = None,
          seed: int = 0, device: str | torch.device | None = None) -> ESNet:
    """Build ESNet with float32 parameters drawn from
    `torch.Generator().manual_seed(seed)`, on `device` (the card unless
    the caller passes "cpu"). Its dropout masks come from a generator on
    that device, seeded with `seed` (`model.dropout_generator`)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    drop_gen = torch.Generator(device=dev).manual_seed(seed)
    model = ESNet(num_classes, compute_dtype=compute_dtype, generator=gen,
                  dropout_generator=drop_gen)
    return model.to(dev)
