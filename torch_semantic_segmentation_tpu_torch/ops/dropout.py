"""Dropout: the identity in eval mode; in training mode an inverted-dropout
mask drawn from an explicit `torch.Generator`, never from torch's global
RNG.

The rate is exact (torch's semantics, as the JAX package has off the TPU):
a unit is kept where a float32 uniform is below 1 − rate, and scaled by
1 / (1 − rate). The JAX package draws its mask with threefry or the TPU's
hardware RNG, so the two never give the same mask; tests compare eval mode
or rate 0.

`broadcast_dims` draws one mask value for all positions along those axes:
(1, 2) on an NHWC tensor is spatial (channel) dropout, one value an
(n, c), as ENet's bottlenecks use it.

Under a process group the input holds the rank's rows of the global batch:
the mask is drawn at the global batch's N (one value for all N where 0 is
in `broadcast_dims`) and the rank keeps its rows, so every generator stays
in step with the single process's. Under spatial sharding the input is an
H band of those rows: the mask is drawn at the global H too (where 1 is not
in `broadcast_dims`) and the rank keeps its band, as the split cuts it
(`distributed.band_rows`)."""

from __future__ import annotations

import torch
from torch import nn

from torch_semantic_segmentation_tpu_torch.parallel import distributed


class Dropout(nn.Module):
    def __init__(self, rate: float, *, broadcast_dims: tuple[int, ...] = (),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.rate = rate
        self.broadcast_dims = tuple(broadcast_dims)
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError("train-mode dropout needs an explicit "
                               "torch.Generator (the model's constructor "
                               "makes one)")
        gd, xd = self.generator.device, x.device
        if gd.type != xd.type or (gd.index or 0) != (xd.index or 0):
            raise ValueError(f"dropout generator is on {self.generator.device}"
                             f", the input on {x.device}")
        keep = 1.0 - self.rate
        shape = [1 if d in self.broadcast_dims else s
                 for d, s in enumerate(x.shape)]
        if 0 not in self.broadcast_dims:
            shape[0] *= distributed.data_size()
        if 1 not in self.broadcast_dims:
            shape[1] = distributed.global_rows(shape[1])
        u = torch.rand(shape, generator=self.generator, device=x.device)
        if 0 not in self.broadcast_dims:
            u = distributed.shard_rows(u)
        if 1 not in self.broadcast_dims:
            u = distributed.band_rows(u, 1)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))
