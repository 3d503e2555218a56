"""Dropout: the identity in eval mode; in training mode an inverted-dropout
mask drawn from an explicit `torch.Generator`.

The JAX package draws its mask with threefry or the TPU's hardware RNG, so
the two never give the same mask; tests compare eval mode."""

from __future__ import annotations

import torch
from torch import nn


class Dropout(nn.Module):
    def __init__(self, rate: float, *, generator: torch.Generator | None = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))
