"""Where the port's entry points run: on the card, unless the caller asks
for the CPU. There is no silent CPU path."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the CUDA card, and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)
