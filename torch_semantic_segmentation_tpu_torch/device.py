"""Where the port's entry points run: on the card, unless the caller asks
for the CPU. There is no silent CPU path."""

from __future__ import annotations

import torch

from torch_semantic_segmentation_tpu_torch.parallel import distributed


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the CUDA card, and raises when there is none. Under a
    process group (`parallel.distributed.initialize`) it means the rank's
    own device, `cuda:LOCAL_RANK` on the card."""
    if device is None:
        if distributed.device() is not None:
            return distributed.device()
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)
